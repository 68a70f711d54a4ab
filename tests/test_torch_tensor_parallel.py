"""Tensor parallelism (the ``model`` axis) in the port, against the JAX
package's ``TP_RULES``, ``zero1_plan`` and ``Trainer`` on a ``model`` mesh
and against the port's own one-process trainer, on the CPU.

In process: the port's tensor-parallel rules and its ZeRO-1 plan under
them equal the JAX package's ``param_pspecs`` and ``zero1_plan`` leaf for
leaf (axes, padded extents) and ``zero1_state_bytes``; a rank's dropout
seeds draw one process's masks for its heads (``model_row_seeds``); a JAX
tree converted at ``model:2`` and gathered back is the tree; the mesh's
coordinates and groups; the refusals (``model`` beside ``seq``, ring
attention beside it, a model size that does not divide the heads, predict
and serve on a mesh), each naming ROADMAP; ``model`` beside ``pipe`` is
accepted (``tests/test_torch_pipe_model.py``).

One module fixture runs, at once, the port's 2-rank gloo world of
``tests/test_torch_tensor_parallel_worker.py pair`` (``model:2``), its
4-rank ``train`` world (``data:2,model:2``, ZeRO-1, both saves) and the
JAX ``Trainer`` on ``model:2`` and on ``data:2,model:2`` (ZeRO-1, dropout
0, the same weights; its loader regrouped so that its contiguous
micro-batches are the port's global ones), which then writes a sharded
checkpoint. Then the 4-rank ``resume`` world restores the JAX package's
save and the port's single file, while a JAX ``Trainer`` on
``data:2,model:2`` restores both of the port's saves. The held results:

- one attention layer at ``model:2``: each rank's context at dropout 0.1
  is one process's context of its heads bit for bit, and the layer's
  output equals the JAX layer's (its parameters placed by
  ``param_pspecs`` on a ``model:2`` mesh) to ``rtol=2e-5``;
- ``model:2`` and ``data:2,model:2`` (ZeRO-1) equal the JAX trainer on the
  same mesh: step values to ``rtol=2e-5``, end parameters to
  ``atol=5e-5`` (the JAX package's own TP pins,
  ``tests/test_dp_equivalence.py``), and ``model:2`` equals the port's one
  process; at dropout 0.1 two runs are bit-identical and the loss falls;
  ``--zero1_overlap bucketed`` is inert (0 buckets, the same parameters);
- the ``data:2,model:2`` single-file save reloads bit for bit in one
  process and in the JAX package; the sharded save peeks as the JAX one
  does (``mesh_axes``, ``shards``) and restores bit for bit in the JAX
  package at ``data:2,model:2`` and in one process; the JAX package's TP
  sharded save restores in the port.

Budget: the fixture's worlds carry a deadline each (``PAIR_DEADLINE_S``).
"""

import concurrent.futures
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ddp_worker as worker
from helpers import write_vocab
from ml_recipe_tpu.data.collate import make_collate_fun as jax_collate
from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.models.encoder import SelfAttention as JaxSelfAttention
from ml_recipe_tpu.parallel import build_mesh as jax_build_mesh
from ml_recipe_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from ml_recipe_tpu.parallel.sharding import zero1_plan as jax_zero1_plan
from ml_recipe_tpu.parallel.sharding import (
    zero1_state_bytes as jax_zero1_state_bytes,
)
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.train.checkpoint import (
    peek_checkpoint_layout as jax_peek_layout,
)
from ml_recipe_tpu_torch.config.parser import (
    check_predict_flags,
    check_serve_flags,
    check_train_flags,
    get_model_parser,
    get_params,
    get_predictor_parser,
    get_serve_parser,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.models import from_jax_params, to_jax_params
from ml_recipe_tpu_torch.ops.attention import (
    dot_product_attention,
    dropout_seed,
    global_row_seeds,
    model_row_seeds,
)
from ml_recipe_tpu_torch.parallel import regroup_for_world
from ml_recipe_tpu_torch.parallel.mesh import Mesh, elastic_axes
from ml_recipe_tpu_torch.parallel.mesh import ElasticMeshError
from ml_recipe_tpu_torch.parallel.sharding import (
    tp_param_dims,
    tp_spec,
    zero1_plan,
    zero1_state_bytes,
)
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train import checkpoint as ckpt

RTOL, PARAMS_ATOL = 2e-5, 5e-5          # against JAX (and one process)
GRAD_REL = 1e-5                         # against the port's one process
MESH = {"data": 2, "model": 2}
WORKER = Path(__file__).resolve().parent / "test_torch_tensor_parallel_worker.py"
REPO = Path(__file__).resolve().parent.parent


# -- in process ---------------------------------------------------------------

def _tiny_flax(layers=2):
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel

    cfg = dict(worker.TINY_MODEL, num_layers=layers)
    model = QAModel(EncoderConfig(vocab_size=50, **cfg))
    return to_jax_params(model.state_dict())


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: (
        hasattr(x, "spec") or isinstance(x, tuple)))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_tp_rules_and_zero1_plan_match_jax(D):
    tree = _tiny_flax()
    tree["transformer"]["layer_0"]["attention"]["odd"] = np.zeros(
        17, np.float32)
    mesh = jax_build_mesh(f"data:{D},model:2")
    jflat = jax.tree_util.tree_flatten_with_path(
        jax_param_pspecs(tree, mesh))[0]
    split = 0
    for path, want in jflat:
        got = tp_spec(tuple(p.key for p in path))
        assert (got or ()) == tuple(want), path
        split += got is not None
    assert split == 6 * 2 + 2 * 2 * 2
    state = {"mu": tree, "nu": tree}
    jplan = jax_zero1_plan(state, mesh, min_size=0)
    plan = zero1_plan(state, data_size=D, min_size=0, model_size=2)
    got = _leaves(plan)
    want = jax.tree_util.tree_leaves(jplan, is_leaf=lambda x: hasattr(x,
                                                                      "spec"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (tuple(g.spec), g.axis, g.padded) == (
            tuple(w.spec) + (None,) * (len(g.spec) - len(tuple(w.spec))),
            w.axis, w.padded)
    assert zero1_state_bytes(state, data_size=D, min_size=0) \
        == jax_zero1_state_bytes(state, data_size=D, min_size=0)


def test_tp_param_dims_map_the_rules_onto_the_torch_tensors():
    """``P(None, model)`` slices a weight's rows, ``P(model, None)`` its
    columns, a split bias its one dimension; the model at ``model:2``
    holds exactly those slices of the whole shapes."""
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel

    whole = QAModel(EncoderConfig(vocab_size=50, **worker.TINY_MODEL))
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    dims = tp_param_dims(shapes)
    layer = "transformer.layer_1."
    assert {n[len(layer):]: d for n, d in dims.items()
            if n.startswith(layer)} == {
        "attention.query.weight": 0, "attention.query.bias": 0,
        "attention.key.weight": 0, "attention.key.bias": 0,
        "attention.value.weight": 0, "attention.value.bias": 0,
        "attention.output.weight": 1, "mlp.intermediate.weight": 0,
        "mlp.intermediate.bias": 0, "mlp.output.weight": 1}
    mesh = Mesh(axes={"model": 2}, rank=1, world=2)
    tp = QAModel(EncoderConfig(vocab_size=50, **worker.TINY_MODEL),
                 mesh=mesh)
    for name, p in tp.named_parameters():
        want = list(shapes[name])
        if name in dims:
            want[dims[name]] //= 2
        assert tuple(p.shape) == tuple(want), name


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("rows", [None, (2, 6)], ids=["whole", "global"])
def test_model_row_seeds_draw_one_process_masks_for_a_ranks_heads(T, rows):
    """Rank ``r``'s heads at dropout 0.1, seeded by ``model_row_seeds``,
    give one process's context of heads ``r*H/T ..`` bit for bit (the
    plain version, with a data rank's ``global_row_seeds`` too)."""
    g = torch.Generator().manual_seed(T)
    B, L, H, D = 3, 40, 4, 32
    q, k, v = (torch.randn(B, L, H, D, generator=g) for _ in range(3))
    mask = torch.ones(B, L, dtype=torch.int32)
    mask[1, 29:] = 0
    seed = dropout_seed(torch.Generator().manual_seed(5))
    if rows is not None:
        seed = global_row_seeds(seed, rows[0], B, rows[1], H)
    whole = dot_product_attention(q, k, v, mask, dropout_rate=0.1, seed=seed,
                                  impl="xla")
    n = H // T
    for r in range(T):
        heads = slice(r * n, (r + 1) * n)
        got = dot_product_attention(
            q[:, :, heads], k[:, :, heads], v[:, :, heads], mask,
            dropout_rate=0.1, seed=model_row_seeds(seed, B, H, r, T),
            impl="xla")
        assert torch.equal(got, whole[:, :, heads]), r
        if r:   # the offset is live: rank 0's seeds draw other masks
            other = dot_product_attention(
                q[:, :, heads], k[:, :, heads], v[:, :, heads], mask,
                dropout_rate=0.1, seed=model_row_seeds(seed, B, H, 0, T),
                impl="xla")
            assert not torch.equal(other, got)


def test_from_jax_params_at_model2_gathers_back_to_the_tree():
    tree = _tiny_flax()
    parts = [from_jax_params(tree, model_index=r, model_size=2)
             for r in range(2)]
    dims = tp_param_dims(parts[0])
    whole = {n: torch.cat([parts[0][n], parts[1][n]], dim=dims[n])
             if n in dims else parts[0][n] for n in parts[0]}
    back = to_jax_params(whole)
    paths = jax.tree_util.tree_leaves_with_path
    assert len(paths(back)) == len(paths(tree))
    for (path, a), (_, b) in zip(paths(back), paths(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert parts[1]["transformer.layer_0.attention.output.weight"].shape \
        == (64, 32)


@pytest.mark.parametrize("rank", [0, 1])
def test_hf_warm_start_loads_a_ranks_slices(tmp_path, rank):
    """``--hf_checkpoint`` under ``model:2``: each rank's encoder holds its
    slices of the one-process warm start."""
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
    from ml_recipe_tpu_torch.models.hf_convert import (
        load_pretrained_into,
        synthetic_hf_state_dict,
    )

    cfg = EncoderConfig(vocab_size=50, **worker.TINY_MODEL)
    path = tmp_path / "pytorch_model.bin"
    torch.save(synthetic_hf_state_dict(cfg, seed=3), path)
    whole, tp = QAModel(cfg), QAModel(cfg, mesh=Mesh(axes={"model": 2},
                                                     rank=rank, world=2))
    load_pretrained_into(whole, str(path))
    load_pretrained_into(tp, str(path))
    want = tp.model_split().local_state(whole.state_dict())
    for name, p in tp.state_dict().items():
        if name.startswith("transformer."):
            assert torch.equal(p, want[name]), name


@pytest.mark.parametrize("axes,rank,want", [
    ({"data": 2, "model": 2}, 3, dict(data_index=1, model_index=1,
                                      model_ranks=(2, 3), data_ranks=(1, 3))),
    ({"data": 2, "model": 2}, 2, dict(data_index=1, model_index=0,
                                      model_ranks=(2, 3), data_ranks=(0, 2))),
    ({"model": 2}, 1, dict(data_index=0, model_index=1, model_ranks=(0, 1),
                           data_ranks=(1,))),
    ({"data": 4}, 3, dict(data_index=3, model_index=0, model_ranks=(3,),
                          data_ranks=(0, 1, 2, 3)))])
def test_mesh_puts_model_innermost(axes, rank, want):
    """The JAX package's axis order: ``model`` innermost, so a model
    group's ranks are neighbours and a data row strides over them."""
    from ml_recipe_tpu_torch.parallel.mesh import MeshSpec

    T = axes.get("model", 1)
    mesh = Mesh(axes=MeshSpec(axes).ordered(), rank=rank,
                world=int(np.prod(list(axes.values()))),
                model_ranks=tuple(range(rank - rank % T,
                                        rank - rank % T + T)))
    for key, value in want.items():
        assert getattr(mesh, key) == value, key


def test_elastic_shrink_keeps_the_model_axis():
    assert elastic_axes({"data": 2, "model": 2}, 2) == {"data": 1,
                                                        "model": 2}
    with pytest.raises(ElasticMeshError, match="structural"):
        elastic_axes({"data": 1, "model": 2}, 1)


def _train_flags(tmp, *extra, world=2):
    vocab = tmp / "vocab.txt"
    if not vocab.exists():
        vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]))
    return get_params((get_trainer_parser, get_model_parser), [
        "-c", str(REPO / "config" / "test_bert.cfg"), "--vocab_file",
        str(vocab), "--dump_dir", str(tmp / "results"), "--device", "cpu",
        "--model", "bert-tiny", "--dist_world_size", str(world),
        "--local_rank", "0", *extra])[1]


@pytest.mark.parametrize("mesh,world", [("model:2", 2),
                                        ("data:2,model:2", 4),
                                        ("pipe:2,model:2", 4),
                                        ("data:2,pipe:2,model:1", 4)])
def test_model_meshes_are_accepted(tmp_path, mesh, world):
    params, model_params = _train_flags(tmp_path, "--mesh", mesh,
                                        "--optimizer_sharding", "zero1",
                                        "--zero1_overlap", "bucketed",
                                        world=world)
    check_train_flags(params, model_params)


@pytest.mark.parametrize("extra", [
    ["--mesh", "seq:2,model:2"],
    ["--mesh", "model:2", "--flash_attention", "ring"],
    ["--mesh", "model:4"]],
    ids=["seq", "ring", "heads"])
def test_model_compositions_are_refused_naming_roadmap(tmp_path, extra):
    params, model_params = _train_flags(tmp_path, *extra, world=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_train_flags(params, model_params)


@pytest.mark.parametrize("which", ["predict", "serve"])
def test_inference_refuses_a_model_mesh(which):
    parsers, check = ((get_predictor_parser, check_predict_flags)
                      if which == "predict"
                      else (get_serve_parser, check_serve_flags))
    _, (params, model_params) = get_params(
        (parsers, get_model_parser), ["--mesh", "data:2,model:2"])
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.*Inference over a mesh"):
        check(params, model_params)


# -- the worlds ---------------------------------------------------------------

class _Regrouped:
    """A JAX loader whose batches are regrouped (``regroup_for_world``) so
    that the one process's contiguous micro-batches are the port's global
    micro-batches of ``world`` data ranks."""

    def __init__(self, loader, world, batch_split):
        self.loader, self.world, self.batch_split = loader, world, batch_split

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield tuple(regroup_for_world(part, self.world, self.batch_split)
                        if i < 2 else part for i, part in enumerate(batch))


def _jax_trainer(tmp, mesh_spec, steps=None, **kw):
    tmp.mkdir(parents=True, exist_ok=True)
    tok = JaxTokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    ttok = Tokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    init = to_jax_params(worker.tiny_model(len(ttok), dropout=0.0).state_dict())
    mesh = jax_build_mesh(mesh_spec)
    cfg = JaxEncoderConfig(vocab_size=len(tok), hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0,
                           **worker.TINY_MODEL)
    tp, weights = worker.trainer_params(), worker.train_weights()
    trainer = JaxTrainer(
        model=JaxQAModel(cfg, mesh=mesh, ln_impl="fused"),
        params=init, loss=jax_build_loss(tp, weights),
        collate_fun=jax_collate(tok, max_seq_len=worker.MAX_SEQ_LEN),
        trainer_params=tp,
        train_dataset=worker.VariedDataset(tok, worker.N_TRAIN, seed=1,
                                           item=JaxItem),
        mesh=mesh, train_batch_size=worker.TRAIN_BATCH,
        batch_split=worker.BATCH_SPLIT, n_jobs=1, warmup_coef=0.0,
        max_grad_norm=worker.MAX_GRAD_NORM, train_weights=weights,
        debug=True, seed=0, hbm_preflight=False,
        on_train_metrics=None if steps is None else (
            lambda meters, step: steps.append(
                {k: float(v) if k == "lr" else float(v())
                 for k, v in meters.items()})), **kw)
    return init, trainer


def _attention_case(out: Path):
    """The JAX layer's weights and inputs (``OUT/attention.pt``) and its
    output with its parameters placed by ``param_pspecs`` on ``model:2``."""
    cfg = JaxEncoderConfig(vocab_size=50, hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1,
                           **worker.TINY_MODEL)
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((3, worker.MAX_SEQ_LEN, 64)).astype(
        np.float32)
    mask = np.ones((3, worker.MAX_SEQ_LEN), np.int32)
    mask[1, 30:] = 0
    layer = JaxSelfAttention(cfg, ln_impl="fused")
    params = layer.init(jax.random.PRNGKey(0), hidden, mask,
                        deterministic=True)["params"]
    mesh = jax_build_mesh("model:2")
    specs = jax_param_pspecs({"attention": params}, mesh)["attention"]
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        params, specs)
    want = jax.jit(lambda p, h, m: layer.apply(
        {"params": p}, h, m, deterministic=True))(placed, jnp.asarray(hidden),
                                                  jnp.asarray(mask))
    params = jax.tree_util.tree_map(np.asarray, params)
    torch.save({"params": params, "hidden": torch.from_numpy(hidden),
                "mask": torch.from_numpy(mask), "seed": 11},
               out / "attention.pt")
    return np.asarray(want)


def _world(mode, out, ranks):
    return worker.run_pairs(lambda rank, port: [
        sys.executable, str(WORKER), mode, str(rank), str(ranks), str(port),
        str(out)], ranks=ranks)


def _check(results):
    for pair in results:
        for rc, err in pair:
            assert rc == 0, err[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    out = tmp / "worlds"
    out.mkdir()
    jax_attention = _attention_case(out)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        pair = pool.submit(_world, "pair", out, 2)
        train = pool.submit(_world, "train", out, 4)
        m2_steps, dm_steps = [], []
        init, jt = _jax_trainer(tmp / "jax_m2", "model:2", m2_steps)
        jt.train()
        jax_m2 = jax.tree_util.tree_map(np.asarray, jt.params)
        _, jd = _jax_trainer(tmp / "jax_dm", "data:2,model:2", dm_steps,
                             optimizer_sharding="zero1", zero_min_size=0,
                             sharded_checkpoint=True)
        jd.train_dataloader = _Regrouped(jd.train_dataloader, 2,
                                         worker.BATCH_SPLIT)
        jd.train()
        jax_dm = jax.tree_util.tree_map(np.asarray, jd.params)
        jd.debug = False
        jd.save_state_dict(out / "jax_ckpt")
        jax_step = jd.global_step
        _check(pair.result())
        _check(train.result())
        resume = pool.submit(_world, "resume", out, 4)
        _, jr = _jax_trainer(tmp / "jax_r", "data:2,model:2",
                             optimizer_sharding="zero1", zero_min_size=0)
        restored = {}
        for name in ("full.ch", "ckpt"):
            jr.load_state_dict(out / name)
            restored[name] = jax.tree_util.tree_map(np.asarray, jr.params)
        _check(resume.result())

    def load(name, ranks=4):
        return [torch.load(out / f"{name}_rank{r}.pt") for r in range(ranks)]

    return SimpleNamespace(out=out, load=load, init=init, jax_m2=jax_m2,
                           m2_steps=m2_steps, jax_dm=jax_dm,
                           dm_steps=dm_steps, jax_step=jax_step,
                           jax_restored=restored,
                           jax_attention=jax_attention)


def test_attention_context_is_one_process_for_its_heads(runs):
    """At dropout 0.1 each rank's context is one process's context of its
    heads bit for bit: the rank drew global heads ``r*H/T + j``."""
    got = [torch.load(runs.out / f"attention_rank{r}.pt") for r in range(2)]
    case = torch.load(runs.out / "attention.pt", weights_only=False)
    q, k, v = (torch.cat([g[n] for g in got], dim=2) for n in "qkv")
    seed = dropout_seed(torch.Generator().manual_seed(case["seed"]))
    whole = dot_product_attention(q, k, v, case["mask"], dropout_rate=0.1,
                                  seed=seed, impl="xla")
    for r, g in enumerate(got):
        assert g["q"].shape[2] == 1
        assert torch.equal(g["ctx"], whole[:, :, r:r + 1]), r


def test_attention_layer_matches_jax(runs):
    got = [torch.load(runs.out / f"attention_rank{r}.pt") for r in range(2)]
    assert torch.equal(got[0]["out"], got[1]["out"])
    np.testing.assert_allclose(got[0]["out"].numpy(), runs.jax_attention,
                               rtol=RTOL, atol=1e-6)


def _assert_steps(port_values, want):
    assert len(want) == len(port_values) == 2
    for step, (got, ref) in enumerate(zip(port_values, want)):
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")


def _assert_params(whole, jax_params, init):
    got = to_jax_params(whole)
    paths = jax.tree_util.tree_leaves_with_path
    moved = 0
    for (path, a), (_, b), (_, c) in zip(paths(got), paths(jax_params),
                                         paths(init)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=PARAMS_ATOL,
                                   err_msg=str(path))
        moved += not np.array_equal(b, c)
    assert moved > len(paths(got)) // 2


def test_model2_steps_equal_the_jax_tp_trainer(runs):
    port = runs.load("trained", 2)
    for rank in range(2):
        assert port[rank]["values"] == port[0]["values"]
        assert port[rank]["model_index"] == rank
    _assert_steps(port[0]["values"], runs.m2_steps)
    _assert_params(port[0]["whole"], runs.jax_m2, runs.init)
    # a rank stores its slices: one head and 64 of 128 columns a layer
    params = port[1]["params"]
    assert params["transformer.layer_0.attention.query.weight"].shape == (
        32, 64)
    assert params["transformer.layer_0.mlp.output.weight"].shape == (64, 64)
    # the eval after each epoch, the same on both ranks
    assert len(port[0]["metrics"]) == 2
    assert port[1]["metrics"] == port[0]["metrics"]
    # 2 all-reduces a layer forward, 2 backward: 4 micro-batches and the
    # eval batches (ceil(22 / 6) a pass, 2 passes) of 2 layers
    transport = port[0]["transport"]
    assert transport["backward"] == 4 * 2 * 2
    assert transport["forward"] == (4 + 2 * 4) * 2 * 2


def test_model2_equals_the_one_process_trainer(runs, tmp_path):
    port = runs.load("trained", 2)
    one = worker.oracle_whole(tmp_path, port[0], dropout=0.0)
    for got, ref in zip(port[0]["values"], one.values):
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=key)
    dims = port[0]["dims"]
    grads = {n: torch.cat([port[0]["grads"][n], port[1]["grads"][n]],
                          dim=dims[n]) if n in dims else port[0]["grads"][n]
             for n in port[0]["grads"]}
    assert worker.rel_l2(grads, one.grads) < GRAD_REL
    for name, p in one.params.items():
        np.testing.assert_allclose(port[0]["whole"][name], p,
                                   atol=PARAMS_ATOL, err_msg=name)


def test_data2_model2_zero1_equals_the_jax_tp_trainer(runs):
    port = runs.load("zero1")
    for rank in range(4):
        assert port[rank]["values"] == port[0]["values"]
        assert (port[rank]["data_index"], port[rank]["model_index"]) == (
            rank // 2, rank % 2)
    _assert_steps(port[0]["values"], runs.dm_steps)
    _assert_params(port[0]["whole"], runs.jax_dm, runs.init)
    for rank in range(4):
        for name, p in port[0]["whole"].items():
            assert torch.equal(port[rank]["whole"][name], p), name
    # ZeRO-1 under TP: a rank's moment of the query kernel is the data
    # half of its model half (JAX spec ('data', 'model') on [in, out])
    mu = port[3]["mu"]["transformer.layer_0.attention.query.weight"]
    assert mu.shape == (32, 32)


def test_dropout_runs_are_reproducible_and_the_loss_falls(runs):
    a, b = runs.load("drop_a", 2), runs.load("drop_b", 2)
    for rank in range(2):
        assert a[rank]["values"] == b[rank]["values"]
        for name, p in a[rank]["params"].items():
            assert torch.equal(b[rank]["params"][name], p), name
    losses = [v["loss"] for v in a[0]["values"]]
    assert losses[-1] < losses[0] and len(losses) == 4


def test_bucketed_zero1_is_inert_under_tp(runs):
    bucketed, zero1 = runs.load("bucketed"), runs.load("zero1")
    for rank in range(4):
        assert bucketed[rank]["buckets"] == 0
        assert bucketed[rank]["values"] == zero1[rank]["values"]
        for name, p in zero1[rank]["params"].items():
            assert torch.equal(bucketed[rank]["params"][name], p), name


def _one_process(tmp, path):
    trainer = worker.tiny_trainer(tmp, dropout=0.0)
    trainer.load_state_dict(path)
    return trainer


@pytest.mark.parametrize("name", ["full.ch", "ckpt"])
def test_saves_reload_in_one_process_and_in_jax(runs, tmp_path, name):
    saved = runs.load("zero1")[0]["whole"]
    state = ckpt.read_state(runs.out / name)
    assert state["global_step"] == 2
    trainer = _one_process(tmp_path, runs.out / name)
    assert trainer.global_step == 2
    jax_restored = from_jax_params(runs.jax_restored[name])
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
        assert torch.equal(jax_restored[n], saved[n]), n
    mu = from_jax_params(state["optimizer"]["0"]["0"]["mu"])
    for n, m in trainer.optimizer.mu.items():
        want = mu[n][tuple(slice(0, d) for d in m.shape)]
        assert torch.equal(m, want), n
    assert any(float(m.abs().sum()) > 0 for m in trainer.optimizer.mu.values())


def test_saves_peek_as_the_jax_ones(runs):
    layout = ckpt.peek_checkpoint_layout(runs.out / "ckpt")
    jax_layout = jax_peek_layout(runs.out / "ckpt")
    want = jax_peek_layout(runs.out / "jax_ckpt")
    for got in (layout, jax_layout):
        assert got["mesh_axes"] == want["mesh_axes"] == MESH
        assert got["shards"] == want["shards"] == 4
        assert got["opt_sharding"] == want["opt_sharding"] == "zero1"
    full = ckpt.peek_checkpoint_layout(runs.out / "full.ch")
    assert full["mesh_axes"] == MESH and full["format"] == "single_file"


def test_jax_tp_sharded_save_restores_in_the_port(runs):
    want = from_jax_params(runs.jax_dm)
    records = runs.load("jax")
    for rank, record in enumerate(records):
        assert record["restored_step"] == runs.jax_step
        dims = record["dims"]
        for name, p in record["restored"].items():
            if name in dims:
                n = p.shape[dims[name]]
                ref = want[name].narrow(dims[name], (rank % 2) * n, n)
            else:
                ref = want[name]
            assert torch.equal(p, ref), name
        assert np.isfinite(record["values"][0]["loss"])


def test_full_save_resumes_on_the_tp_mesh(runs):
    saved = runs.load("zero1")
    resumed = runs.load("full")
    for rank in range(4):
        assert resumed[rank]["restored_step"] == 2
        for name, p in saved[rank]["params"].items():
            assert torch.equal(resumed[rank]["restored"][name], p), name
        for name, m in saved[rank]["mu"].items():
            assert torch.equal(resumed[rank]["restored_mu"][name], m), name
        assert np.isfinite(resumed[rank]["values"][0]["loss"])
