"""Pipeline stages of tensor-parallel layers (``--mesh pipe:2,model:2`` and
``data:2,pipe:2,model:2``) in the port, against the JAX package's mesh,
stage layout and ``Trainer`` on the same meshes and against the port's own
``pipe:2`` and ``model:2``, on the CPU.

In process: every group of every composition of the four axes up to 8
ranks is the JAX device array's (``mesh.mesh_groups``), and ``build_mesh``
gives each rank's ``model`` transport its own group in each; the stage
layout's pipe dimension under the tensor-parallel rules and
``stage_param_bytes`` equal the JAX package's; a JAX tree cut to one
stage's slices and joined back is the tree; the new meshes pass
``check_train_flags`` and ``seq`` beside ``model`` is still refused.

One module fixture runs, at once, the port's 4-rank gloo world of
``tests/test_torch_pipe_model_worker.py quad`` (``pipe:2,model:2``), its
2-rank ``pair`` world (``pipe:2`` and ``model:2`` on the same batch) and
the JAX ``Trainer`` on ``pipe:2,model:2`` under GPipe and 1F1B (f32,
dropout 0, the same weights and batches; the GPipe one records its first
update's gradient and writes a sharded checkpoint), then the 8-rank
``octo`` world (``data:2,pipe:2,model:2``, ZeRO-1) beside one JAX
``pipe:2,model:2`` step with the clip off and the JAX 1F1B trainer on the
octo mesh (its loader regrouped so that its contiguous micro-batches are
the port's global ones; both record the first update's gradient), then the 4-rank ``resume`` world beside a
JAX ``pipe:2,model:2`` restore of both port saves. The held results:

- the exact gate: the first step's loss within 1e-6 relative of the JAX
  trainer's, the first update's gradient (gathered whole) within 1e-5
  relative L2 after the clip and before it (a JAX step with the clip off),
  and five steps within the JAX package's own
  ``pipe:2,model:2`` bounds (``tests/test_dp_equivalence.py``: rtol
  5e-4, atol 1e-4, parameters 2e-3: its stage runs whole matmuls where
  the port runs split ones and an all-reduce), under both schedules;
- GPipe equals 1F1B bit for bit, and the stage layout the replicated
  one; ``pipe:2,model:2`` equals the port's ``model:2`` and ``pipe:2`` on
  the same batch (values ``rtol=1e-5``, gradients to a relative L2 of
  1e-5, parameters ``atol=2e-6``); at dropout 0.1 it equals ``pipe:2``
  within 1e-6 relative (a model group draws one hidden mask and its
  heads' attention masks), and dropout is live;
- ``data:2,pipe:2,model:2`` with ZeRO-1 equals the JAX trainer on that
  mesh (1F1B) for one step: its clipped gradient within 1e-5 relative L2
  and its parameters within 5e-5;
- the ``pipe:2,model:2`` save peeks as the JAX one does (``mesh_axes``,
  ``shards``, the schedule and layout), reloads bit for bit in one
  process and in the JAX package; the JAX package's save resumes in the
  port; a whole (single-file) checkpoint resumes on the split stages.

Budget: the fixture's worlds carry a deadline each (``PAIR_DEADLINE_S``).
"""

import concurrent.futures
import itertools
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import torch_ddp_worker as worker
from helpers import write_vocab
from ml_recipe_tpu.data.collate import make_collate_fun as jax_collate
from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh as jax_build_mesh
from ml_recipe_tpu.parallel import pipeline as jax_pipeline
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.train.checkpoint import (
    peek_checkpoint_layout as jax_peek_layout,
)
from ml_recipe_tpu_torch.config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.models import (
    from_jax_params,
    merge_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.models.convert import jax_path
from ml_recipe_tpu_torch.parallel import mesh as mesh_mod
from ml_recipe_tpu_torch.parallel import pipeline
from ml_recipe_tpu_torch.parallel import regroup_for_world
from ml_recipe_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh, mesh_groups
from ml_recipe_tpu_torch.parallel.sharding import tp_param_dims
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train import checkpoint as ckpt

LOSS_REL, GRAD_REL = 1e-6, 1e-5              # the exact gate against JAX
STEP_RTOL, STEP_ATOL, PARAMS_ATOL = 5e-4, 1e-4, 2e-3   # JAX's own pins
TP_RTOL, TP_PARAMS_ATOL = 2e-5, 5e-5         # its TP pins (model:2)
PORT_RTOL, PORT_GRAD_REL, PORT_PARAM_ATOL = 1e-5, 1e-5, 2e-6
DROP_REL = 1e-6
MESH = {"pipe": 2, "model": 2}
WORKER = Path(__file__).resolve().parent / "test_torch_pipe_model_worker.py"
REPO = Path(__file__).resolve().parent.parent


# -- in process ---------------------------------------------------------------

def _compositions(world: int):
    """Every mesh over :data:`AXIS_ORDER` of ``world`` ranks (sizes powers
    of two)."""
    sizes = [2 ** e for e in range(int(math.log2(world)) + 1)]
    for combo in itertools.product(sizes, repeat=len(AXIS_ORDER)):
        if math.prod(combo) == world:
            yield dict(zip(AXIS_ORDER, combo))


def _jax_groups(axes: dict) -> dict:
    """The JAX mesh's groups of ``axes``: for each axis of size > 1, the
    device ids that share every other coordinate of the device array,
    found by the devices' coordinates; and, where a stage holds more than
    one device, the devices of each ``pipe`` index."""
    mesh = jax_build_mesh(axes=axes)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    names = list(mesh.axis_names)
    coords = {int(ids[idx]): idx for idx in np.ndindex(ids.shape)}
    out = {}
    for i, name in enumerate(names):
        if ids.shape[i] < 2:
            continue
        rows = {}
        for dev, idx in sorted(coords.items()):
            rows.setdefault(idx[:i] + idx[i + 1:], []).append(dev)
        out[name] = sorted(rows.values())
    if 1 < axes.get("pipe", 1) < ids.size:
        p = names.index("pipe")
        out["stage"] = [sorted(d for d, idx in coords.items()
                               if idx[p] == k) for k in range(axes["pipe"])]
    return out, coords, names


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_groups_follow_the_jax_device_order(world):
    for axes in _compositions(world):
        want, coords, names = _jax_groups(axes)
        got = mesh_groups(axes)
        assert {k: sorted(v) for k, v in got.items()} == want, axes
        for rank, idx in coords.items():
            place = Mesh(axes=axes, rank=rank, world=world)
            at = dict(zip(names, idx))
            assert (place.pipe_index, place.data_index, place.seq_index,
                    place.model_index) == tuple(at[n] for n in AXIS_ORDER)
            row = next(g for g in got.get("data", [[rank]]) if rank in g)
            assert place.data_ranks == tuple(row), (axes, rank)


class _FakeGroup(tuple):
    pass


@pytest.mark.parametrize("spec,world", [
    ("pipe:2,model:2", 4), ("data:2,pipe:2,model:2", 8),
    ("model:2", 2), ("data:2,model:2", 4), ("pipe:2,data:2", 4),
    ("pipe:2", 2)])
def test_every_rank_gets_its_own_model_group(monkeypatch, spec, world):
    """``build_mesh`` on every rank of the world (the collectives faked):
    each rank creates every group in one order, and its model transport,
    pipeline and stage groups are the ones that hold it; never the world
    (None)."""
    created = []
    monkeypatch.setattr(mesh_mod.dist, "new_group", lambda ranks: (
        created.append(tuple(ranks)) or _FakeGroup(ranks)))
    seen = {}
    for cls in ("ModelTransport", "StageTransport", "RingTransport"):
        monkeypatch.setattr(mesh_mod, cls, lambda *a, _c=cls: (_c, a))
    orders = []
    for rank in range(world):
        monkeypatch.setattr(mesh_mod.pdist, "process_count", lambda: world)
        monkeypatch.setattr(mesh_mod.pdist, "process_index", lambda: rank)
        created.clear()
        mesh = mesh_mod.build_mesh(spec)
        orders.append(list(created))
        seen[rank] = mesh
    assert all(o == orders[0] for o in orders)
    for rank, mesh in seen.items():
        T, K = mesh.model_size, mesh.pipe_size
        if T > 1:
            kind, (ranks, me, group) = mesh.model_transport
            assert kind == "ModelTransport" and me == rank
            assert group is not None and rank in group
            assert tuple(group) == tuple(ranks) == mesh.model_ranks
            assert len(group) == T and mesh.model_group is group
        if K > 1:
            assert mesh.stage[1][0] == mesh.pipe_ranks
            assert (mesh.pipe_group is None if K == world else
                    rank in mesh.pipe_group and len(mesh.pipe_group) == K)
        if 1 < K < world:
            assert mesh.stage_group is not None and len(
                mesh.stage_group) == world // K
            assert all(seen[r].pipe_index == mesh.pipe_index
                       for r in mesh.stage_group)
        elif K == world:
            # a stage of one rank: no group, nothing reduces over it
            assert mesh.stage_group is None
        if mesh.data_size > 1:
            assert tuple(mesh.data_group) == mesh.data_ranks


def _tiny(mesh=None, layers=2):
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel

    cfg = dict(worker.TINY_MODEL, num_layers=layers)
    return QAModel(EncoderConfig(vocab_size=50, **cfg), mesh=mesh)


@pytest.mark.parametrize("layout", ["stage", "replicated"])
def test_stage_layout_plans_on_whole_leaves_as_jax(layout):
    """The stage layout's pipe dimension of each leaf, planned on a
    ``model:2`` rank's model, is the JAX ``stage_param_specs``' (``model``
    claimed first); ``stage_param_bytes`` with ``model_size`` is the JAX
    function's; a rank stores its stage's slices."""
    tree = to_jax_params(_tiny(layers=4).state_dict())
    plan = SimpleNamespace(pipe_size=2, model_size=2)
    specs = jax_pipeline.stage_param_specs(tree, plan)
    for K in (2, 4):
        assert pipeline.stage_param_bytes(tree, pipe_size=K, model_size=2) \
            == jax_pipeline.stage_param_bytes(tree, pipe_size=K,
                                              model_size=2)
    model = _tiny(Mesh(axes={"pipe": 2, "model": 2}, rank=3, world=4),
                  layers=4)
    lay = pipeline.StageLayout(model, stages=2, index=1, layout=layout,
                               split=model.model_split())
    flat = {tuple(x.key for x in k): s for k, s in
            jax.tree_util.tree_flatten_with_path(specs)[0]}
    checked = 0
    for name in lay.shapes:
        spec = flat[jax_path(name)]
        dim = lay.pipe_dim(name)
        if layout == "replicated":
            assert dim is None
            continue
        want = list(spec).index("pipe") if "pipe" in tuple(spec) else None
        assert dim == want, name
        checked += 1
    assert layout == "replicated" or checked == len(lay.shapes)
    assert lay.whole["transformer.layer_3.attention.query.weight"] == (64, 64)
    assert lay.shapes["transformer.layer_3.attention.query.weight"] == (
        32, 64)
    lay.release(model)
    stored = {n for n, p in model.named_parameters() if p.device.type != "meta"}
    if layout == "stage":
        assert stored == set(lay.owned)
        assert "transformer.layer_0.attention.query.weight" not in stored


def test_a_jax_tree_cut_to_stage_slices_joins_back():
    """A JAX tree cut to each ``pipe:2,model:2`` rank's slices (its
    ``model`` slices of its stage's leaves, ``pipeline.param_stage``) and
    joined back (gathered over ``model``, the stages merged) is the
    tree."""
    tree = to_jax_params(_tiny().state_dict())
    parts = {(k, r): {n: t for n, t in from_jax_params(
        tree, model_index=r, model_size=2).items()
        if pipeline.param_stage(n, 2, 2) == k}
        for k in range(2) for r in range(2)}
    assert "transformer.embeddings.word_embeddings.weight" in parts[0, 1]
    assert "classifier.weight" in parts[1, 0]
    assert not set(parts[0, 0]) & set(parts[1, 0])
    dims = tp_param_dims(parts[0, 0]) | tp_param_dims(parts[1, 0])
    stages = []
    for k in range(2):
        whole = {n: (torch.cat([parts[k, 0][n], parts[k, 1][n]],
                               dim=dims[n]) if n in dims else parts[k, 0][n])
                 for n in parts[k, 0]}
        stages.append(to_jax_params(whole))
    back = merge_jax_params(*stages)
    paths = jax.tree_util.tree_leaves_with_path
    assert len(paths(back)) == len(paths(tree))
    for (path, a), (_, b) in zip(paths(back), paths(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert parts[1, 1]["transformer.layer_1.mlp.output.weight"].shape == (
        64, 64)


def _train_flags(tmp, *extra, world):
    vocab = tmp / "vocab.txt"
    if not vocab.exists():
        vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]))
    return get_params((get_trainer_parser, get_model_parser), [
        "-c", str(REPO / "config" / "test_bert.cfg"), "--vocab_file",
        str(vocab), "--dump_dir", str(tmp / "results"), "--device", "cpu",
        "--model", "bert-tiny", "--dist_world_size", str(world),
        "--local_rank", "0", *extra])[1]


@pytest.mark.parametrize("mesh,world,extra", [
    ("pipe:2,model:2", 4, ["--pipe_schedule", "1f1b", "--ln_impl", "fused",
                           "--remat"]),
    ("pipe:2,model:2", 4, ["--pipe_param_sharding", "replicated"]),
    ("data:2,pipe:2,model:2", 8, ["--optimizer_sharding", "zero1",
                                  "--zero1_overlap", "bucketed"])],
    ids=["quad", "replicated", "octo"])
def test_pipe_model_meshes_pass_the_train_flags(tmp_path, mesh, world,
                                               extra):
    params, model_params = _train_flags(tmp_path, "--mesh", mesh, *extra,
                                        world=world)
    check_train_flags(params, model_params)


@pytest.mark.parametrize("live", [8, 6, 4])
def test_elastic_shrink_narrows_only_data_beside_pipe_and_model(live):
    from ml_recipe_tpu.parallel.mesh import elastic_axes as jax_elastic_axes

    from ml_recipe_tpu_torch.parallel.mesh import elastic_axes

    axes = {"data": 2, "pipe": 2, "model": 2}
    assert elastic_axes(axes, live) == jax_elastic_axes(axes, live)
    assert elastic_axes(axes, live) == {**axes, "data": live // 4}


def test_seq_beside_model_is_still_refused(tmp_path):
    params, model_params = _train_flags(tmp_path, "--mesh",
                                        "seq:2,model:2", world=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.*seq x model"):
        check_train_flags(params, model_params)


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


def _jax_trainer(tmp, mesh_spec, steps=None, grads=None,
                 max_grad_norm=worker.MAX_GRAD_NORM, **kw):
    """The JAX ``Trainer`` of the tiny model on ``mesh_spec`` (f32, dropout
    0, the port's weights); ``steps`` collects each step's values,
    ``grads`` the first update's gradient (the one the optimizer is handed,
    after the clip; a ZeRO-1 plan's padding cut off). ``max_grad_norm`` 0
    turns the clip off."""
    import optax

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
        max_grad_norm=max_grad_norm, train_weights=weights,
        debug=True, seed=0, hbm_preflight=False,
        on_train_metrics=None if steps is None else (
            lambda meters, step: steps.append(
                {k: float(v) if k == "lr" else float(v())
                 for k, v in meters.items()})), **kw)
    if grads is not None:
        inner = trainer.optimizer

        def keep(tree):
            if not grads:
                grads.update(from_jax_params(jax.tree_util.tree_map(
                    lambda g, p: np.asarray(g)[tuple(map(slice, p.shape))],
                    tree, init)))

        def update(updates, state, params=None):
            jax.debug.callback(keep, updates)
            return inner.update(updates, state, params)

        trainer.optimizer = optax.GradientTransformation(inner.init, update)
    return init, trainer


def _world(mode, out, ranks):
    return worker.run_pairs(lambda rank, port: [
        sys.executable, str(WORKER), mode, str(rank), str(ranks), str(port),
        str(out)], ranks=ranks)


def _check(results):
    for pair in results:
        for rc, err in pair:
            assert rc == 0, err[-3000:]


def _params(trainer):
    return jax.tree_util.tree_map(np.asarray, trainer.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_model")
    out = tmp / "worlds"
    out.mkdir()
    jax_runs = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        quad = pool.submit(_world, "quad", out, 4)
        pair = pool.submit(_world, "pair", out, 2)
        for schedule, spec in (("gpipe", "pipe:2,model:2"),
                               ("1f1b", "pipe:2,model:2"),
                               ("model2", "model:2")):
            steps, grads = [], {}
            kw = ({} if schedule == "model2" else
                  dict(pipe_schedule=schedule, sharded_checkpoint=True))
            init, jt = _jax_trainer(tmp / f"jax_{schedule}", spec, steps,
                                    grads, **kw)
            # one whole epoch, as the port's runs
            jt.debug, jt.n_epochs = False, 1
            jt.train()
            jax_runs[schedule] = SimpleNamespace(
                steps=steps, grads=grads, params=_params(jt),
                step=jt.global_step)
            if schedule == "gpipe":
                jt.save_state_dict(out / "jax_ckpt")
        _check(quad.result())
        _check(pair.result())
        octo = pool.submit(_world, "octo", out, 8)
        resume = pool.submit(_world, "resume", out, 4)
        # the first step's gradient before the clip: the clip off
        unclipped = {}
        _, ju = _jax_trainer(tmp / "jax_unclipped", "pipe:2,model:2",
                             grads=unclipped, max_grad_norm=0.0,
                             pipe_schedule="1f1b")
        ju.n_epochs = 1
        ju.train()
        # 1F1B: the JAX GPipe step's trunk gradient is 1/T
        # (test_the_jax_gpipe_trunk_gradient_is_one_over_t)
        zsteps, zgrads = [], {}
        _, jz = _jax_trainer(tmp / "jax_zero1", "data:2,pipe:2,model:2",
                             zsteps, zgrads, optimizer_sharding="zero1",
                             zero_min_size=0, pipe_schedule="1f1b")
        jz.train_dataloader = _Regrouped(jz.train_dataloader, 2,
                                         worker.BATCH_SPLIT)
        jz.n_epochs = 1
        jz.train()
        _, jr = _jax_trainer(tmp / "jax_r", "pipe:2,model:2")
        restored = {}
        for name in ("full.ch", "ckpt"):
            jr.load_state_dict(out / name)
            restored[name] = (_params(jr), jr.global_step)
        _check(octo.result())
        _check(resume.result())

    def load(name, ranks=4):
        return [torch.load(out / f"{name}_rank{r}.pt") for r in range(ranks)]

    return SimpleNamespace(out=out, load=load, init=init, jax=jax_runs,
                           unclipped=unclipped, zero1_steps=zsteps,
                           zero1_grads=zgrads, zero1_params=_params(jz),
                           jax_restored=restored)


def _whole(records) -> dict:
    """The whole model (the port's names) from the ranks' leaves gathered
    over each model group (``whole``; the data index 0 ranks)."""
    out = {}
    for r in records:
        if r["coords"]["data"] == 0:
            out.update(r["whole"])
    return out


def _gathered(records, key) -> dict:
    """The whole model's tensors of ``records[i][key]`` (each rank's
    slices of its stage's leaves), joined over each model group (the data
    index 0 ranks)."""
    parts = {}
    for r in records:
        if r["coords"]["data"]:
            continue
        for name, t in r[key].items():
            dim = r["dims"].get(name)
            parts.setdefault(name, (dim, {}))[1][r["coords"]["model"]] = t
    return {n: (torch.cat([p[m] for m in sorted(p)], dim=dim)
                if dim is not None else p[0])
            for n, (dim, p) in parts.items()}


def _assert_trajectory(port_values, port_whole, want, jax_params, init,
                       rtol=STEP_RTOL, atol=STEP_ATOL,
                       params_atol=PARAMS_ATOL):
    """Five steps against the JAX trainer's: its logged values are the
    epoch's running means (its meters), so the port's are averaged alike."""
    assert len(port_values) == len(want) == 5
    for step, ref in enumerate(want):
        got = port_values[step]
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        for key in ref:
            if key != "lr":
                mean = np.mean([v[key] for v in port_values[:step + 1]])
                np.testing.assert_allclose(mean, ref[key], rtol=rtol,
                                           atol=atol,
                                           err_msg=f"step {step} {key}")
    paths = jax.tree_util.tree_leaves_with_path
    moved = 0
    for (path, a), (_, b), (_, c) in zip(paths(port_whole),
                                         paths(jax_params), paths(init)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=params_atol,
                                   err_msg=str(path))
        moved += not np.array_equal(b, c)
    assert moved > len(paths(port_whole)) // 2


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_exact_gate_against_the_jax_pipe_model_trainer(runs, schedule):
    """Each port schedule against the JAX ``pipe:2,model:2`` trainer on
    1F1B: the first step's loss within 1e-6 relative, the first update's
    gradient (gathered whole) within 1e-5 relative L2 as the clip leaves it
    and as it reaches it (the JAX step with the clip off), and five
    steps within the JAX package's own ``pipe:2,model:2`` bounds; and the
    five steps within the JAX package's tensor-parallel pins of its
    ``model:2`` trainer, which computes the same function. (The JAX GPipe
    step parts from both in its gradient:
    :func:`test_the_jax_gpipe_trunk_gradient_is_one_over_t`.)"""
    port = runs.load(schedule)
    ref = runs.jax["1f1b"]
    for rank in range(4):
        assert port[rank]["values"] == port[0]["values"]
    loss, want = port[0]["values"][0]["loss"], ref.steps[0]["loss"]
    assert abs(loss - want) <= LOSS_REL * abs(want), (loss, want)
    clipped = _gathered(port, "clipped")
    assert set(clipped) == set(ref.grads)
    assert worker.rel_l2(clipped, ref.grads) < GRAD_REL
    assert worker.rel_l2(clipped, runs.jax["model2"].grads) < GRAD_REL
    # before the clip too: the clip divides out an error that scales every
    # leaf alike, and this step's norm is past it
    grads = _gathered(port, "grads")
    assert set(grads) == set(runs.unclipped)
    assert worker.rel_l2(grads, runs.unclipped) < GRAD_REL
    norm = float(torch.cat([g.reshape(-1) for g in grads.values()]).norm())
    assert norm > worker.MAX_GRAD_NORM, norm
    whole = to_jax_params(_whole(port))
    _assert_trajectory(port[0]["values"], whole, ref.steps, ref.params,
                       runs.init)
    model2 = runs.jax["model2"]
    _assert_trajectory(port[0]["values"], whole, model2.steps,
                       model2.params, runs.init, rtol=TP_RTOL, atol=0.0,
                       params_atol=TP_PARAMS_ATOL)
    # the eval after the epoch, the same on every rank
    assert len(port[0]["metrics"]) == 1
    assert all(r["metrics"] == port[0]["metrics"] for r in port)


def test_the_jax_gpipe_trunk_gradient_is_one_over_t(runs):
    """A reference caveat, pinned: the JAX ``pipe:2,model:2`` trainer on
    GPipe computes the first step's loss the port does (within 1e-6
    relative) but hands its optimizer the stage-scope leaves' gradient
    (the embeddings and the encoder layers) divided by the ``model`` size,
    the heads' whole: the port's gradient with those leaves halved, then
    clipped as the JAX step clips, is the JAX one within 1e-5 relative L2;
    the port's own (the JAX 1F1B and ``model:2`` gradient) is not. Adam's
    per-element normalisation hides most of the factor from the
    trajectories."""
    from ml_recipe_tpu_torch.parallel.sharding import STAGE_SCOPE_RE

    port = runs.load("gpipe")
    ref = runs.jax["gpipe"]
    loss, want = port[0]["values"][0]["loss"], ref.steps[0]["loss"]
    assert abs(loss - want) <= LOSS_REL * abs(want), (loss, want)
    grads = _gathered(port, "grads")
    halved = {n: g / 2 if STAGE_SCOPE_RE.search("/".join(jax_path(n)))
              else g.clone() for n, g in grads.items()}
    norm = float(torch.cat([g.reshape(-1) for g in halved.values()]).norm())
    scale = worker.MAX_GRAD_NORM / max(norm, worker.MAX_GRAD_NORM)
    halved = {n: g * scale for n, g in halved.items()}
    assert worker.rel_l2(halved, ref.grads) < GRAD_REL
    assert worker.rel_l2(_gathered(port, "clipped"), ref.grads) > 0.1


def test_ranks_sit_on_the_jax_mesh_and_split_their_stage(runs):
    port = runs.load("gpipe")
    coords = [(r["coords"]["pipe"], r["coords"]["model"]) for r in port]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["model_ranks"] for r in port] == [(0, 1), (0, 1), (2, 3),
                                                (2, 3)]
    first, last = port[1]["params"], port[3]["params"]
    assert first["transformer.layer_0.attention.query.weight"].shape == (
        32, 64)
    assert last["transformer.layer_1.mlp.intermediate.weight"].shape == (
        64, 64)
    assert "transformer.layer_1.attention.query.weight" not in first
    assert "classifier.weight" in last and "classifier.weight" not in first
    assert "transformer.embeddings.word_embeddings.weight" in first
    # one layer a stage: 2 all-reduces forward and 2 backward a micro-batch
    # (10 of them in 5 steps) and 2 an eval batch (4 of them)
    for r in port:
        assert r["transport"]["backward"] == 10 * 2
        assert r["transport"]["forward"] == (10 + 4) * 2


def test_gpipe_equals_1f1b_and_stage_equals_replicated(runs):
    gpipe, ofob = runs.load("gpipe"), runs.load("1f1b")
    saver, repl = runs.load("saver"), runs.load("replicated")
    for rank in range(4):
        a, b = gpipe[rank], ofob[rank]
        assert a["values"] == b["values"]
        for name in a["params"]:
            assert torch.equal(a["params"][name], b["params"][name]), name
            assert torch.equal(a["grads"][name], b["grads"][name]), name
        assert a["in_flight"] == 2 and b["in_flight"] <= 2
        assert saver[rank]["layout"] == "stage"
        assert repl[rank]["layout"] == "replicated"
        assert repl[rank]["values"] == saver[rank]["values"]
        for name, p in saver[rank]["params"].items():
            assert torch.equal(repl[rank]["params"][name], p), name
    # replicated: every rank holds the whole updated model
    assert set(repl[0]["params"]) == set(repl[2]["params"])
    assert ofob[2]["in_flight"] == 1


@pytest.mark.parametrize("other", ["model2", "pipe2"])
def test_pipe_model_equals_the_ports_model2_and_pipe2(runs, other):
    quad, two = runs.load("saver"), runs.load(other, 2)
    for got, ref in zip(quad[0]["values"], two[0]["values"]):
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=PORT_RTOL,
                                       err_msg=key)
    grads, want = _gathered(quad, "grads"), _gathered(two, "grads")
    assert set(grads) == set(want)
    assert worker.rel_l2(grads, want) < PORT_GRAD_REL
    whole, ref = _whole(quad), _whole(two)
    assert set(whole) == set(ref)
    for name, p in ref.items():
        np.testing.assert_allclose(whole[name], p, atol=PORT_PARAM_ATOL,
                                   err_msg=name)


def test_dropout_draws_the_masks_of_pipe2(runs):
    quad, pipe2 = runs.load("drop"), runs.load("pipe2_drop", 2)
    for got, ref in zip(quad[0]["values"], pipe2[0]["values"]):
        assert abs(got["loss"] - ref["loss"]) <= DROP_REL * abs(ref["loss"])
    assert len(quad[0]["values"]) == 2
    assert all(r["values"] == quad[0]["values"] for r in quad)
    # dropout is live: the dropout-0 step on the same batch differs
    assert quad[0]["values"][0]["loss"] != runs.load("saver")[0]["values"][
        0]["loss"]


def test_data2_pipe2_model2_zero1_equals_the_jax_trainer(runs):
    """One ZeRO-1 step of ``data:2,pipe:2,model:2`` against the JAX
    trainer's on that mesh (1F1B): the values, the first update's gradient
    (clipped, gathered whole) within 1e-5 relative L2, and the updated
    parameters within the TP pin 5e-5, well below the 1e-3 (the lr) that
    Adam's first step moves an element by."""
    port = runs.load("zero1", 8)
    want = runs.zero1_steps
    for rank in range(8):
        assert port[rank]["values"] == port[0]["values"]
        c = port[rank]["coords"]
        assert (c["pipe"], c["data"], c["model"]) == (rank // 4,
                                                      rank // 2 % 2, rank % 2)
    got = port[0]["values"][0]
    for key in want[0]:
        np.testing.assert_allclose(got[key], want[0][key], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=key)
    assert abs(got["loss"] - want[0]["loss"]) <= LOSS_REL * abs(
        want[0]["loss"])
    clipped = _gathered(port, "clipped")
    assert set(clipped) == set(runs.zero1_grads)
    assert worker.rel_l2(clipped, runs.zero1_grads) < GRAD_REL
    whole = to_jax_params(_whole(port))
    paths = jax.tree_util.tree_leaves_with_path
    moved = 0
    for (path, a), (_, b), (_, c) in zip(paths(whole),
                                         paths(runs.zero1_params),
                                         paths(runs.init)):
        np.testing.assert_allclose(a, b, rtol=0.0, atol=TP_PARAMS_ATOL,
                                   err_msg=str(path))
        moved += not np.array_equal(a, c)
    assert moved > len(paths(whole)) // 2
    # the data rows agree (rank r and r + 2: data 0 and 1 of one stage
    # and model index); ZeRO-1 within a stage: the word embeddings' moment
    # is the data half of the rank's whole table (pipe claims the hidden
    # dimension, the larger that it divides; data the vocabulary; model
    # none)
    for rank in (0, 1, 4, 5):
        for name, p in port[rank]["whole"].items():
            assert torch.equal(port[rank + 2]["whole"][name], p), name
    mu = port[0]["mu"]["transformer.embeddings.word_embeddings.weight"]
    table = port[0]["params"]["transformer.embeddings.word_embeddings.weight"]
    assert mu.shape == (table.shape[0] // 2, table.shape[1])


def test_pipe_model_save_peeks_as_the_jax_one(runs):
    want = jax_peek_layout(runs.out / "jax_ckpt")
    for peek in (ckpt.peek_checkpoint_layout, jax_peek_layout):
        layout = peek(runs.out / "ckpt")
        for key in ("mesh_axes", "shards", "pipe_schedule",
                    "pipe_param_layout", "opt_sharding"):
            assert layout[key] == want[key], key
        assert layout["process_count"] == 4
    assert want["mesh_axes"] == MESH and want["shards"] == 4
    full = ckpt.peek_checkpoint_layout(runs.out / "full.ch")
    assert full["mesh_axes"] == MESH and full["format"] == "single_file"


@pytest.mark.parametrize("name", ["full.ch", "ckpt"])
def test_saves_reload_in_one_process_and_in_jax(runs, tmp_path, name):
    saved = _whole(runs.load("saver"))
    state = ckpt.read_state(runs.out / name)
    assert state["global_step"] == 2
    one = worker.tiny_trainer(tmp_path, dropout=0.0)
    one.load_state_dict(runs.out / name)
    assert one.global_step == 2
    jax_params, jax_step = runs.jax_restored[name]
    assert jax_step == 2
    jax_restored = from_jax_params(jax_params)
    for n, p in one.model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
        assert torch.equal(jax_restored[n], saved[n]), n
    assert any(float(m.abs().sum()) > 0 for m in one.optimizer.mu.values())
    mu = _gathered(runs.load("saver"), "mu")
    for n, m in one.optimizer.mu.items():
        assert torch.equal(m, mu[n]), n


def test_jax_save_resumes_on_the_port_stages(runs):
    want = from_jax_params(runs.jax["gpipe"].params)
    records = runs.load("jax")
    for rank, record in enumerate(records):
        assert record["restored_step"] == runs.jax["gpipe"].step
        dims = record["dims"]
        for name, p in record["restored"].items():
            ref = want[name]
            if name in dims:
                n = p.shape[dims[name]]
                ref = ref.narrow(dims[name], record["coords"]["model"] * n, n)
            assert torch.equal(p, ref), name
        assert np.isfinite(record["values"][0]["loss"])
    assert set(records[0]["restored"]) | set(records[2]["restored"]) \
        == set(want)


def test_whole_checkpoint_resumes_on_the_split_stages(runs):
    saved, resumed = runs.load("saver"), runs.load("full")
    for rank in range(4):
        assert resumed[rank]["restored_step"] == 2
        for name, p in saved[rank]["params"].items():
            assert torch.equal(resumed[rank]["restored"][name], p), name
        for name, m in saved[rank]["mu"].items():
            assert torch.equal(resumed[rank]["restored_mu"][name], m), name
        assert np.isfinite(resumed[rank]["values"][0]["loss"])
