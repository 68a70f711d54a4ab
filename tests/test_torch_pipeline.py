"""Pipeline parallelism (the ``pipe`` axis, GPipe and 1F1B) in the port,
against the JAX package's ``parallel/pipeline.py`` and ``Trainer`` and
against the port's own one-process step, on the CPU.

In process: the schedule accounting (``stage_layer_count``,
``stage_assignment``, ``modeled_bubble_fraction``,
``measured_bubble_fractions``) for K in {1, 2, 4} and m in {1, 2, 4, 8};
``validate_pipeline_plan``'s refusals; ``stage_param_bytes`` and the
ZeRO-1 plan within a stage's leaves on the same weights; the schedules'
units and in-flight counts; the two pipe flags live beside a ``model``
axis too, ``pipe:2,seq:2`` refused, naming ROADMAP.

One module fixture runs, at once, the port's 4-rank gloo world of
``tests/test_torch_pipeline_worker.py train`` (``data:2,pipe:2``, the tiny trainer
of 2 layers: one a stage) and the JAX ``Trainer`` at ``data:2,pipe:2``
(GPipe, m = 4, dropout 0, the same weights; its loader regrouped so that
its contiguous micro-batches are the port's global ones), which then saves
a sharded checkpoint. Then the 4-rank ``resume`` world restores the port's
and the JAX package's saves, while a JAX ``Trainer`` on ``data:4`` restores
the port's. The held results:

- the port's GPipe steps equal the JAX trainer's: step values to
  ``rtol=2e-5``, end parameters to ``atol=5e-5`` (the JAX package's own
  pins, ``tests/test_dp_equivalence.py``);
- 1F1B equals GPipe bit for bit at m = 1, 2, 4 (both run the backwards in
  micro-batch order), holding at most ``min(m, 2K-1)`` micro-batches, fewer
  than m at m = 4; ``pipe:2`` equals the one-process trainer on the same
  global micro-batches (values ``rtol=1e-5``, gradients to a relative L2 of
  1e-5, parameters ``atol=2e-6``); ``stage`` equals ``replicated``, and a
  stage stores only its leaves; ZeRO-1 equals off, bucketing inert (0
  buckets); at dropout 0.1 two runs are bit-identical, GPipe equals 1F1B
  and the loss falls;
- the port's ``data:2,pipe:2`` save peeks as the JAX one does (both
  packages' ``peek_checkpoint_layout``: ``mesh_axes``, ``pipe_schedule``,
  ``pipe_param_layout``, ``shards`` 4) and restores bit for bit at
  ``data:4`` in the port and in the JAX package; the JAX pipe save
  restores in the port; a GPipe save resumes under 1F1B and takes the step
  the saver took.

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

import torch_ddp_worker as worker
from helpers import write_vocab
from ml_recipe_tpu.data.collate import make_collate_fun as jax_collate
from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh as jax_build_mesh
from ml_recipe_tpu.parallel import pipeline as jax_pipeline
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
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.models import from_jax_params, to_jax_params
from ml_recipe_tpu_torch.parallel import pipeline
from ml_recipe_tpu_torch.parallel import regroup_for_world
from ml_recipe_tpu_torch.parallel.sharding import zero1_plan, zero1_state_bytes
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train import checkpoint as ckpt

RTOL, PARAMS_ATOL = 2e-5, 5e-5          # against JAX
GRAD_REL, PARAM_ATOL = 1e-5, 2e-6       # against the port's one process
MESH = {"data": 2, "pipe": 2}
WORKER = Path(__file__).resolve().parent / "test_torch_pipeline_worker.py"


# -- in process ---------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedule_accounting_matches_jax(K, schedule):
    for layers in (4, 8, 12):
        assert (pipeline.stage_layer_count(layers, K)
                == jax_pipeline.stage_layer_count(layers, K))
        assert (pipeline.stage_assignment(layers, K)
                == jax_pipeline.stage_assignment(layers, K))
    times = {}
    for m in (1, 2, 4, 8):
        assert (pipeline.modeled_bubble_fraction(K, m, schedule)
                == jax_pipeline.modeled_bubble_fraction(K, m, schedule))
        times[m] = 1.0 + 0.37 * m + 0.05 * K
    assert (pipeline.measured_bubble_fractions(times, K, schedule)
            == jax_pipeline.measured_bubble_fractions(times, K, schedule))
    with pytest.raises(ValueError):
        pipeline.stage_layer_count(6, 4)
    with pytest.raises(ValueError):
        pipeline.modeled_bubble_fraction(K, 2, "interleaved")


@pytest.mark.parametrize("case", ["depth", "schedule", "seq", "split",
                                  "model"])
def test_validate_pipeline_plan_refuses_as_jax(case):
    plan = SimpleNamespace(pipe_size=2, seq_size=1, model_size=1,
                           describe=lambda: {"pipe": 2, "data": 1})
    model = SimpleNamespace(cfg=SimpleNamespace(num_layers=2))
    kw = dict(batch_split=2, schedule="gpipe")
    if case == "depth":
        plan.pipe_size = 4
    elif case == "schedule":
        kw["schedule"] = "zero_bubble"
    elif case == "seq":
        plan.seq_size = 2
        plan.describe = lambda: {"pipe": 2, "seq": 2}
    elif case == "split":
        kw["batch_split"] = 0
    else:
        model = SimpleNamespace()
    with pytest.raises(Exception) as want:
        jax_pipeline.validate_pipeline_plan(plan, model, **kw)
    with pytest.raises(want.type) as got:
        pipeline.validate_pipeline_plan(plan, model, **kw)
    if case == "seq":
        assert "ROADMAP" in str(got.value)


def _tiny_flax(layers=2):
    cfg = dict(worker.TINY_MODEL, num_layers=layers)
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel

    model = QAModel(EncoderConfig(vocab_size=50, **cfg))
    return model, to_jax_params(model.state_dict())


@pytest.mark.parametrize("K", [2, 4])
def test_stage_param_bytes_matches_jax(K):
    model, tree = _tiny_flax(layers=4)
    want = jax_pipeline.stage_param_bytes(tree, pipe_size=K)
    assert pipeline.stage_param_bytes(tree, pipe_size=K) == want
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert pipeline.stage_param_bytes(pipeline.shape_tree(shapes),
                                      pipe_size=K) == want


def test_zero1_plan_within_a_stage_matches_jax():
    _, tree = _tiny_flax()
    tree["transformer"]["layer_0"]["odd"] = np.zeros(17, np.float32)
    tree["classifier"]["odd"] = np.zeros(17, np.float32)
    state = {"mu": tree, "nu": tree}
    jplan = jax_zero1_plan(state, jax_build_mesh("data:2,pipe:2"),
                           min_size=0, stage_pipe=True)
    plan = zero1_plan(state, data_size=2, min_size=0, pipe_size=2)
    got = jax.tree_util.tree_leaves(plan, is_leaf=lambda x: hasattr(x, "spec"))
    want = jax.tree_util.tree_leaves(jplan,
                                     is_leaf=lambda x: hasattr(x, "spec"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (tuple(g.spec), g.axis, g.padded) == (
            tuple(w.spec) + (None,) * (len(g.spec) - len(tuple(w.spec))),
            w.axis, w.padded)
    assert zero1_state_bytes(state, data_size=2, min_size=0, pipe_size=2) \
        == jax_zero1_state_bytes(state, data_size=2, min_size=0, pipe_size=2)


@pytest.mark.parametrize("K", [2, 4])
def test_schedules_run_every_unit_once_within_the_window(K):
    for m in (1, 2, 4, 8):
        for k in range(K):
            gpipe = pipeline.stage_schedule("gpipe", K, k, m)
            ofob = pipeline.stage_schedule("1f1b", K, k, m)
            for ops in (gpipe, ofob):
                assert sorted(ops) == sorted(
                    [("F", i) for i in range(m)] + [("B", i) for i in range(m)])
                assert all(ops.index(("F", i)) < ops.index(("B", i))
                           for i in range(m))
                # the backwards run in micro-batch order in both
                assert [i for kind, i in ops if kind == "B"] == list(range(m))
            assert pipeline.max_in_flight(gpipe) == m
            assert pipeline.max_in_flight(ofob) <= min(m, 2 * K - 1, K - k)


def _flags(tmp, *extra, world=2):
    vocab = tmp / "vocab.txt"
    if not vocab.exists():
        vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]))
    return get_params((get_trainer_parser, get_model_parser), [
        "-c", str(Path(__file__).resolve().parent.parent / "config"
                  / "test_bert.cfg"), "--vocab_file", str(vocab),
        "--dump_dir", str(tmp / "results"), "--device", "cpu",
        "--model", "bert-tiny", "--dist_world_size", str(world),
        "--local_rank", "0", *extra])[1]


def test_pipe_flag_values_are_checked(tmp_path):
    params, model_params = _flags(tmp_path, "--mesh", "pipe:2")
    for flag, value in (("pipe_schedule", "interleaved"),
                        ("pipe_param_sharding", "rows")):
        setattr(params, flag, value)
        with pytest.raises(ValueError, match=flag):
            check_train_flags(params, model_params)
        setattr(params, flag, "gpipe" if flag == "pipe_schedule" else "auto")
    check_train_flags(params, model_params)


@pytest.mark.parametrize("extra,refused,world", [
    (["--mesh", "pipe:2", "--pipe_schedule", "1f1b",
      "--pipe_param_sharding", "replicated"], False, 2),
    (["--mesh", "pipe:2,seq:2"], True, 4),
    # a model axis beside pipe is ported (tests/test_torch_pipe_model.py)
    (["--mesh", "pipe:2,model:1"], False, 2),
    (["--mesh", "pipe:2,model:2", "--pipe_schedule", "1f1b"], False, 4)],
    ids=["pipe", "pipe_seq", "pipe_model", "model"])
def test_pipe_flags_are_live_and_the_rest_refused(tmp_path, caplog, extra,
                                                  refused, world):
    params, model_params = _flags(tmp_path, *extra, world=world)
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_train_flags(params, model_params)
        return
    with caplog.at_level("INFO"):
        check_train_flags(params, model_params)
    assert "Pipeline (live): --pipe_schedule" in caplog.text
    if "1f1b" in extra:
        assert "--pipe_schedule 1f1b" in caplog.text
    ignored = [r.getMessage() for r in caplog.records
               if "Accepted but not ported" in r.getMessage()]
    assert ignored and "pipe" not in ignored[0]


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


def _jax_trainer(tmp, mesh_spec, batch_split, steps=None, **kw):
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
        batch_split=batch_split, n_jobs=1, warmup_coef=0.0,
        max_grad_norm=worker.MAX_GRAD_NORM, train_weights=weights,
        debug=True, seed=0, hbm_preflight=False,
        on_train_metrics=None if steps is None else (
            lambda meters, step: steps.append(
                {k: float(v) if k == "lr" else float(v())
                 for k, v in meters.items()})), **kw)
    return init, trainer


def _world(mode, out):
    return worker.run_pairs(lambda rank, port: [
        sys.executable, str(WORKER), mode, str(rank), "4", str(port),
        str(out)], ranks=4)


def _check(results):
    for pair in results:
        for rc, err in pair:
            assert rc == 0, err[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    out = tmp / "worlds"
    out.mkdir()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        train = pool.submit(_world, "train", out)
        steps = []
        init, jt = _jax_trainer(tmp / "jax", "data:2,pipe:2", 4, steps,
                                sharded_checkpoint=True)
        jt.train_dataloader = _Regrouped(jt.train_dataloader, 2, 4)
        jt.train()
        jax_params = jax.tree_util.tree_map(np.asarray, jt.params)
        jax_preflight = jt._preflight_pipe_fields()
        jt.debug = False
        jt.save_state_dict(out / "jax_ckpt")
        jax_step = jt.global_step
        _check(train.result())
        resume = pool.submit(_world, "resume", out)
        _, j4 = _jax_trainer(tmp / "jax4", "data:4", 2,
                             optimizer_sharding="zero1", zero_min_size=0)
        j4.load_state_dict(out / "ckpt")
        jax_restored = jax.tree_util.tree_map(np.asarray, j4.params)
        _check(resume.result())

    def load(name):
        return [torch.load(out / f"{name}_rank{r}.pt") for r in range(4)]

    return SimpleNamespace(out=out, load=load, jax_steps=steps, init=init,
                           jax_params=jax_params, jax_step=jax_step,
                           jax_restored=jax_restored,
                           jax_preflight=jax_preflight)


def _whole(records):
    """The whole model from a data row's stages (ranks 0 and 2: data index
    0 of stages 0 and 1)."""
    return {**records[0]["params"], **records[2]["params"]}


def test_gpipe_steps_equal_the_jax_pipe_trainer(runs):
    port, want = runs.load("trained"), runs.jax_steps
    assert len(want) == len(port[0]["values"]) == 2
    for rank in range(4):
        assert port[rank]["values"] == port[0]["values"]
    for step, (got, ref) in enumerate(zip(port[0]["values"], want)):
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")
    got = to_jax_params(_whole(port))
    paths = jax.tree_util.tree_leaves_with_path
    moved = 0
    for (path, a), (_, b), (_, c) in zip(paths(got), paths(runs.jax_params),
                                         paths(runs.init)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=PARAMS_ATOL,
                                   err_msg=str(path))
        moved += not np.array_equal(b, c)
    assert moved > len(paths(got)) // 2
    # the pipelined eval ran after each epoch, the same on every rank
    assert len(port[0]["metrics"]) == 2
    assert all(r["metrics"] == port[0]["metrics"] for r in port)


def test_preflight_reports_the_pipeline_as_the_jax_trainer(runs):
    """The pre-flight report's pipeline fields equal the JAX trainer's on
    the same mesh and weights; its ``param_bytes`` is what the rank stores:
    its stage's bytes in the ownership view."""
    want = runs.jax_preflight
    trained = runs.load("trained")
    for rank in range(4):
        report = torch.load(runs.out / f"preflight_rank{rank}.pt")
        for key in ("pipe_schedule", "pipe_param_layout",
                    "pipe_stage_layers", "pipe_stage_param_bytes"):
            assert report[key] == want[key], key
        assert report["mesh_axes"] == MESH
        stored = sum(p.numel() * p.element_size()
                     for p in trained[rank]["params"].values())
        assert report["param_bytes"] == stored == want[
            "pipe_stage_param_bytes"][rank // 2]


@pytest.mark.parametrize("m", [1, 2, 4])
def test_1f1b_equals_gpipe(runs, m):
    gpipe, ofob = runs.load(f"gpipe{m}"), runs.load(f"1f1b{m}")
    for rank in range(4):
        a, b = gpipe[rank], ofob[rank]
        assert a["values"] == b["values"]
        assert set(a["params"]) == set(b["params"])
        for name in a["params"]:
            assert torch.equal(a["params"][name], b["params"][name]), name
            assert torch.equal(a["grads"][name], b["grads"][name]), name
        # the in-flight window: all m under GPipe, at most min(m, 2K-1)
        # under 1F1B, and fewer than m once m exceeds the stages
        assert a["in_flight"] == m
        assert b["in_flight"] <= min(m, 3)
        if m == 4:
            assert b["in_flight"] < m


def test_pipe_equals_the_one_process_trainer(runs, tmp_path):
    pipe = runs.load("gpipe2")
    oracle = worker.tiny_trainer(tmp_path, dropout=0.0, batch_split=2)
    grads = {}
    import test_torch_pipeline_worker as pw

    clip = pw.capture_clip(oracle, grads)
    try:
        inputs, labels = (regroup_for_world(
            {k: torch.cat([pipe[0]["batches"][0][part][k],
                           pipe[1]["batches"][0][part][k]])
             for k in pipe[0]["batches"][0][part]}, 2, 2)
            for part in (0, 1))
        values = oracle.train_step(inputs, labels)
    finally:
        pw.trainer_module.clip_by_global_norm_ = clip
    for key, ref in values.items():
        np.testing.assert_allclose(pipe[0]["values"][0][key], ref, rtol=1e-5,
                                   err_msg=key)
    got_grads = {**pipe[0]["grads"], **pipe[2]["grads"]}
    assert set(got_grads) == set(grads)
    assert worker.rel_l2(got_grads, grads) < GRAD_REL
    whole = _whole(pipe)
    for name, p in oracle.model.named_parameters():
        np.testing.assert_allclose(whole[name], p.detach(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_stage_layout_equals_replicated_and_stores_its_stage(runs):
    stage, repl = runs.load("gpipe2"), runs.load("replicated")
    names = set(repl[0]["params"])
    for rank in range(4):
        assert stage[rank]["layout"] == "stage"
        assert repl[rank]["layout"] == "replicated"
        # replicated: every rank holds the whole updated model
        assert set(repl[rank]["params"]) == names
        for name in names:
            assert torch.equal(repl[rank]["params"][name],
                               repl[0]["params"][name]), name
    first, last = set(stage[0]["params"]), set(stage[2]["params"])
    assert first | last == names and not first & last
    assert all(n.startswith(("transformer.embeddings", "transformer.layer_0"))
               for n in first)
    assert "classifier.weight" in last and "transformer.layer_1.mlp." \
        "output.weight" in last
    for name, p in _whole(stage).items():
        assert torch.equal(p, repl[0]["params"][name]), name


def test_zero1_equals_off_under_pipe_and_bucketing_is_inert(runs):
    zero1, off = runs.load("zero1"), runs.load("zero1_off")
    for rank in range(4):
        assert zero1[rank]["buckets"] == 0
        assert zero1[rank]["values"] == off[rank]["values"]
        for name, p in off[rank]["params"].items():
            assert torch.equal(zero1[rank]["params"][name], p), name


def test_dropout_draws_are_reproducible_and_schedule_free(runs):
    a, b, c = (runs.load(n) for n in ("drop_a", "drop_b", "drop_1f1b"))
    for rank in range(4):
        assert a[rank]["values"] == b[rank]["values"] == c[rank]["values"]
        for name, p in a[rank]["params"].items():
            assert torch.equal(b[rank]["params"][name], p), name
            assert torch.equal(c[rank]["params"][name], p), name
    losses = [v["loss"] for v in a[0]["values"]]
    assert losses[-1] < losses[0] and len(losses) == 4
    # dropout is live: the dropout-0 step on the same batch differs
    assert a[0]["values"][0]["loss"] != runs.load("gpipe2")[0]["values"][0][
        "loss"]


def test_pipe_save_peeks_as_the_jax_one(runs):
    path = runs.out / "ckpt"
    for peek in (ckpt.peek_checkpoint_layout, jax_peek_layout):
        layout = peek(path)
        assert layout["mesh_axes"] == MESH
        assert layout["pipe_schedule"] == "gpipe"
        assert layout["pipe_param_layout"] == "stage"
        assert layout["opt_sharding"] == "zero1"
        assert layout["shards"] == 4
        assert layout["process_count"] == 4
    jax_layout = jax_peek_layout(runs.out / "jax_ckpt")
    assert jax_layout["pipe_param_layout"] == "stage"
    assert jax_layout["mesh_axes"] == MESH


def test_pipe_save_restores_at_data4_in_both_packages(runs):
    saved = _whole(runs.load("save"))
    data4 = runs.load("data4")
    state = ckpt.read_state(runs.out / "ckpt")
    assert state["global_step"] == 2
    restored = from_jax_params(runs.jax_restored)
    for name, p in saved.items():
        assert torch.equal(from_jax_params(state["model"])[name], p), name
        assert torch.equal(restored[name], p), name
    for rank in range(4):
        assert data4[rank]["restored_step"] == 2
        for name, p in saved.items():
            assert torch.equal(data4[rank]["restored"][name], p), name
        assert np.isfinite(data4[rank]["values"][0]["loss"])
        # the moments crossed too: each data rank's ZeRO-1 slice is a cut
        # of the saved (stage-cut, data-sliced) whole
        assert any(float(m.abs().sum()) > 0
                   for m in data4[rank]["mu"].values())


def test_jax_pipe_save_restores_in_the_port(runs):
    want = from_jax_params(runs.jax_params)
    records = runs.load("jax")
    for rank, record in enumerate(records):
        assert record["restored_step"] == runs.jax_step
        for name, p in record["restored"].items():
            assert torch.equal(p, want[name]), name
        assert np.isfinite(record["values"][0]["loss"])
    assert set(records[0]["restored"]) | set(records[2]["restored"]) \
        == set(want)


def test_gpipe_save_resumes_under_1f1b(runs):
    flip, saved_next = runs.load("flip"), runs.load("saved_next")
    for rank in range(4):
        assert flip[rank]["restored_step"] == 2
        assert flip[rank]["values"] == saved_next[rank]["values"]
        for name, p in saved_next[rank]["params"].items():
            assert torch.equal(flip[rank]["params"][name], p), name
