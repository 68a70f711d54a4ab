"""The port's training path against the JAX package's, on the CPU.

Every input comes from a numpy seed and goes through both packages:

- losses: value and gradient of every head of ``build_loss`` for ``ce``,
  ``smooth`` and ``focal``, ignore-index rows included;
- optimizer: a multi-step trajectory of the ``adam`` chain (warmup, decay
  mask, global-norm clip) on a small parameter tree, and its state layout;
- data: ``DummyDataset`` + ``BucketedDataLoader`` give the same batches
  element for element over two epochs, and the same planned step count;
- trajectory: a tiny JAX ``Trainer`` (mesh ``data:1``, dropout 0 since
  flax's PRNG cannot be reproduced, ``batch_split=2``, clip active, warmup)
  and the port's ``Trainer`` start from the same params and take the same 4
  steps on the same batches: same per-step losses and lr, same end params;
  with ``ln_impl='xla'`` (flax ``nn.LayerNorm``) and ``'fused'`` on both
  sides (the JAX ``_xla_layer_norm`` off the TPU; the port's
  ``FusedLayerNormFn`` over the kernels' plain versions on the CPU);
- checkpoints: port -> JAX and JAX -> port keep params, optimizer state and
  step; ``drop_optimizer`` restores weights only;
- the CLI: ``python -m ml_recipe_tpu_torch.cli.train`` on the CPU takes its
  2 debug steps and exits 0; unported flags raise, ``--ln_impl fused|auto``
  and the packing flags are accepted; an interrupt saves
  ``interrupt.ch``.

Tolerances are f32: both sides compute in float32, in other summation
orders (matmuls, softmax and norm reductions), ~1e-7 relative per op.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from ml_recipe_tpu.data.bucketing import BucketedDataLoader as JaxBucketedLoader
from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import DummyDataset as JaxDummyDataset
from ml_recipe_tpu.data.loader import ShardedBatchSampler as JaxSampler
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.train.optim import build_optimizer as jax_build_optimizer
from ml_recipe_tpu_torch.cli import train as train_cli
from ml_recipe_tpu_torch.config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.data.bucketing import BucketedDataLoader
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import DummyDataset
from ml_recipe_tpu_torch.data.device_prefetch import (
    BatchPlacer,
    DevicePrefetcher,
    resolve_depth,
)
from ml_recipe_tpu_torch.data.loader import DataLoaderWorkerError, ShardedBatchSampler
from ml_recipe_tpu_torch.data.packing import PackedDataLoader
from ml_recipe_tpu_torch.losses import PackedWeightedLoss, build_loss
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train.checkpoint import read_state
from ml_recipe_tpu_torch.train.optim import AdamW, build_optimizer, clip_by_global_norm_
from ml_recipe_tpu_torch.train.trainer import Trainer

from helpers import write_vocab


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One intra-op thread for this module's tiny models (the processes it
    starts get ``OMP_NUM_THREADS=1``): the test workers share the host's
    cores, and more threads a process only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]

# end params after 4 Adam steps at lr 1e-3: an Adam step is ~lr per element
# whatever the gradient's scale, so a gradient element near zero whose last
# bits differ moves its parameter by a few lr*1e-3 more on one side
PARAM_ATOL = 2e-5

MAX_SEQ_LEN, MAX_Q_LEN = 48, 12


def _tp(**kw):
    """A trainer-params namespace (the subset of the trainer flags the loss
    and optimizer read)."""
    base = dict(loss="smooth", smooth_alpha=0.01, focal_alpha=1.0,
                focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                w_end_reg=0.5, w_cls=1, lr=1e-3, weight_decay=0.01,
                warmup_coef=0.3, optimizer="adam", finetune=False,
                best_metric="map", best_order=">")
    base.update(kw)
    return SimpleNamespace(**base)


# -- losses -------------------------------------------------------------------

def _loss_case(kind):
    rng = np.random.default_rng(11)
    n, seq = 6, 10
    preds = {
        "start_class": rng.normal(size=(n, seq)).astype(np.float32) * 3,
        "end_class": rng.normal(size=(n, seq)).astype(np.float32) * 3,
        "start_reg": rng.random(n).astype(np.float32),
        "end_reg": rng.random(n).astype(np.float32),
        "cls": rng.normal(size=(n, 5)).astype(np.float32) * 2,
    }
    ignore = {"ce": -100, "focal": -1, "smooth": -100}[kind]
    targets = {
        "start_class": np.array([0, 3, -1, 9, 2, -1], np.int32),
        "end_class": np.array([1, -1, 4, 9, 2, 5], np.int32),
        "start_reg": rng.random(n).astype(np.float32),
        "end_reg": rng.random(n).astype(np.float32),
        "cls": np.array([0, 4, ignore, 2, 1, 3], np.int32),
    }
    return preds, targets


@pytest.mark.parametrize("kind", ["ce", "smooth", "focal"])
def test_losses_match_jax_values_and_grads(kind):
    tp = _tp(loss=kind)
    preds, targets = _loss_case(kind)
    jloss = jax_build_loss(tp)
    j_total, j_values = jloss({k: jnp.asarray(v) for k, v in preds.items()},
                              {k: jnp.asarray(v) for k, v in targets.items()})
    j_grads = jax.grad(lambda p: jloss(p, {k: jnp.asarray(v) for k, v
                                           in targets.items()})[0])(
        {k: jnp.asarray(v) for k, v in preds.items()})

    t_preds = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, values = build_loss(tp)(
        t_preds, {k: torch.from_numpy(v) for k, v in targets.items()})
    total.backward()
    assert set(values) == set(j_values)
    for key in values:
        np.testing.assert_allclose(float(values[key].detach()), float(j_values[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for key in preds:
        np.testing.assert_allclose(t_preds[key].grad.numpy(),
                                   np.asarray(j_grads[key]), atol=1e-6,
                                   err_msg=key)


# -- optimizer ----------------------------------------------------------------

def _param_tree(rng):
    shapes = {"encoder.dense.weight": (4, 3), "encoder.dense.bias": (4,),
              "encoder.layer_norm.weight": (4,),
              "encoder.layer_norm.bias": (4,),
              "embeddings.word_embeddings.weight": (6, 4)}
    return {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}


def test_optimizer_trajectory_matches_optax_chain():
    rng = np.random.default_rng(5)
    init = _param_tree(rng)
    tp = _tp(lr=1e-2, weight_decay=0.1, warmup_coef=0.3)
    steps, clip = 6, 1.0

    jparams = jax.tree_util.tree_map(
        jnp.asarray, to_jax_params({n: torch.from_numpy(v) for n, v in init.items()}))
    tx, schedule, _ = jax_build_optimizer(tp, jparams, num_training_steps=10,
                                          max_grad_norm=None)
    jstate = tx.init(jparams)

    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = build_optimizer(tp, params, num_training_steps=10)
    assert isinstance(opt, AdamW)
    assert opt.decay == {"encoder.dense.weight": True,
                         "encoder.dense.bias": False,
                         "encoder.layer_norm.weight": False,
                         "encoder.layer_norm.bias": False,
                         "embeddings.word_embeddings.weight": True}

    for step in range(steps):
        grads = {n: (rng.normal(size=v.shape) * 2).astype(np.float32)
                 for n, v in init.items()}
        # JAX: the train step's clip, then the chain
        jg = jax.tree_util.tree_map(
            jnp.asarray, to_jax_params({n: torch.from_numpy(g) for n, g in grads.items()}))
        gnorm = jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(jg)))
        assert float(gnorm) > clip   # the clip is active
        jg = jax.tree_util.tree_map(lambda g: g * (clip / jnp.maximum(gnorm, clip)), jg)
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        tg = {n: torch.from_numpy(g) for n, g in grads.items()}
        norm = clip_by_global_norm_(list(tg.values()), clip)
        np.testing.assert_allclose(float(norm), float(gnorm), rtol=1e-6)
        lr = opt.step(tg)
        assert lr == float(schedule(step))

        got = to_jax_params({n: p.detach() for n, p in params.items()})
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6,
                                       err_msg=f"step {step} {path}")

    # the state in the optax chain's own state-dict layout
    ref = serialization.to_state_dict(jstate)
    mine = opt.flax_state()
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    mine_leaves = jax.tree_util.tree_leaves_with_path(mine)
    assert [p for p, _ in ref_leaves] == [p for p, _ in mine_leaves]
    for (path, a), (_, b) in zip(ref_leaves, mine_leaves):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-6,
                                   err_msg=str(path))
    assert mine["0"]["1"] == {"inner_state": {}} == ref["0"]["1"]


def test_schedule_starts_at_zero_under_warmup_and_refuses_unported():
    params = {"w.weight": torch.nn.Parameter(torch.ones(2, 2))}
    opt = build_optimizer(_tp(warmup_coef=0.5), params, num_training_steps=4)
    assert opt.lr() == 0.0
    assert opt.step({"w.weight": torch.ones(2, 2)}) == 0.0
    assert torch.equal(params["w.weight"].detach(), torch.ones(2, 2))
    assert opt.lr() > 0.0
    # adamod and fine-tune masks are ported (test_torch_train_options.py);
    # an optimizer name neither package has, and a fine-tune without a
    # module, are refused
    with pytest.raises(ValueError, match="--optimizer"):
        build_optimizer(_tp(optimizer="sgd"), params, num_training_steps=4)
    with pytest.raises(AttributeError, match="at least one module"):
        build_optimizer(_tp(finetune=True), params, num_training_steps=4)


# -- data ---------------------------------------------------------------------

def _tokenizers(tmp_path):
    vocab = str(write_vocab(tmp_path))
    return (JaxTokenizer("bert", vocab, lowercase=True),
            Tokenizer("bert", vocab, lowercase=True))


def _datasets(jtok, ttok, n, seed=0):
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              dataset_len=n)
    return (JaxDummyDataset(tokenizer=jtok, rng=np.random.default_rng(seed), **kw),
            DummyDataset(tokenizer=ttok, rng=np.random.default_rng(seed), **kw))


@pytest.mark.parametrize("pad_last", [False, True], ids=["train", "eval"])
def test_bucketed_batches_match_jax(tmp_path, pad_last):
    jtok, ttok = _tokenizers(tmp_path)
    jds, tds = _datasets(jtok, ttok, 44)
    grid = [16, 24, 32, MAX_SEQ_LEN]
    kw = dict(seq_grid=grid, token_budget=8 * MAX_SEQ_LEN, batch_multiple=2,
              n_jobs=2, pad_last=pad_last)
    sampler_kw = dict(shuffle=not pad_last, drop_last=not pad_last,
                      pad_last=pad_last, seed=3)
    jl = JaxBucketedLoader(jds, JaxSampler(44, 8, **sampler_kw),
                           jax_make_collate(jtok, max_seq_len=MAX_SEQ_LEN), **kw)
    tl = BucketedDataLoader(tds, ShardedBatchSampler(44, 8, **sampler_kw),
                            make_collate_fun(ttok, max_seq_len=MAX_SEQ_LEN), **kw)
    assert tl.planned_epoch_steps(1) == jl.planned_epoch_steps(1)
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert (a.seq, a.real_rows, a.rows) == (b.seq, b.real_rows, b.rows)
            for key in a.inputs:
                assert np.array_equal(a.inputs[key], b.inputs[key]), key
            for key in a.labels:
                assert np.array_equal(a.labels[key], b.labels[key]), key


def test_device_prefetch_keeps_order_and_surfaces_worker_errors():
    place = BatchPlacer(torch.device("cpu"))
    batches = [{"inputs": {"x": np.full((2, 3), i, np.int32)}}
               for i in range(7)]
    got = [p.ready()["inputs"]["x"] for p in
           DevicePrefetcher(iter(batches), lambda b: place(b, None), depth=2)]
    assert [int(t[0, 0]) for t in got] == list(range(7))
    assert got[0].dtype == torch.int32

    def source():
        yield batches[0]
        raise OSError("disk gone")

    prefetcher = DevicePrefetcher(source(), lambda b: place(b, None), depth=2)
    it = iter(prefetcher)
    next(it)
    with pytest.raises(DataLoaderWorkerError, match="disk gone"):
        next(it)
    with pytest.raises(RuntimeError, match="single-use"):
        next(iter(prefetcher))
    assert resolve_depth("auto") == 2 and resolve_depth(0) == 0


# -- trajectory and checkpoints ------------------------------------------------

def _tiny_cfg(kind, vocab_size):
    return kind(vocab_size=vocab_size, hidden_size=16, num_layers=2,
                num_heads=2, intermediate_size=32,
                max_position_embeddings=MAX_SEQ_LEN + 2, num_labels=5,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _port_trainer(ttok, tds, params_np, ln_impl="xla", **kw):
    model = QAModel(_tiny_cfg(EncoderConfig, len(ttok)), dtype=torch.float32,
                    device="cpu", ln_impl=ln_impl)
    model.load_state_dict(from_jax_params(params_np), strict=True)
    return Trainer(model, build_loss(_tp()),
                   make_collate_fun(ttok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=_tp(), train_dataset=tds, n_epochs=2,
                   train_batch_size=8, batch_split=2, n_jobs=2,
                   warmup_coef=0.3, max_grad_norm=0.5, seed=0, **kw)


@pytest.fixture(scope="module")
def trained(request, tmp_path_factory):
    """A tiny JAX Trainer and the port's Trainer, 2 epochs x 2 steps each
    from the same params on the same batches; both with the LayerNorm of
    ``request.param`` ('xla' unless parametrised)."""
    ln_impl = getattr(request, "param", "xla")
    tmp = tmp_path_factory.mktemp("traj")
    jtok, ttok = _tokenizers(tmp)
    jds, tds = _datasets(jtok, ttok, 16)
    jcfg = _tiny_cfg(JaxEncoderConfig, len(jtok))
    mesh = build_mesh("data:1")
    init = JaxQAModel(jcfg).init(
        jax.random.key(0), np.zeros((1, MAX_SEQ_LEN), np.int32))["params"]
    init_np = jax.tree_util.tree_map(np.asarray, init)

    j_running, t_running = [], []
    jt = JaxTrainer(
        model=JaxQAModel(jcfg, attention_impl="xla", mesh=mesh,
                         ln_impl=ln_impl), params=init,
        loss=jax_build_loss(_tp()),
        collate_fun=jax_make_collate(jtok, max_seq_len=MAX_SEQ_LEN),
        trainer_params=_tp(), train_dataset=jds, mesh=mesh, n_epochs=2,
        train_batch_size=8, batch_split=2, n_jobs=2, warmup_coef=0.3,
        max_grad_norm=0.5, seed=0, hbm_preflight=False,
        on_train_metrics=lambda m, step: j_running.append(
            (step, m["loss"](), float(m["lr"]))))
    jt.train()
    tt = _port_trainer(ttok, tds, init_np, ln_impl=ln_impl,
                       on_train_metrics=lambda m, step: t_running.append(
                           (step, m["loss"](), float(m["lr"]))))
    tt.train()
    return SimpleNamespace(
        jt=jt, tt=tt, jtok=jtok, ttok=ttok, jds=jds, tds=tds, tmp=tmp,
        j_running=j_running, t_running=t_running,
        j_params=jax.tree_util.tree_map(np.asarray, jt.params),
        j_state=serialization.to_state_dict(
            jax.tree_util.tree_map(np.asarray, jt.opt_state)),
        t_params=to_jax_params(tt.model.state_dict()),
        t_state=tt.optimizer.flax_state(), init=init_np)


@pytest.mark.parametrize("trained", ["xla", "fused"], indirect=True)
def test_trajectory_matches_jax_trainer(trained):
    j, t = trained.j_running, trained.t_running
    assert len(j) == len(t) == 4 == len(trained.tt.history)
    assert [s for s, _, _ in j] == [s for s, _, _ in t] == [0, 1, 2, 3]
    # per-step running means of the loss (the meters reset each epoch)
    np.testing.assert_allclose([l for _, l, _ in t], [l for _, l, _ in j],
                               rtol=1e-5)
    # the applied lr: schedule(step) read before the step, 0 at step 0
    assert [r for _, _, r in t] == [r for _, _, r in j]
    assert t[0][2] == 0.0 and t[1][2] > 0.0
    assert trained.tt.global_step == trained.jt.global_step == 4
    # the clip was active
    assert trained.tt.max_grad_norm == 0.5
    jl = jax.tree_util.tree_leaves_with_path(trained.j_params)
    tl = jax.tree_util.tree_leaves_with_path(trained.t_params)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    moved = 0
    for (path, a), (_, b), (_, c) in zip(
            jl, tl, jax.tree_util.tree_leaves_with_path(trained.init)):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, err_msg=str(path))
        moved += not np.array_equal(a, c)
    assert moved > len(jl) // 2
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(trained.j_state),
            jax.tree_util.tree_leaves_with_path(trained.t_state)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5,
                                   rtol=1e-3, err_msg=str(path))


def _assert_same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


def test_port_checkpoint_resumes_in_jax_trainer(trained):
    path = trained.tmp / "port.ch"
    trained.tt.save_state_dict(path)
    state = read_state(path)
    assert state["global_step"] == 4 and state["opt_sharding"] == "off"
    jt = trained.jt
    jt.load_state_dict(path)
    assert jt.global_step == 4
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, jt.params),
                      to_jax_params(trained.tt.model.state_dict()))
    _assert_same_tree(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jt.opt_state)),
        trained.tt.optimizer.flax_state())


@pytest.mark.parametrize("drop_optimizer", [False, True])
def test_jax_checkpoint_resumes_in_port_trainer(trained, drop_optimizer):
    path = trained.tmp / "jax.ch"
    trained.jt.save_state_dict(path)
    other = jax.tree_util.tree_map(lambda x: x * 0 + 0.5, trained.init)
    fresh = _port_trainer(trained.ttok, trained.tds, other,
                          drop_optimizer=drop_optimizer)
    fresh.load_state_dict(path)
    assert fresh.global_step == trained.jt.global_step
    _assert_same_tree(to_jax_params(fresh.model.state_dict()),
                      jax.tree_util.tree_map(np.asarray, trained.jt.params))
    if drop_optimizer:
        assert fresh.optimizer.count == fresh.optimizer.schedule_count == 0
        assert all(not m.any() for m in fresh.optimizer.mu.values())
    else:
        _assert_same_tree(fresh.optimizer.flax_state(),
                          serialization.to_state_dict(jax.tree_util.tree_map(
                              np.asarray, trained.jt.opt_state)))


def test_step_generators_are_a_function_of_seed_and_step():
    dev = torch.device("cpu")
    draw = lambda gens: [torch.rand(3, generator=g) for g in gens]
    from ml_recipe_tpu_torch.train.trainer import step_generators

    a, b = draw(step_generators(0, 5, 2, dev)), draw(step_generators(0, 5, 2, dev))
    c = draw(step_generators(0, 6, 2, dev))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


# -- the CLI ------------------------------------------------------------------

def _cli_args(tmp_path, *extra):
    vocab = write_vocab(tmp_path)
    return ["--model", "bert-tiny", "--device", "cpu", "--debug",
            "--dummy_dataset", "--vocab_file", str(vocab),
            "--dump_dir", str(tmp_path / "results"), "--max_seq_len", "32",
            "--max_question_len", "8", "--train_batch_size", "8",
            "--test_batch_size", "4", "--batch_split", "2", "--n_jobs", "2",
            "--seed", "0", "--length_buckets", "auto",
            "--device_prefetch", "2", *extra]


def test_cli_trains_two_debug_steps_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train",
         *_cli_args(tmp_path)],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stderr.count("Training was interrupted because of debug mode") == 2
    assert res.stderr.count("Test metrics after epoch") == 2
    exp = tmp_path / "results" / "test"
    assert (exp / "trainer.cfg").exists() and (exp / "model.cfg").exists()
    assert not (exp / "last.ch").exists()   # debug skips checkpoint writes


@pytest.mark.parametrize("flag,refused", [
    # the data, seq, pipe and model axes are ported
    # (tests/test_torch_sp_train.py, tests/test_torch_pipeline.py,
    # tests/test_torch_tensor_parallel.py); model beside seq is not
    (["--mesh", "seq:2,model:2"], True),
    # ZeRO-1 across processes and its bucketed overlap are ported
    # (tests/test_torch_zero1.py, tests/test_torch_zero1_overlap.py)
    (["--dist_world_size", "2", "--local_rank", "0", "--optimizer_sharding",
      "zero1", "--zero1_overlap", "bucketed"], False),
    # async checkpoints, loss scaling, adamod and fine-tune are ported
    # (test_torch_train_options.py), and so are the runtime subsystems
    # (test_torch_observability.py, test_torch_resilience.py), the elastic
    # supervisor among them (test_torch_elastic.py)
    (["--elastic", "on"], False),
    (["--elastic", "on", "--supervise", "--goodput_ledger"], False),
    (["--mesh", "pipe:1"], False), (["--zero1_overlap", "bucketed"], False),
])
def test_unported_train_flags_raise(tmp_path, flag, refused):
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), _cli_args(tmp_path, *flag))
    if not refused:
        check_train_flags(params, model_params)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_train_flags(params, model_params)


@pytest.mark.parametrize("flag,splitting,segments,min_fragment", [
    (["--sequence_packing", "on"], "off", 8, 32),
    (["--sequence_packing", "on", "--pack_splitting", "fill",
      "--pack_max_segments", "3", "--pack_min_fragment", "4"], "fill", 3, 4),
], ids=["packing", "splitting"])
def test_packing_train_flags_are_accepted_and_act(tmp_path, flag, splitting,
                                                  segments, min_fragment):
    """Sequence packing is ported: the flags pass the check and build packed
    train and test loaders (superseding --length_buckets auto) with the
    values given, and the packed loss."""
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), _cli_args(tmp_path, *flag))
    check_train_flags(params, model_params)
    trainer = train_cli.build_trainer(params, model_params)
    train, test = trainer.train_dataloader, trainer.test_dataloader
    for loader in (train, test):
        assert isinstance(loader, PackedDataLoader)
        assert (loader.splitting, loader.max_segments, loader.min_fragment,
                loader.max_seq_len) == (splitting, segments, min_fragment, 32)
    assert not train.pad_last and test.pad_last
    assert isinstance(trainer.loss, PackedWeightedLoss)
    batch = next(iter(train))
    assert batch.inputs["segment_starts"].shape == (8, segments)
    assert batch.labels["segment_mask"].shape == (8, segments)


@pytest.mark.parametrize("ln_impl", ["fused", "auto"])
def test_fused_layer_norm_flag_is_accepted(tmp_path, ln_impl):
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        # '=': the args hold another 'auto' (--length_buckets), and
        # get_params would read a shared value token as an unknown argument
        _cli_args(tmp_path, f"--ln_impl={ln_impl}"))
    check_train_flags(params, model_params)
    trainer = train_cli.build_trainer(params, model_params)
    assert trainer.model.ln_impl == ln_impl


def test_unknown_ln_impl_values_raise(tmp_path):
    with pytest.raises(SystemExit):
        get_params((get_trainer_parser, get_model_parser),
                   _cli_args(tmp_path, "--ln_impl", "bogus"))
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        _cli_args(tmp_path, "--ln_impl", "interpret"))
    with pytest.raises(ValueError, match="interpret"):
        check_train_flags(params, model_params)


def test_world_size_from_the_environment_raises(tmp_path, monkeypatch):
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), _cli_args(tmp_path))
    check_train_flags(params, model_params)   # the defaults are accepted
    # the world comes from the flags: a launcher's WORLD_SIZE they do not
    # repeat is refused, not run as one process
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="WORLD_SIZE=4"):
        check_train_flags(params, model_params)


def test_interrupt_saves_interrupt_checkpoint(tmp_path, monkeypatch):
    args = [a for a in _cli_args(tmp_path) if a != "--debug"]
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), args)
    trainer = train_cli.build_trainer(params, model_params)

    def interrupted(after_epoch_funcs=None):
        raise KeyboardInterrupt("signal 15")

    monkeypatch.setattr(trainer, "train", interrupted)
    train_cli.train(trainer, params)
    state = read_state(tmp_path / "results" / "test" / "interrupt.ch")
    assert state["global_step"] == 0 and state["optimizer"] is not None
