"""Checkpoints with this slice's state, across the packages, and the async
save (``resilience/checkpoint_async.py``), on the CPU.

- a port checkpoint written with ``async_checkpoint``, carrying AdaMod's
  three moments and the dynamic loss-scale state, resumes in the JAX
  ``Trainer`` (same optimizer and flag), single-file and sharded: every
  parameter, moment, count and the scaling state arrive exactly;
- a JAX checkpoint with the same state resumes in the port, both layouts;
- after ``finish_pending_checkpoint`` the async file is byte for byte a
  sync save of the same state (every file of the sharded directory too);
- the snapshot owns its buffers: a step taken while the write waits does
  not reach the file;
- a persist that fails re-raises at the next barrier as
  ``AsyncCheckpointError`` (once), and a second save waits for the first;
- a restored loss-scale state whose mode differs from the flag keeps the
  flag's, with a warning.
"""

import logging
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import DummyDataset as JaxDummyDataset
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import DummyDataset
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.resilience.checkpoint_async import (
    AsyncCheckpointer,
    AsyncCheckpointError,
)
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train import checkpoint as ckpt
from ml_recipe_tpu_torch.train import loss_scale as ls
from ml_recipe_tpu_torch.train.trainer import Trainer

from helpers import write_vocab

MAX_SEQ_LEN, MAX_Q_LEN = 48, 12
WAIT_S = 30.0


def _tp(**kw):
    base = dict(loss="smooth", smooth_alpha=0.01, focal_alpha=1.0,
                focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                w_end_reg=0.5, w_cls=1, lr=1e-3, weight_decay=0.01,
                warmup_coef=0.3, optimizer="adamod", finetune=False,
                apex_loss_scale="dynamic", best_metric="map", best_order=">")
    base.update(kw)
    return SimpleNamespace(**base)


def _cfg(kind, vocab_size):
    return kind(vocab_size=vocab_size, hidden_size=16, num_layers=2,
                num_heads=2, intermediate_size=32,
                max_position_embeddings=MAX_SEQ_LEN + 2, num_labels=5,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _own_aot_programs(monkeypatch, request):
    """A salt per test: the JAX AOT program store keys a train step by
    shapes and shardings only (test_torch_train_options.py)."""
    monkeypatch.setenv("MLRT_AOT_SALT", request.node.name)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_async")
    vocab = str(write_vocab(tmp))
    jtok, ttok = (JaxTokenizer("bert", vocab, lowercase=True),
                  Tokenizer("bert", vocab, lowercase=True))
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              dataset_len=24)
    jcfg = _cfg(JaxEncoderConfig, len(jtok))
    init = JaxQAModel(jcfg).init(
        jax.random.key(0), np.zeros((1, MAX_SEQ_LEN), np.int32))["params"]
    return SimpleNamespace(
        tmp=tmp, jtok=jtok, ttok=ttok, jcfg=jcfg, mesh=build_mesh("data:1"),
        jds=JaxDummyDataset(tokenizer=jtok, rng=np.random.default_rng(0), **kw),
        tds=DummyDataset(tokenizer=ttok, rng=np.random.default_rng(0), **kw),
        init=jax.tree_util.tree_map(np.asarray, init))


def port_trainer(world, params=None, tp=None, **kw):
    model = QAModel(_cfg(EncoderConfig, len(world.ttok)), dtype=torch.float32,
                    device="cpu")
    model.load_state_dict(from_jax_params(
        world.init if params is None else params), strict=True)
    tp = tp or _tp()
    return Trainer(model, build_loss(tp),
                   make_collate_fun(world.ttok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=tp, train_dataset=world.tds, n_epochs=1,
                   train_batch_size=8, batch_split=2, n_jobs=1,
                   warmup_coef=0.3, max_grad_norm=0.5, seed=0, **kw)


def jax_trainer(world, params=None, **kw):
    params = world.init if params is None else params
    return JaxTrainer(
        model=JaxQAModel(world.jcfg, attention_impl="xla", mesh=world.mesh),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        loss=jax_build_loss(_tp()),
        collate_fun=jax_make_collate(world.jtok, max_seq_len=MAX_SEQ_LEN),
        trainer_params=_tp(), train_dataset=world.jds, mesh=world.mesh,
        n_epochs=1, train_batch_size=8, batch_split=2, n_jobs=1,
        warmup_coef=0.3, max_grad_norm=0.5, seed=0, hbm_preflight=False,
        **kw)


def _same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), path


def _jax_state(jt):
    inner, state = jt._split_ls()
    host = jax.tree_util.tree_map(np.asarray, (jt.params, inner, state))
    return host[0], serialization.to_state_dict(host[1]), host[2]


@pytest.fixture(scope="module")
def trained(world):
    """The port's trainer after 3 steps with AdaMod and dynamic scaling."""
    tt = port_trainer(world, async_checkpoint=True)
    tt.train()
    assert tt.global_step == 3 and tt.optimizer.count == 3
    # a state no fresh trainer has: growth under way, an odd scale
    tt.loss_scale = ls.LossScaleState(2.0 ** 13, 2, True)
    return tt


@pytest.mark.parametrize("sharded", [False, True], ids=["file", "sharded"])
def test_port_async_checkpoint_resumes_in_jax_trainer(world, trained,
                                                      sharded):
    path = world.tmp / f"port_{sharded}.ch"
    trained.sharded_checkpoint = sharded
    trained.save_state_dict(path)
    trained.finish_pending_checkpoint()
    assert "persist" in trained.checkpoint_seconds
    jt = jax_trainer(world)
    jt.load_state_dict(path)
    assert jt.global_step == 3
    params, opt, scale = _jax_state(jt)
    _same_tree(params, to_jax_params(trained.model.state_dict()))
    _same_tree(opt, trained.optimizer.flax_state())
    assert (float(scale.scale), int(scale.growth_count),
            bool(scale.dynamic)) == (2.0 ** 13, 2, True)


@pytest.mark.parametrize("sharded", [False, True], ids=["file", "sharded"])
def test_jax_checkpoint_resumes_in_port_trainer(world, sharded):
    jt = jax_trainer(world, sharded_checkpoint=sharded)
    jt.train()
    path = world.tmp / f"jax_{sharded}.ch"
    jt.save_state_dict(path)
    params, opt, scale = _jax_state(jt)
    other = jax.tree_util.tree_map(lambda x: x * 0 + 0.5, world.init)
    tt = port_trainer(world, other)
    tt.load_state_dict(path)
    assert tt.global_step == jt.global_step == 3
    _same_tree(to_jax_params(tt.model.state_dict()), params)
    _same_tree(tt.optimizer.flax_state(), opt)
    assert tt.optimizer.count == 3
    assert tt.loss_scale == ls.LossScaleState.from_state_dict(
        serialization.to_state_dict(scale))


def _files(path):
    """The bytes of a checkpoint, by its files' names within it."""
    if path.is_dir():
        return {p.name: p.read_bytes() for p in sorted(path.iterdir())}
    return {"": path.read_bytes()}


@pytest.mark.parametrize("sharded", [False, True], ids=["file", "sharded"])
def test_async_file_is_byte_equal_to_a_sync_save(world, trained, sharded):
    trained.sharded_checkpoint = sharded
    a, b = world.tmp / f"async_{sharded}.ch", world.tmp / f"sync_{sharded}.ch"
    trained.save_state_dict(a)
    trained.finish_pending_checkpoint()
    pending, trained._async_ckpt = trained._async_ckpt, None
    try:
        trained.save_state_dict(b)
    finally:
        trained._async_ckpt = pending
    got, want = _files(a), _files(b)
    assert list(got) == list(want) and got == want


def test_the_snapshot_owns_its_buffers(world, monkeypatch):
    """The write waits until a step has changed every parameter in place;
    the file holds the parameters of the save."""
    tt = port_trainer(world, async_checkpoint=True)
    go = threading.Event()
    persist = ckpt.persist_state

    def gated(path, state):
        assert go.wait(WAIT_S)
        persist(path, state)

    monkeypatch.setattr(ckpt, "persist_state", gated)
    want = to_jax_params(tt.model.state_dict(), copy=True)
    path = world.tmp / "owned.ch"
    tt.save_state_dict(path)
    with torch.no_grad():
        for p in tt.model.parameters():
            p.add_(1.0)
    go.set()
    tt.finish_pending_checkpoint()
    _same_tree(ckpt.read_state(path)["model"], want)


def test_a_failing_persist_reraises_at_the_next_barrier(world, monkeypatch,
                                                        caplog):
    tt = port_trainer(world, async_checkpoint=True)

    def broken(path, state):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "persist_state", broken)
    tt.save_state_dict(world.tmp / "broken.ch")
    with pytest.raises(AsyncCheckpointError, match="disk full"):
        tt.finish_pending_checkpoint()
    tt.finish_pending_checkpoint()          # surfaced once, then consumed
    # the best-effort barrier logs the failure instead
    tt.save_state_dict(world.tmp / "broken.ch")
    with caplog.at_level(logging.ERROR):
        tt.finish_pending_checkpoint(raise_errors=False)
    assert "disk full" in caplog.text
    # and the next save's own barrier surfaces an earlier failure
    tt.save_state_dict(world.tmp / "broken.ch")
    with pytest.raises(AsyncCheckpointError):
        tt.save_state_dict(world.tmp / "broken2.ch")


def test_a_second_save_waits_for_the_first():
    saver, events = AsyncCheckpointer(), []
    release = threading.Event()

    def first():
        events.append("first start")
        assert release.wait(WAIT_S)
        events.append("first end")

    def second():
        events.append("second start")

    saver.submit("a", first)
    assert saver.pending()
    timer = threading.Timer(0.2, release.set)
    timer.start()
    t0 = time.perf_counter()
    saver.submit("a", second)        # blocks until the first has landed
    assert time.perf_counter() - t0 >= 0.15
    saver.wait()
    timer.join(WAIT_S)
    assert events == ["first start", "first end", "second start"]
    assert not saver.pending() and saver._thread is None


def test_a_differing_loss_scale_mode_keeps_the_flag(world, trained, caplog):
    path = world.tmp / "mode.ch"
    trained.sharded_checkpoint = False
    trained.save_state_dict(path)
    trained.finish_pending_checkpoint()
    tt = port_trainer(world, tp=_tp(apex_loss_scale=128.0))
    with caplog.at_level(logging.WARNING):
        tt.load_state_dict(path)
    assert "differs from --apex_loss_scale" in caplog.text
    assert tt.loss_scale == ls.init_state(128.0)
    assert tt.optimizer.count == 3
