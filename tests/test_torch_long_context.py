"""Long-context training in the PyTorch port against the JAX package, on the CPU.

Every input comes from a numpy seed and goes through both packages:

- the blocked regime (``_blocked_fwd_kernel`` / ``_blocked_bwd_kernel``, run
  in Pallas interpret mode through ``flash_attention`` as tests/test_ops.py
  runs it) at L = 640 and 768, against the port's plain versions and its
  autograd Function: key masks with padding and segments, dropout with the
  same int32 seed, f32 and bf16, forward, lse and dq/dk/dv through
  ``jax.vjp``;
- the streaming regime (``_stream_forward`` / ``_stream_backward``) with
  non-zero bases, ``L_hash`` past L and ``seg_split`` ids;
- the dispatcher at L = 768, remat (gradients equal with and without it
  under dropout), the trainer against the JAX ``Trainer`` past 512 with
  remat on both sides, sharded checkpoints in both directions, and
  ``config/long_context.cfg`` through the parsers and the CLI.

Tolerances: f32 on both sides is one formula in two summation orders
(~1e-7 relative per op). bf16 on both sides starts from the same bf16
inputs, computes in f32 and rounds the probabilities, ds and the outputs to
bf16 at the same points, so a result a hair from a rounding boundary rounds
either way: one bf16 step (8 significant bits) at its size, held to two at
the largest reference value.
"""

import math
from pathlib import Path
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
from ml_recipe_tpu.ops.flash_attention import _fwd as jax_flash_fwd
from ml_recipe_tpu.ops.flash_attention import flash_attention
from ml_recipe_tpu.ops.flash_streaming import _stream_backward, _stream_forward
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.train.checkpoint import (
    load_state_dict_sharded,
    peek_checkpoint_layout,
    save_state_dict_sharded,
)
from ml_recipe_tpu_torch.cli import train as train_cli
from ml_recipe_tpu_torch.config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import DummyDataset
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    init_weights,
    resolve_model_config,
    to_jax_params,
)
from ml_recipe_tpu_torch.models import encoder as port_encoder
from ml_recipe_tpu_torch.ops import flash_attention as fa
from ml_recipe_tpu_torch.ops.attention import dot_product_attention
from ml_recipe_tpu_torch.ops.flash_streaming import streaming_attention
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train.checkpoint import (
    MANIFEST,
    TornCheckpointError,
    read_state,
)
from ml_recipe_tpu_torch.train.trainer import Trainer, step_generators

from helpers import write_vocab

REPO = Path(__file__).resolve().parents[1]

F32_ATOL = 1e-5
BF16_STEPS = 2
# the trainer trajectories: both sides in f32, as tests/test_torch_train.py
PARAM_ATOL = 2e-5

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _limit(ref: np.ndarray, tname: str) -> float:
    if tname == "f32":
        return F32_ATOL
    top = float(np.abs(ref).max())
    return BF16_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def _assert_close(got, ref, tname, what):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got - ref).max())
    assert err <= _limit(ref, tname), (what, err, _limit(ref, tname))


def _segments(rng, B, L, pad):
    """Three packed segments per row, then ``pad`` padding tokens (id 0)."""
    ids = np.zeros((B, L), np.int32)
    for b in range(B):
        c1, c2 = np.sort(rng.choice(np.arange(1, L - pad), 2, replace=False))
        ids[b, :c1], ids[b, c1:c2], ids[b, c2:L - pad] = 1, 2, 3
    return ids


def _qkvg(rng, B, L, H, D):
    return [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(4)]


# -- the blocked regime ---------------------------------------------------------

# each length in each dtype, each mask kind at each length
@pytest.mark.parametrize("L,tname,segmented", [
    (640, "f32", False), (640, "bf16", True),
    (768, "f32", True), (768, "bf16", False)])
def test_blocked_regime_matches_pallas(L, tname, segmented):
    """Forward, lse and dq/dk/dv with dropout 0.1 against the interpret-
    mode q-blocked kernels: the JAX forward's residual lse, ``jax.vjp``
    through ``flash_attention`` and torch autograd through
    ``FusedAttention``."""
    B, H, D, rate = 2, 2, 32, 0.1
    rng = np.random.default_rng(L + segmented)
    q, k, v, g = _qkvg(rng, B, L, H, D)
    if segmented:
        mask = _segments(rng, B, L, pad=24)
    else:
        mask = (rng.random((B, L)) > 0.3).astype(np.int32)
        mask[:, 0] = 1
        mask[:, -24:] = 0                      # trailing padding
    seed = np.array([-1234567], np.int32)
    tdt, jdt = DTYPES[tname]
    J = [jnp.asarray(x, jdt) for x in (q, k, v, g)]

    out_j, res = jax_flash_fwd(*J[:3], jnp.asarray(mask), jnp.asarray(seed),
                               jdt, rate, True, segmented)
    lse_j = res[-1]
    assert lse_j is not None   # the blocked forward saved its lse

    def f(q_, k_, v_):
        return flash_attention(q_, k_, v_, jnp.asarray(mask),
                               seed=jnp.asarray(seed), dtype=jdt, rate=rate,
                               interpret=True, segmented=segmented)

    _, vjp = jax.vjp(f, *J[:3])
    grads_j = vjp(J[3])

    T = [torch.from_numpy(x).to(tdt) for x in (q, k, v, g)]
    x = [t.clone().requires_grad_() for t in T[:3]]
    out = fa.fused_attention(*x, torch.from_numpy(mask),
                             seed=torch.from_numpy(seed), rate=rate,
                             segmented=segmented)
    grads = torch.autograd.grad(out, x, T[3])
    _, lse = fa.fused_attention_plain(
        *T[:3], torch.from_numpy(mask),
        fa.row_seeds(torch.from_numpy(seed), B, H), rate, segmented,
        want_lse=True)

    assert out.dtype == tdt
    _assert_close(out, out_j, tname, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=F32_ATOL,
                               rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_j):
        _assert_close(a, b, tname, name)


# -- the streaming regime -------------------------------------------------------

@pytest.mark.parametrize("tname", ["f32", "bf16"])
@pytest.mark.parametrize("seg_split", [False, True], ids=["mask", "seg_split"])
def test_streaming_contract_matches_pallas(tname, seg_split):
    """``_stream_forward`` / ``_stream_backward`` on a block at rows
    512.., columns 768.. of a 4096-long sequence, dropout 0.1: the port's
    plain versions with the same ``base``, ``L_hash`` and (segmented)
    ``seg_split`` ids, and ``streaming_attention``'s gradients."""
    B, L, H, D, rate, blk = 2, 256, 2, 32, 0.1, 128
    base, L_hash = (512, 768), 4096
    rng = np.random.default_rng(5 + seg_split)
    q, k, v, g = _qkvg(rng, B, L, H, D)
    if seg_split:   # the visiting K/V block's ids differ from the q block's
        mask = np.concatenate([_segments(rng, B, L, pad=16),
                               _segments(rng, B, L, pad=40)], axis=1)
    else:
        mask = (rng.random((B, L)) > 0.3).astype(np.int32)
    seed = np.array([99, -2 ** 31], np.int32)   # a [B] vector
    tdt, jdt = DTYPES[tname]
    J = [jnp.asarray(x, jdt) for x in (q, k, v, g)]
    jkw = dict(seg=seg_split, base=jnp.asarray(base, jnp.int32),
               L_hash=L_hash, seg_split=seg_split)
    out_j, lse_j = _stream_forward(*J[:3], jnp.asarray(mask),
                                   jnp.asarray(seed), blk, 1, jdt, rate,
                                   True, **jkw)
    grads_j = _stream_backward(*J[:3], jnp.asarray(mask), jnp.asarray(seed),
                               J[3], out_j, lse_j, blk, 1, jdt, rate, True,
                               **jkw)

    T = [torch.from_numpy(x).to(tdt) for x in (q, k, v, g)]
    tmask, tseed = torch.from_numpy(mask), torch.from_numpy(seed)
    kw = dict(segmented=seg_split, base=base, L_hash=L_hash,
              seg_split=seg_split)
    out, lse = fa.fused_attention_plain(*T[:3], tmask,
                                        fa.row_seeds(tseed, B, H), rate,
                                        want_lse=True, **kw)
    _assert_close(out, out_j, tname, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=F32_ATOL,
                               rtol=0)
    # the plain backward on the JAX forward's own residuals
    plain = fa.fused_attention_bwd_plain(
        *T, torch.from_numpy(np.array(out_j, np.float32)).to(tdt),
        torch.from_numpy(np.array(lse_j)), tmask, fa.row_seeds(tseed, B, H),
        rate, **kw)
    x = [t.clone().requires_grad_() for t in T[:3]]
    grads = torch.autograd.grad(
        streaming_attention(*x, tmask, seed=tseed, rate=rate, **kw), x, T[3])
    for name, a, b, c in zip(("dq", "dk", "dv"), plain, grads, grads_j):
        _assert_close(a, c, tname, name)
        _assert_close(b, c, tname, name)


def test_streaming_contract_defaults_are_the_single_chip_call():
    """Bases (0, 0) and L_hash = L are the call without the contract; other
    bases draw another dropout mask; seg_split ids equal to the plain ids
    twice over give the segmented call."""
    rng = np.random.default_rng(3)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvg(rng, 1, 64, 2, 8))
    ids = torch.from_numpy(_segments(rng, 1, 64, pad=8))
    ref = fa.fused_attention(q, k, v, ids, seed=7, rate=0.2, segmented=True)
    same = streaming_attention(q, k, v, ids, seed=7, rate=0.2, segmented=True,
                               base=(0, 0), L_hash=64)
    split = streaming_attention(q, k, v, torch.cat([ids, ids], 1), seed=7,
                                rate=0.2, segmented=True, seg_split=True)
    moved = streaming_attention(q, k, v, ids, seed=7, rate=0.2,
                                segmented=True, base=(64, 0), L_hash=128)
    assert torch.equal(ref, same) and torch.equal(ref, split)
    assert not torch.allclose(ref, moved)
    with pytest.raises(ValueError, match="segmented"):
        streaming_attention(q, k, v, torch.cat([ids, ids], 1), seg_split=True)
    with pytest.raises(ValueError, match="2L"):
        streaming_attention(q, k, v, ids, segmented=True, seg_split=True)


def test_uniform_grid_offsets_wrap_as_int32():
    """The hash index (row_base + row) * L_hash + col wraps in 32 bits as
    JAX's int32 arithmetic does, at offsets past 2**31 / L_hash."""
    from ml_recipe_tpu.ops.flash_attention import _uniform_grid

    seeds = fa.row_seeds(torch.tensor([5]), 1, 2)
    grid = fa.uniform_grid(seeds, 2, 16, row_offset=70000, col_offset=123,
                           L_hash=65536)
    for h in range(2):
        ref = _uniform_grid(jnp.int32(5), jnp.int32(h), 65536, rows=16,
                            row_offset=70000, cols=16, col_offset=123)
        assert np.array_equal(grid[0, h].numpy(), np.asarray(ref))


# -- the dispatcher ---------------------------------------------------------------

@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
def test_dispatcher_runs_every_length_on_cpu(segmented):
    """``auto`` at L = 768 (the TPU's blocked regime), and at 200 and 1000
    (no TPU kernel geometry, below and past 512: the JAX package falls back
    to XLA attention there) run the kernel pair's plain version on the CPU,
    dropout included, and launch nothing."""
    rng = np.random.default_rng(11)
    for L in (200, 768, 1000):
        q, k, v, _ = (torch.from_numpy(x) for x in _qkvg(rng, 1, L, 2, 32))
        ids = torch.from_numpy(_segments(rng, 1, L, pad=10))
        kw = (dict(segment_ids=ids) if segmented
              else dict(mask=(ids > 0).int()))
        seeds = fa.row_seeds(torch.tensor([3]), 1, 2)
        before = fa.KERNEL.launches
        out = dot_product_attention(q, k, v, dropout_rate=0.1,
                                    seed=torch.tensor([3], dtype=torch.int32),
                                    **kw)
        ref = fa.fused_attention_plain(q, k, v, ids if segmented else
                                       (ids > 0).int(), seeds, 0.1, segmented)
        assert fa.KERNEL.launches == before
        assert torch.equal(out, ref)


# -- remat ------------------------------------------------------------------------

def _dropout_cfg(**kw):
    base = dict(vocab_size=60, hidden_size=16, num_layers=2, num_heads=2,
                intermediate_size=32, max_position_embeddings=640,
                num_labels=5, hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1)
    base.update(kw)
    return EncoderConfig(**base)


def _grads(model, ids, gen):
    for p in model.parameters():
        p.grad = None
    out = model(ids, generator=gen)
    sum(v.float().square().mean() for v in out.values()).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_gradients_equal_plain_under_dropout(monkeypatch):
    """Hidden and attention dropout on, the same step generators: remat
    gives the gradients of the plain forward exactly and leaves the
    generator where the plain forward does, while each layer's attention
    forward runs twice (forward and recompute). A ``checkpoint`` wrap that
    does not replay the generator (the naive one) draws other masks in the
    recompute and gets other gradients."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, 60, (2, 600)))
    model = QAModel(_dropout_cfg(), device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    model.train()
    calls = []
    plain_fwd = fa.fused_attention_plain
    monkeypatch.setattr(fa, "fused_attention_plain",
                        lambda *a, **k: calls.append(1) or plain_fwd(*a, **k))

    def run(remat):
        model.transformer.remat = remat
        calls.clear()
        gen = step_generators(0, 3, 1, torch.device("cpu"))[0]
        grads = _grads(model, ids, gen)
        return grads, gen.get_state(), len(calls)

    ref, ref_state, ref_calls = run(False)
    got, state, n_calls = run(True)
    assert ref_calls == 2 and n_calls == 4    # 2 layers, x2 with remat
    assert torch.equal(state, ref_state)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name

    from torch.utils.checkpoint import checkpoint

    monkeypatch.setattr(port_encoder, "remat_layer",
                        lambda layer, h, m, g, rows=None:
                        checkpoint(layer, h, m, g, rows, use_reentrant=False))
    naive, _, _ = run(True)
    worst = max((naive[n] - ref[n]).abs().max().item() for n in ref)
    assert worst > 1e-3


def test_remat_is_off_without_grad_and_in_eval():
    model = QAModel(_dropout_cfg(), device="cpu", remat=True)
    init_weights(model, torch.Generator().manual_seed(1))
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 60, (1, 520)))
    with torch.inference_mode():
        a = model.eval()(ids)
    model.transformer.remat = False
    with torch.inference_mode():
        b = model(ids)
    assert all(torch.equal(a[k], b[k]) for k in a)


# -- the trainer past 512 against the JAX trainer -----------------------------------

MAX_SEQ_LEN, MAX_Q_LEN = 640, 12


def _tiny_cfg(kind, vocab_size):
    return kind(vocab_size=vocab_size, hidden_size=16, num_layers=2,
                num_heads=2, intermediate_size=32,
                max_position_embeddings=MAX_SEQ_LEN, num_labels=5,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _tp():
    return SimpleNamespace(
        loss="smooth", smooth_alpha=0.01, focal_alpha=1.0, focal_gamma=2.0,
        w_start=1, w_end=1, w_start_reg=0.5, w_end_reg=0.5, w_cls=1, lr=1e-3,
        weight_decay=0.01, warmup_coef=0.3, optimizer="adam", finetune=False,
        best_metric="map", best_order=">")


def _port_trainer(ttok, tds, params_np, **kw):
    model = QAModel(_tiny_cfg(EncoderConfig, len(ttok)), dtype=torch.float32,
                    device="cpu", remat=True)
    model.load_state_dict(from_jax_params(params_np), strict=True)
    return Trainer(model, build_loss(_tp()),
                   make_collate_fun(ttok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=_tp(), train_dataset=tds, n_epochs=1,
                   train_batch_size=4, batch_split=2, n_jobs=2,
                   warmup_coef=0.3, max_grad_norm=0.5, seed=0,
                   length_buckets="auto", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny JAX Trainer and the port's Trainer, remat on both, 2 steps of
    2 micro-batches of 2 x 640 (the top bucket of the auto grid) from the
    same params on the same batches."""
    tmp = tmp_path_factory.mktemp("long")
    vocab = str(write_vocab(tmp))
    jtok = JaxTokenizer("bert", vocab, lowercase=True)
    ttok = Tokenizer("bert", vocab, lowercase=True)
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              dataset_len=8)
    jds = JaxDummyDataset(tokenizer=jtok, rng=np.random.default_rng(0), **kw)
    tds = DummyDataset(tokenizer=ttok, rng=np.random.default_rng(0), **kw)
    jcfg = _tiny_cfg(JaxEncoderConfig, len(jtok))
    mesh = build_mesh("data:1")
    init = JaxQAModel(jcfg).init(
        jax.random.key(0), np.zeros((1, MAX_SEQ_LEN), np.int32))["params"]
    init_np = jax.tree_util.tree_map(np.asarray, init)

    j_losses, t_losses = [], []
    jt = JaxTrainer(
        model=JaxQAModel(jcfg, attention_impl="xla", mesh=mesh, remat=True),
        params=init, loss=jax_build_loss(_tp()),
        collate_fun=jax_make_collate(jtok, max_seq_len=MAX_SEQ_LEN),
        trainer_params=_tp(), train_dataset=jds, mesh=mesh, n_epochs=1,
        train_batch_size=4, batch_split=2, n_jobs=2, warmup_coef=0.3,
        max_grad_norm=0.5, seed=0, hbm_preflight=False, length_buckets="auto",
        on_train_metrics=lambda m, step: j_losses.append(m["loss"]()))
    jt.train()
    tt = _port_trainer(ttok, tds, init_np, on_train_metrics=lambda m, step:
                       t_losses.append(m["loss"]()))
    tt.train()
    return SimpleNamespace(jt=jt, tt=tt, ttok=ttok, tds=tds, tmp=tmp,
                           init=init_np, j_losses=j_losses,
                           t_losses=t_losses)


def test_trajectory_past_512_matches_jax_trainer(trained):
    assert len(trained.j_losses) == len(trained.t_losses) == 2
    np.testing.assert_allclose(trained.t_losses, trained.j_losses, rtol=1e-5)
    assert trained.tt.global_step == trained.jt.global_step == 2
    assert all(h["rows"] == 4 for h in trained.tt.history)
    # every batch ran at the 640 bucket: past the TPU's fused regime
    assert trained.tt._seq_grid[-1] == MAX_SEQ_LEN
    j_params = jax.tree_util.tree_map(np.asarray, trained.jt.params)
    t_params = to_jax_params(trained.tt.model.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(j_params),
                                 jax.tree_util.tree_leaves_with_path(t_params)):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, err_msg=str(path))


def _assert_same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


# -- sharded checkpoints ------------------------------------------------------------

def test_port_sharded_checkpoint_restores_in_jax(trained):
    trained.tt.sharded_checkpoint = True
    path = trained.tmp / "port_sharded.ch"
    trained.tt.save_state_dict(path)
    assert (path / MANIFEST).exists() and (path / "shard-00000.msgpack").exists()
    layout = peek_checkpoint_layout(path)
    assert layout["format"] == "sharded" and layout["global_step"] == 2
    assert layout["shards"] == 1 and layout["opt_sharding"] == "off"
    assert layout["mesh_axes"] == {"data": 1}
    jt = trained.jt
    params, opt_state, _, step = load_state_dict_sharded(
        path, params=jt.params, opt_state=jt.opt_state)
    assert step == 2
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, params),
                      to_jax_params(trained.tt.model.state_dict()))
    _assert_same_tree(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, opt_state)),
        trained.tt.optimizer.flax_state())
    # a second save swaps the directory in place
    trained.tt.save_state_dict(path)
    assert read_state(path)["global_step"] == 2
    assert not (trained.tmp / "port_sharded.ch.old").exists()


@pytest.mark.parametrize("drop_optimizer", [False, True])
def test_jax_sharded_checkpoint_resumes_in_port_trainer(trained,
                                                        drop_optimizer):
    path = trained.tmp / f"jax_sharded_{drop_optimizer}.ch"
    jt = trained.jt
    save_state_dict_sharded(path, params=jt.params, opt_state=jt.opt_state,
                            global_step=jt.global_step)
    other = jax.tree_util.tree_map(lambda x: x * 0 + 0.5, trained.init)
    fresh = _port_trainer(trained.ttok, trained.tds, other,
                          drop_optimizer=drop_optimizer)
    fresh.load_state_dict(path)
    assert fresh.global_step == 2
    _assert_same_tree(to_jax_params(fresh.model.state_dict()),
                      jax.tree_util.tree_map(np.asarray, jt.params))
    if drop_optimizer:
        assert fresh.optimizer.count == 0
    else:
        _assert_same_tree(fresh.optimizer.flax_state(),
                          serialization.to_state_dict(
                              jax.tree_util.tree_map(np.asarray, jt.opt_state)))


def test_sharded_checkpoint_checks_and_swap(trained, caplog):
    """A flipped byte fails its piece crc (the load is skipped with a
    warning, as the JAX reader does); a save interrupted between its two
    renames rolls forward on the next load."""
    tt = trained.tt
    tt.sharded_checkpoint = True
    path = trained.tmp / "checked.ch"
    tt.save_state_dict(path)
    shard = path / "shard-00000.msgpack"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises(TornCheckpointError, match="crc32"):
        read_state(path)
    step = tt.global_step
    tt.global_step = 0
    tt.load_state_dict(path)
    assert tt.global_step == 0 and "was not loaded" in caplog.text

    tt.global_step = step
    tt.save_state_dict(path)               # a good save over the bad one
    path.rename(trained.tmp / "checked.ch.saving")   # died mid-swap
    tt.global_step = 0
    tt.load_state_dict(path)
    assert tt.global_step == step and (path / MANIFEST).exists()


# -- config and CLI -------------------------------------------------------------

def test_long_context_cfg_passes_the_port_parsers(tmp_path):
    vocab = str(write_vocab(tmp_path))
    base = ["-c", str(REPO / "config" / "long_context.cfg"), "--dummy_dataset",
            "--vocab_file", vocab, "--dump_dir", str(tmp_path)]
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), base)
    check_train_flags(params, model_params)
    assert (params.max_seq_len, params.train_batch_size, params.batch_split,
            params.test_batch_size) == (1024, 128, 4, 16)
    assert params.shard_optimizer and params.sharded_checkpoint
    assert resolve_model_config(model_params).max_position_embeddings == 1024
    # the cfg's documented single-chip variant
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        base + ["--max_seq_len=4096", "--max_position_embeddings=4096",
                "--remat"])
    check_train_flags(params, model_params)
    assert params.max_seq_len == 4096 and model_params.remat
    assert resolve_model_config(model_params).max_position_embeddings == 4096


def test_long_buckets_and_collate(tmp_path):
    """``length_buckets=auto`` at 1024 and 4096 gives the grids whose top
    buckets are the TPU's blocked (768, 1024) and streaming (3072, 4096)
    regimes, and dummy items collate to full-length rows there."""
    from ml_recipe_tpu_torch.data.bucketing import parse_length_buckets

    assert parse_length_buckets("auto", 1024) == [256, 512, 768, 1024]
    assert parse_length_buckets("auto", 4096) == [1024, 2048, 3072, 4096]
    tok = Tokenizer("bert", str(write_vocab(tmp_path)), lowercase=True)
    for L in (768, 4096):
        ds = DummyDataset(tokenizer=tok, rng=np.random.default_rng(0),
                          max_seq_len=L, max_question_len=16, dataset_len=2)
        inputs, labels = make_collate_fun(tok, max_seq_len=L)(
            [ds[0], ds[1]])[:2]
        assert inputs["input_ids"].shape == (2, L)
        assert inputs["attention_mask"].shape == (2, L)


def test_cli_trains_at_768_and_writes_a_sharded_checkpoint(tmp_path):
    """long_context.cfg through the CLI's build-and-train sequence with a
    tiny model at 768, remat on: two debug steps, then a save (debug skips
    them) that lands as a sharded directory and resumes."""
    vocab = str(write_vocab(tmp_path))
    args = ["-c", str(REPO / "config" / "long_context.cfg"),
            "--dummy_dataset", "--debug", "--vocab_file", vocab,
            "--dump_dir", str(tmp_path / "results"), "--device", "cpu",
            "--model", "bert-tiny", "--max_seq_len=768",
            "--max_position_embeddings=768", "--max_question_len", "16",
            "--train_batch_size", "4", "--batch_split", "2",
            "--test_batch_size", "2", "--n_jobs", "2", "--seed", "0",
            "--remat"]
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), args)
    trainer = train_cli.build_trainer(params, model_params)
    assert trainer.model.transformer.remat and trainer.sharded_checkpoint
    train_cli.train(trainer, params)
    assert len(trainer.history) == 2 and trainer.eval_batches == 22
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    trainer.debug = False
    path = tmp_path / "results" / "long_context" / "last.ch"
    trainer.save_state_dict(path)
    assert path.is_dir() and (path / MANIFEST).exists()
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), args + ["--last", str(path)])
    resumed = train_cli.build_trainer(params, model_params)
    assert resumed.global_step == 2
    assert resumed.optimizer.count == 0   # the cfg's drop_optimizer=True
    for (n, a), (_, b) in zip(trainer.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n
