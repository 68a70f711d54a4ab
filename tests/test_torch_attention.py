"""Fused attention of the PyTorch port against the JAX package's TPU kernels.

The port's plain versions (``ml_recipe_tpu_torch.ops.flash_attention``) are
held against ``flash_attention`` / ``_flash_forward`` run in Pallas
interpret mode (as tests/test_ops.py runs them on the CPU), on the same
numpy inputs: f32, random key masks, segments, dropout with the same [B]
seed vector, and the logsumexp output. The backward (``_fused_bwd_kernel``
through ``jax.vjp``) is held against both ``fused_attention_bwd_plain`` and
the ``FusedAttention`` autograd Function. The dropout hash is compared bit
for bit. The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_recipe_tpu.ops.flash_attention import (
    _flash_forward,
    _row_seeds,
    _uniform_grid,
    flash_attention,
    hash_uniform,
)
from ml_recipe_tpu_torch.ops import cuda_build
from ml_recipe_tpu_torch.ops import flash_attention as port
from ml_recipe_tpu_torch.ops.attention import dot_product_attention

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1

# f32 on both sides, same formula; only the summation order of the two
# products differs (einsum vs the interpret-mode dot): ~1e-7 relative
F32_ATOL = 1e-5


def _inputs(B=2, L=64, H=2, D=8, seed=0, segmented=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, H, D)).astype(np.float32)
               for _ in range(3))
    if segmented:
        # packed rows: segments 1..3 in order, trailing pad (id 0)
        mask = np.zeros((B, L), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(1, L - 4), 2, replace=False))
            mask[b, :cuts[0]] = 1
            mask[b, cuts[0]:cuts[1]] = 2
            mask[b, cuts[1]:L - 4] = 3
    else:
        mask = (rng.random((B, L)) > 0.3).astype(np.int32)
        mask[:, 0] = 1
    return q, k, v, mask


def _port(q, k, v, mask, **kw):
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    return port.fused_attention(*t, **kw)


@pytest.mark.parametrize("L,D", [(64, 8), (64, 64), (128, 8), (128, 64)])
@pytest.mark.parametrize("segmented", [False, True])
def test_plain_matches_pallas_kernel(L, D, segmented):
    q, k, v, mask = _inputs(L=L, D=D, segmented=segmented)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), dtype=jnp.float32,
                          interpret=True, segmented=segmented)
    out = _port(q, k, v, mask, segmented=segmented)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_matches_pallas_dropout_and_lse(segmented, rate):
    q, k, v, mask = _inputs(L=128, D=64, segmented=segmented, seed=3)
    seed = np.array([123456789, -987654321], np.int32)  # a [B] vector
    out_j, lse_j = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(seed), jnp.float32, rate, True, want_lse=True,
        seg=segmented)
    out, lse = _port(q, k, v, mask, seed=torch.from_numpy(seed), rate=rate,
                     segmented=segmented, want_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=F32_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=F32_ATOL)


def test_dropout_changes_the_output_deterministically():
    q, k, v, mask = _inputs(L=64, D=8)
    a = _port(q, k, v, mask, seed=7, rate=0.1)
    b = _port(q, k, v, mask, seed=7, rate=0.1)
    c = _port(q, k, v, mask, seed=8, rate=0.1)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("seed", [INT32_MIN, -1, 0, 1, INT32_MAX])
def test_hash_grid_bit_exact(seed):
    L, H = 64, 3
    seeds = port.row_seeds(seed, 1, H)
    grid = port.uniform_grid(seeds, H, L)
    for h in range(H):
        ref = _uniform_grid(jnp.int32(seed), jnp.int32(h), L)
        assert np.array_equal(grid[0, h].numpy(), np.asarray(ref))


def test_hash_uniform_bit_exact_on_wraparound_inputs():
    x = np.array([INT32_MIN, INT32_MIN + 1, -1, 0, 1, 12345, INT32_MAX],
                 np.int32)
    x = np.concatenate([x, np.random.default_rng(0).integers(
        INT32_MIN, INT32_MAX, 4096, dtype=np.int64).astype(np.int32)])
    ref = np.asarray(hash_uniform(jnp.asarray(x)))
    out = port.hash_uniform(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("seed", [[INT32_MIN], [-1], [INT32_MAX], [5],
                                  [INT32_MAX, INT32_MIN, -1, 3]])
def test_row_seeds_bit_exact(seed):
    B, H = 4, 12
    ref = np.asarray(_row_seeds(jnp.asarray(seed, jnp.int32), B, H))
    out = port.row_seeds(torch.tensor(seed), B, H)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("segmented", [False, True])
def test_all_masked_rows_are_finite(segmented):
    q, k, v, mask = _inputs(L=64, D=8)
    mask[1] = 0  # batch row 1: every key masked (pad rows, segment id 0)
    out, lse = _port(q, k, v, mask, segmented=segmented, want_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), dtype=jnp.float32,
                          interpret=True, segmented=segmented)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL)


def test_dispatcher_runs_plain_version_for_cpu_tensors():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(L=64, D=8))
    before = port.KERNEL.launches
    out = dot_product_attention(q, k, v, mask)
    assert port.KERNEL.launches == before
    assert torch.equal(out, port.fused_attention_plain(q, k, v, mask))
    assert torch.equal(dot_product_attention(q, k, v, mask, impl="xla"), out)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_dispatcher_refuses_unported_regimes(impl):
    """Ring attention needs a mesh with a seq axis (its own tests are in
    tests/test_torch_ring_attention.py); every length past 512 (the TPU's
    blocked and streaming regimes) now runs the kernel pair, here its plain
    version."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 520, 2, 8)).astype(np.float32))
    before = port.KERNEL.launches
    assert torch.equal(dot_product_attention(x, x, x, impl=impl),
                       dot_product_attention(x, x, x, impl="xla"))
    assert port.KERNEL.launches == before
    with pytest.raises(ValueError, match="'seq' axis"):
        dot_product_attention(x[:, :64], x[:, :64], x[:, :64], impl="ring")


def test_kernel_wrapper_raises_on_cpu_tensors():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(L=64, D=64))
    before = port.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        port.fused_attention_cuda(q, k, v, mask)
    assert port.KERNEL.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda path: False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    lib = cuda_build.CudaLibrary("fused_attention_fwd.cu", lambda lib: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.lib()


def test_kernel_source_names_its_tpu_kernel():
    src = (cuda_build.CSRC_DIR / "fused_attention_fwd.cu").read_text()
    assert "_fused_fwd_kernel" in src
    assert 'extern "C" int fused_attention_fwd' in src


def _pad_rows(mask, segmented):
    """Every row of the last batch row masked: all-masked pad rows in the
    segmented mode (lse = -1e30), an all-masked key row in the key mode."""
    mask = mask.copy()
    if segmented:
        mask[-1, -12:] = 0
    return mask


@pytest.mark.parametrize("L,D", [(64, 8), (64, 64), (128, 8), (128, 64)])
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_pallas_kernel(L, D, segmented, rate):
    """dq, dk, dv of the plain backward and of the autograd Function
    against ``jax.vjp`` through the interpret-mode ``_fused_bwd_kernel``
    (f32, F32_ATOL: the same formula in another summation order)."""
    q, k, v, mask = _inputs(L=L, D=D, segmented=segmented, seed=L + D)
    mask = _pad_rows(mask, segmented)
    g = np.random.default_rng(L * D).normal(size=q.shape).astype(np.float32)
    seed = np.array([123456789, -987654321], np.int32)   # a [B] vector
    _, vjp = jax.vjp(
        lambda q_, k_, v_: flash_attention(
            q_, k_, v_, jnp.asarray(mask), seed=jnp.asarray(seed),
            dtype=jnp.float32, rate=rate, interpret=True,
            segmented=segmented),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    t = [torch.from_numpy(x) for x in (q, k, v, mask, g)]
    seeds = port.row_seeds(torch.from_numpy(seed), 2, q.shape[2])
    out, lse = port.fused_attention_plain(
        *t[:4], seeds, rate, segmented, want_lse=True)
    plain = port.fused_attention_bwd_plain(
        *t[:3], t[4], out, lse, t[3], seeds, rate, segmented)

    x = [a.clone().requires_grad_() for a in t[:3]]
    y = port.fused_attention(*x, t[3], seed=torch.from_numpy(seed),
                             rate=rate, segmented=segmented)
    assert isinstance(y.grad_fn, port.FusedAttention._backward_cls)
    func = torch.autograd.grad(y, x, t[4])
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, func):
        np.testing.assert_allclose(a.numpy(), r, atol=F32_ATOL, err_msg=name)
        np.testing.assert_allclose(b.numpy(), r, atol=F32_ATOL, err_msg=name)


def test_segmented_backward_zeroes_pad_rows():
    """An all-masked pad row's lse is -1e30 and exp(s - lse) is 1 on every
    key: the backward must zero it in the segmented mode, and keep the TPU
    kernel's unzeroed values in the key-mask mode."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(L=64, D=8,
                                                          segmented=True))
    mask[1] = 0                                   # batch row 1: all pad
    g = torch.ones_like(q)
    for segmented in (True, False):
        out, lse = port.fused_attention_plain(q, k, v, mask, None, 0.0,
                                              segmented, want_lse=True)
        dq, dk, dv = port.fused_attention_bwd_plain(q, k, v, g, out, lse,
                                                    mask, None, 0.0, segmented)
        if segmented:
            assert (lse[1] == port.NEG_INF).all()
            assert not dq[1].any() and not dk[1].any() and not dv[1].any()
        else:
            assert dv[1].abs().sum() > 0


def test_function_routes_by_grad_mode():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(L=64, D=8))
    assert port.fused_attention(q, k, v, mask).grad_fn is None
    x = q.clone().requires_grad_()
    assert port.fused_attention(x, k, v, mask).grad_fn is not None
    with torch.no_grad():
        assert port.fused_attention(x, k, v, mask).grad_fn is None
    with pytest.raises(ValueError, match="want_lse"):
        port.fused_attention(x, k, v, mask, want_lse=True)


def test_bwd_kernel_wrapper_raises_on_cpu_tensors():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(L=64, D=64))
    out, lse = port.fused_attention_plain(q, k, v, mask, want_lse=True)
    before = port.BWD_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        port.fused_attention_bwd_cuda(q, k, v, q, out, lse, mask)
    assert port.BWD_KERNEL.launches == before


def test_bwd_kernel_source_names_its_tpu_kernel():
    src = (cuda_build.CSRC_DIR / "fused_attention_bwd.cu").read_text()
    assert "flash_attention.py:266" in src and "_fused_bwd_kernel" in src
    assert 'extern "C" int fused_attention_bwd' in src
    # one copy of the dropout hash, shared with the forward
    common = (cuda_build.CSRC_DIR / "attention_common.cuh").read_text()
    assert "hash_uniform" in common
    for name in ("fused_attention_fwd.cu", "fused_attention_bwd.cu"):
        text = (cuda_build.CSRC_DIR / name).read_text()
        assert '#include "attention_common.cuh"' in text
        assert "0xCC9E2D51" not in text


def test_library_key_covers_the_shared_header(monkeypatch, tmp_path):
    """An edited header must never load a library built from the old one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("fused_attention_fwd.cu", "attention_common.cuh"):
        (csrc / name).write_text((cuda_build.CSRC_DIR / name).read_text())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    lib = cuda_build.CudaLibrary("fused_attention_fwd.cu", lambda lib: None)
    before = lib.path
    (csrc / "attention_common.cuh").write_text(
        (csrc / "attention_common.cuh").read_text() + "\n// edited\n")
    assert lib.path != before
