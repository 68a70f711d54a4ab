"""Fused attention of the PyTorch port against the JAX package's TPU kernel.

The port's plain version (``ml_recipe_tpu_torch.ops.flash_attention``) is
held against ``flash_attention`` / ``_flash_forward`` run in Pallas
interpret mode (as tests/test_ops.py runs them on the CPU), on the same
numpy inputs: f32, random key masks, segments, dropout with the same [B]
seed vector, and the logsumexp output. The dropout hash is compared bit for
bit. The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against this plain version there.
"""

import numpy as np
import pytest
import torch

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
    x = torch.zeros((1, 520, 2, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(x, x, x, impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(x[:, :64], x[:, :64], x[:, :64], impl="ring")
    # the plain version takes any length when asked for explicitly
    assert dot_product_attention(x, x, x, impl="xla").shape == x.shape


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
