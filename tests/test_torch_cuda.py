"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: the kernels have no CPU mode. The file imports no JAX, so it also
runs on a machine with the card and no JAX (tests/conftest.py imports JAX,
hence ``--noconftest``)::

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

The plain versions themselves are held against the JAX package's TPU
kernels on the CPU (tests/test_torch_attention.py).
"""

import numpy as np
import pytest
import torch

from ml_recipe_tpu_torch.ops import flash_attention as fa
from ml_recipe_tpu_torch.ops.attention import dot_product_attention

# f32: same arithmetic in another summation order. bf16: the kernel rounds
# each probability to bf16 against its running row max, the plain version
# against the final max (2**-9 relative each), and both round the output
# to bf16; outputs are O(1)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4  # f32 logsumexp of O(10) scores, summed in other orders


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(B, L, H, D, dtype, seed, segmented):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D),
                                                    dtype=np.float32))
               .cuda().to(dtype) for _ in range(3))
    if segmented:  # three packed segments, then padding (id 0)
        mask = np.zeros((B, L), np.int32)
        for b in range(B):
            c1, c2, c3 = sorted(rng.choice(np.arange(1, L), 3, replace=False))
            mask[b, :c1], mask[b, c1:c2], mask[b, c2:c3] = 1, 2, 3
    else:
        mask = (rng.random((B, L)) > 0.3).astype(np.int32)
        mask[:, 0] = 1
    seeds = fa.row_seeds(torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, B).astype(np.int32)), B, H, "cuda")
    return q, k, v, torch.from_numpy(mask).cuda(), seeds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,D", [(2, 200, 12, 64), (3, 64, 4, 32),
                                     (2, 130, 2, 128), (1, 512, 12, 64),
                                     (2, 5, 3, 64)])
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_matches_plain(cuda, dtype, B, L, H, D, segmented, rate):
    q, k, v, mask, seeds = _inputs(B, L, H, D, dtype, L + D, segmented)
    kw = dict(seeds=seeds if rate else None, rate=rate, segmented=segmented,
              want_lse=True)
    before = fa.KERNEL.launches
    out, lse = fa.fused_attention_cuda(q, k, v, mask, **kw)
    ref, ref_lse = fa.fused_attention_plain(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
def test_all_masked_rows_stay_finite_on_the_card(cuda):
    """Masked scores are -1e30, not -inf: a row with no allowed key
    averages v instead of computing exp(-inf - -inf) = NaN, so the next
    layer's v holds no NaN that 0 * NaN would spread to real rows."""
    for segmented in (False, True):
        q, k, v, mask, _ = _inputs(2, 96, 2, 64, torch.bfloat16, 0, segmented)
        mask[1] = 0
        out, lse = fa.fused_attention_cuda(q, k, v, mask, segmented=segmented,
                                           want_lse=True)
        ref = fa.fused_attention_plain(q, k, v, mask, segmented=segmented)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
        assert (out.float() - ref.float()).abs().max().item() <= \
            ATOL[torch.bfloat16]


@pytest.mark.cuda
def test_dispatcher_launches_the_kernel_for_cuda_tensors(cuda):
    q, k, v, mask, _ = _inputs(2, 128, 12, 64, torch.bfloat16, 1, False)
    before = fa.KERNEL.launches
    out = dot_product_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    ref = fa.fused_attention_plain(q, k, v, mask)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[torch.bfloat16]


@pytest.mark.cuda
def test_kernel_wrapper_refuses_unsupported_inputs(cuda):
    q, k, v, mask, _ = _inputs(1, 64, 2, 64, torch.float32, 2, False)
    with pytest.raises(ValueError, match="head dim"):
        x = q[..., :48].contiguous()
        fa.fused_attention_cuda(x, x, x, mask)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        fa.fused_attention_cuda(t, k, v, mask)
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        fa.fused_attention_cuda(q.half(), k.half(), v.half(), mask)
