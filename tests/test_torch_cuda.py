"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the fused attention pair, the LayerNorm pair and the int8 matmul.

Every kernel test here carries the ``cuda`` marker and skips without a
CUDA device: the kernels have no CPU mode. One CPU test checks that the
backward's bf16 limits reject faulty arithmetic. The file imports no JAX,
so it also
runs on a machine with the card and no JAX (tests/conftest.py imports JAX,
hence ``--noconftest``)::

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py

The plain versions themselves are held against the JAX package's TPU
kernels on the CPU (tests/test_torch_attention.py).
"""

import math

import numpy as np
import pytest
import torch

from ml_recipe_tpu_torch.ops import flash_attention as fa
from ml_recipe_tpu_torch.ops import layer_norm as ln
from ml_recipe_tpu_torch.ops import quant_matmul as q8
from ml_recipe_tpu_torch.ops.attention import dot_product_attention
from ml_recipe_tpu_torch.ops.flash_streaming import streaming_attention
from ml_recipe_tpu_torch.quant import quantize_kernel

# f32: same arithmetic in another summation order. bf16: the kernel rounds
# each probability to bf16 against its running row max, the plain version
# against the final max (2**-9 relative each), and both round the output
# to bf16; outputs are O(1)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4  # f32 logsumexp of O(10) scores, summed in other orders
# backward, kernel vs plain on the same forward residuals. Unit-normal
# inputs give dq, dk, dv of mean size 0.01-0.13 and largest size 1-5. f32:
# the same formula in another summation order over up to 512 keys (~1e-6
# relative), held to an atol. bf16: both round p_drop and ds to bf16 at the
# same points and sum in f32, so a result a hair from a bf16 rounding
# boundary rounds either way: one bf16 step (8 significant bits) at its
# size. Two limits: the largest error within BWD_BF16_STEPS steps at
# max|ref| (2**-7 to 2**-6 of max|ref|), and the relative L2 error within
# BWD_REL_L2, which another summation order meets by 10x (~5e-5) and a
# misplaced bf16 rounding point misses by 5x (~2.6e-3; pinned on the CPU by
# test_bwd_limits_catch_misplaced_rounding)
BWD_ATOL_F32 = 2e-4
BWD_BF16_STEPS = 2
BWD_REL_L2 = 5e-4


def _bwd_errors(got, ref):
    """``(max_abs_err, limit, rel_l2)`` of one gradient against its
    reference, the limit by the reference's dtype."""
    a, b = got.float(), ref.float()
    err = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm()).item()
    if ref.dtype == torch.float32:
        return err, BWD_ATOL_F32, rel
    top = b.abs().max().item()
    return err, BWD_BF16_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7), rel


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


def _bwd_case(B, L, H, D, dtype, seed, segmented, rate):
    q, k, v, mask, seeds = _inputs(B, L, H, D, dtype, seed, segmented)
    if segmented:
        mask[-1] = 0   # one all-masked row (pad rows, lse = -1e30)
    out, lse = fa.fused_attention_plain(
        q, k, v, mask, seeds if rate else None, rate, segmented, want_lse=True)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float32).cuda().to(dtype)
    return q, k, v, g, out, lse, mask, (seeds if rate else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("L", [5, 64, 130, 200, 512])
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_kernel_matches_plain(cuda, dtype, D, L, segmented, rate):
    B, H = 2, 3
    args = _bwd_case(B, L, H, D, dtype, L + D, segmented, rate)
    before = fa.BWD_KERNEL.launches
    got = fa.fused_attention_bwd_cuda(*args, rate=rate, segmented=segmented)
    ref = fa.fused_attention_bwd_plain(*args, rate=rate, segmented=segmented)
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == args[0].shape, name
        assert torch.isfinite(a.float()).all(), name
        err, limit, rel = _bwd_errors(a, b)
        assert err <= limit and rel <= BWD_REL_L2, (name, err, rel)


@pytest.mark.cuda
def test_function_gives_grad_fn_and_launches_both_kernels(cuda):
    q, k, v, mask, seeds = _inputs(2, 128, 12, 64, torch.bfloat16, 3, False)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fwd0, bwd0 = fa.KERNEL.launches, fa.BWD_KERNEL.launches
    out = fa.fused_attention(q, k, v, mask, seed=seeds, rate=0.1)
    assert out.grad_fn is not None
    assert fa.KERNEL.launches == fwd0 + 1
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.launches == bwd0 + 1
    assert all(x.grad is not None and torch.isfinite(x.grad.float()).all()
               for x in (q, k, v))
    with torch.no_grad():   # the serving path: one forward launch, no graph
        assert fa.fused_attention(q, k, v, mask).grad_fn is None
    assert fa.KERNEL.launches == fwd0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
def test_function_grads_match_autograd_of_plain_forward(cuda, segmented):
    """f32: the kernel pair's gradients against torch.autograd through the
    plain forward. Segmented pad rows get a zero cotangent, as downstream
    masking gives them (the TPU backward zeroes their contributions, plain
    autograd would not)."""
    q, k, v, mask, seeds = _inputs(2, 200, 4, 64, torch.float32, 5, segmented)
    g = torch.randn(q.shape, device="cuda")
    if segmented:
        g = g * (mask > 0)[:, :, None, None]
    grads = []
    for fn in (fa.fused_attention, None):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        if fn is None:
            out = fa.fused_attention_plain(*x, mask, seeds, 0.1, segmented)
        else:
            out = fn(*x, mask, seed=seeds, rate=0.1, segmented=segmented)
        grads.append(torch.autograd.grad(out, x, g))
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= BWD_ATOL_F32


def _bwd_variant(q, k, v, g, out, lse, mask, seeds, rate, segmented, *,
                 acc=torch.float64, round_p=True, round_ds=True,
                 dp_scale=True):
    """``fused_attention_bwd_plain`` summed in ``acc``, or with one fault:
    p_drop or ds left unrounded, or dp without its 1/(1-rate)."""
    L, H, D = q.shape[1:]
    scale = 1.0 / D ** 0.5
    allowed = fa._allowed(mask, segmented)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    p = torch.exp(torch.where(allowed, s, fa.NEG_INF) - lse.to(acc)[..., None])
    if segmented:
        p = torch.where(allowed, p, 0.0)
    keep = fa.uniform_grid(seeds, H, L) >= rate
    p_drop = torch.where(keep, p * fa._keep_scale(rate), 0.0)
    if round_p:
        p_drop = p_drop.to(q.dtype).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, g.to(acc))
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(acc), v.to(acc))
    dp = torch.where(keep, dp * (fa._keep_scale(rate) if dp_scale else 1.0),
                     0.0)
    row = (g.to(acc) * out.to(acc)).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - row)
    if round_ds:
        ds = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
def test_bwd_limits_catch_misplaced_rounding(segmented):
    """CPU: the bf16 backward limits above pass a correct backward that sums
    in another order (f64), and fail one that skips the bf16 rounding of
    p_drop or of ds, or drops dp's 1/(1-rate). The largest-error limit alone
    would pass the two rounding faults; the relative L2 limit does not."""
    rng = np.random.default_rng(7)
    B, L, H, D, rate = 4, 256, 4, 64, 0.1
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, L, H, D),
                                                       dtype=np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    if segmented:
        mask = np.zeros((B, L), np.int32)
        for b in range(B - 1):   # the last row stays all pad
            c1, c2, c3 = sorted(rng.choice(np.arange(1, L), 3, replace=False))
            mask[b, :c1], mask[b, c1:c2], mask[b, c2:c3] = 1, 2, 3
    else:
        mask = (rng.random((B, L)) > 0.2).astype(np.int32)
        mask[:, 0] = 1
    mask = torch.from_numpy(mask)
    seeds = fa.row_seeds(torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, B).astype(np.int32)), B, H, "cpu")
    out, lse = fa.fused_attention_plain(q, k, v, mask, seeds, rate, segmented,
                                        want_lse=True)
    args = (q, k, v, g, out, lse, mask, seeds, rate, segmented)
    ref = fa.fused_attention_bwd_plain(*args)

    def passes(got):
        return all(err <= limit and rel <= BWD_REL_L2
                   for err, limit, rel in map(_bwd_errors, got, ref))

    assert passes(_bwd_variant(*args))
    for fault in (dict(round_p=False), dict(round_ds=False),
                  dict(dp_scale=False)):
        got = _bwd_variant(*args, acc=torch.float32, **fault)
        assert not passes(got), fault
    for fault in (dict(round_p=False), dict(round_ds=False)):
        got = _bwd_variant(*args, acc=torch.float32, **fault)
        assert all(err <= limit
                   for err, limit, _ in map(_bwd_errors, got, ref)), fault


# -- past 512: the TPU's blocked and streaming regimes ---------------------------

def _check_pair(args, kw, dtype):
    """Both kernels against their plain versions on ``args`` = (q, k, v, g,
    mask, seeds): the forward's out and lse, then the backward on the plain
    forward's residuals."""
    q, k, v, g, mask, seeds = args
    fwd0, bwd0 = fa.KERNEL.launches, fa.BWD_KERNEL.launches
    out, lse = fa.fused_attention_cuda(q, k, v, mask, seeds, want_lse=True,
                                       **kw)
    ref, ref_lse = fa.fused_attention_plain(q, k, v, mask, seeds,
                                            want_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    got = fa.fused_attention_bwd_cuda(q, k, v, g, ref, ref_lse, mask, seeds,
                                      **kw)
    want = fa.fused_attention_bwd_plain(q, k, v, g, ref, ref_lse, mask, seeds,
                                        **kw)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == fwd0 + 1 and fa.BWD_KERNEL.launches == bwd0 + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        err, limit, rel = _bwd_errors(a, b)
        assert err <= limit and rel <= BWD_REL_L2, (name, err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H", [(2, 768, 4), (2, 1024, 4), (1, 4096, 2)])
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_long_kernels_match_plain(cuda, dtype, B, L, H, segmented, rate):
    """L = 768 and 1024 (config/long_context.cfg, the TPU's blocked
    regime) and 4096 (its single-chip variant, the streaming regime)."""
    q, k, v, mask, seeds = _inputs(B, L, H, 64, dtype, L, segmented)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(L),
                    dtype=torch.float32).cuda().to(dtype)
    _check_pair((q, k, v, g, mask, seeds if rate else None),
                dict(rate=rate, segmented=segmented), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seg_split", [False, True], ids=["mask", "seg_split"])
@pytest.mark.parametrize("base,L_hash", [((1536, 2560), 8192),
                                         ((70000, 5), 65536)],
                         ids=["offsets", "wrapping"])
def test_streaming_contract_matches_plain(cuda, dtype, seg_split, base,
                                          L_hash):
    """Non-zero bases, L_hash past L and split q/k segment ids, dropout
    0.1; at (70000 + row) * 65536 the hash index wraps 32 bits."""
    B, L, H = 2, 512, 4
    q, k, v, mask, seeds = _inputs(B, L, H, 64, dtype, 9, seg_split)
    if seg_split:   # the k-side ids of another block
        _, _, _, kids, _ = _inputs(B, L, H, 64, dtype, 10, True)
        mask = torch.cat([mask, kids], dim=1).contiguous()
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float32).cuda().to(dtype)
    kw = dict(rate=0.1, segmented=seg_split, base=base, L_hash=L_hash,
              seg_split=seg_split)
    _check_pair((q, k, v, g, mask, seeds), kw, dtype)
    # the autograd path: one launch of each kernel
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd0, bwd0 = fa.KERNEL.launches, fa.BWD_KERNEL.launches
    out = streaming_attention(*x, mask, seed=seeds, **kw)
    out.backward(g)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == fwd0 + 1 and fa.BWD_KERNEL.launches == bwd0 + 1
    assert all(torch.isfinite(t.grad.float()).all() for t in x)


# -- LayerNorm -----------------------------------------------------------------
# kernel vs plain within the limits that ops/layer_norm.py states beside
# the plain versions (ln.fwd_limit, ln.dh_limit, ln.dparam_close)

# the smoke's 32x384 and 32x512 rows at bert-base width, and C in {32, 768,
# 1024} (tiny, base, large) with ragged row counts
LN_SHAPES = [(12288, 768), (16384, 768), (77, 32), (1000, 768), (333, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,C", LN_SHAPES)
def test_layer_norm_kernels_match_plain(cuda, dtype, N, C):
    h, gamma, beta, g = ln.seeded_inputs(N, C, dtype, N + C)
    f0, b0 = ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches
    y = ln.layer_norm_fwd_cuda(h, gamma, beta, 1e-12, dtype)
    ref = ln.layer_norm_plain(h, gamma, beta, 1e-12, dtype)
    got = ln.layer_norm_bwd_cuda(h, gamma, g, 1e-12)
    want = ln.layer_norm_bwd_plain(h, gamma, g, 1e-12)
    torch.cuda.synchronize()
    assert (ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches) == (f0 + 1, b0 + 1)
    assert y.dtype == dtype and got[0].dtype == dtype
    r = ref.float()
    tol = ln.fwd_limit(ref)
    err = (y.float() - r).abs()
    worst = int((err - tol).argmax())
    assert bool((err <= tol).all()), (err.max().item(), r.flatten()[worst])
    dh, dh_ref = got[0].float(), want[0].float()
    assert bool(((dh - dh_ref).abs() <= ln.dh_limit(want[0])).all())
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == (C,)
        assert ln.dparam_close(a, b)


@pytest.mark.cuda
def test_layer_norm_backward_is_bit_stable(cuda):
    """dgamma/dbeta are summed over row tiles in a fixed order, never with
    atomics: two launches on the same inputs give the same bits."""
    h, gamma, _, g = ln.seeded_inputs(16384, 768, torch.bfloat16, 5)
    a = ln.layer_norm_bwd_cuda(h, gamma, g, 1e-12)
    b = ln.layer_norm_bwd_cuda(h, gamma, g, 1e-12)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_layer_norm_dispatch_and_function_launch_the_kernels(cuda):
    h, gamma, beta, g = ln.seeded_inputs(6 * 64, 768, torch.bfloat16, 6)
    h3 = h.reshape(6, 64, 768)
    f0, b0 = ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches
    for impl in ("fused", "auto"):
        y = ln.layer_norm(h3, gamma, beta, eps=1e-12, dtype=torch.bfloat16,
                          impl=impl)
        assert y.shape == h3.shape
    ln.layer_norm(h3, gamma, beta, eps=1e-12, dtype=torch.bfloat16,
                  impl="xla")
    assert ln.FWD_KERNEL.launches == f0 + 2
    x = [h3.clone().requires_grad_(), gamma.clone().requires_grad_(),
         beta.clone().requires_grad_()]
    y = ln.layer_norm(*x, eps=1e-12, dtype=torch.bfloat16, impl="fused")
    y.backward(g.reshape(h3.shape))
    torch.cuda.synchronize()
    assert (ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches) == (f0 + 3, b0 + 1)
    assert x[0].grad.dtype == torch.bfloat16
    assert x[1].grad.dtype == x[2].grad.dtype == torch.float32
    with pytest.raises(ValueError, match="limit"):
        ln.layer_norm_fwd_cuda(torch.zeros((2, 4100), device="cuda"),
                               torch.ones(4100, device="cuda"),
                               torch.zeros(4100, device="cuda"), 1e-12,
                               torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_bwd_cuda(h, gamma, g.t().contiguous().t(), 1e-12)


# -- int8 matmul ---------------------------------------------------------------
# bert-base at 32x384 (M = 12288): the six projections, then the pooler's 8
# rows and the heads (N = 2 over every token, 5 and 1 over the pooled rows);
# and ragged M, N, K
Q8_SHAPES = [(12288, 768, 768), (12288, 768, 3072), (12288, 3072, 768),
             (32, 768, 768), (12288, 768, 2), (32, 768, 5), (8, 768, 1),
             (333, 36, 130), (5, 4, 3)]


def _q8_inputs(M, K, N, seed):
    """bf16 activations quantized per row, and a weight quantized per
    output channel by the port's conversion, in its [N, K] layout."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((M, K), generator=gen) * 3).cuda().to(torch.bfloat16)
    w = torch.randn((N, K), generator=gen) * 0.05
    wq, ws = quantize_kernel(w.t().numpy())
    xq, xs = q8.quantize_rowwise(x)
    return (xq, xs, torch.from_numpy(wq.T.copy()).cuda(),
            torch.from_numpy(ws).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", Q8_SHAPES)
def test_q8_kernel_equals_plain(cuda, M, K, N):
    """Exact int32 accumulation, then the same two f32 roundings: the
    kernel and the plain version agree bit for bit."""
    xq, xs, wq, ws = _q8_inputs(M, K, N, M + K + N)
    before = q8.KERNEL.launches
    got = q8.int8_matmul_cuda(xq, xs, wq, ws)
    ref = q8.int8_matmul_plain(xq, xs, wq, ws)
    torch.cuda.synchronize()
    assert q8.KERNEL.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_quant_linear_launches_the_kernel_at_every_shape(cuda):
    from ml_recipe_tpu_torch.quant import QuantLinear

    before = q8.KERNEL.launches
    for n_in, n_out, rows in ((768, 2, 384), (768, 5, 8), (64, 1, 3)):
        layer = QuantLinear(n_in, n_out, torch.bfloat16, device="cuda")
        xq, _, wq, ws = _q8_inputs(rows, n_in, n_out, n_out)
        layer.kernel_q.copy_(wq)
        layer.kernel_scale.copy_(ws)
        x = xq.to(torch.bfloat16).reshape(1, rows, n_in)
        y = layer(x)
        assert y.dtype == torch.bfloat16 and y.shape == (1, rows, n_out)
    torch.cuda.synchronize()
    assert q8.KERNEL.launches == before + 3
    with pytest.raises(ValueError, match="multiple of 4"):
        xq, xs, wq, ws = _q8_inputs(8, 6, 3, 0)
        q8.int8_matmul_cuda(xq, xs, wq, ws)
