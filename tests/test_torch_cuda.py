"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the fused attention pair, the LayerNorm pair and the int8 matmul; and data
parallelism there (a one-rank NCCL round trip of the bucketed collectives,
two ranks over gloo sharing the card against the one-process step).

Every kernel test here carries the ``cuda`` marker and skips without a
CUDA device: the kernels have no CPU mode. The CPU tests check that the
backward's bf16 limits reject faulty arithmetic, that the bf16 kernels'
integer dropout threshold draws the same keep-bit as the float compare,
and that the resource query refuses other head dims. The file imports no
JAX, so it also runs on a machine with the card and no JAX (tests/conftest.py imports JAX,
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
                                     (2, 5, 3, 64), (16, 512, 12, 64)])
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
    with pytest.raises(ValueError, match="16-byte boundary"):
        buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
        x = buf[1:].view(q.shape)   # contiguous, 2 bytes off
        fa.fused_attention_cuda(x, x, x, mask)


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


def _packed_segment_ids(B, L, seed):
    """The ``segment_ids`` plane of a ``collate_packed`` batch: items of 30
    to 400 tokens first-fit into B rows of L, each row's tail padding (id
    0), and its last row empty: a pad row with no key to attend."""
    from types import SimpleNamespace

    from ml_recipe_tpu_torch.data.packing import SequencePacker, collate_packed

    rng = np.random.default_rng(seed)
    packer = SequencePacker(L)
    rows = []
    while len(rows) < B - 1:
        n = int(rng.integers(30, 401))
        item = SimpleNamespace(input_ids=[2] + [7] * (n - 2) + [3],
                               start_id=-1, end_id=-1, label_id=0,
                               start_position=0.0, end_position=0.0)
        rows += packer.add(item, n)
    tok = SimpleNamespace(pad_token_id=0, sep_token_id=3, model_name="bert")
    inputs, _ = collate_packed(rows[:B - 1] + [[]], tok, max_seq_len=L)
    return torch.from_numpy(inputs["segment_ids"]).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_segmented_kernels_on_a_packed_batch(cuda, dtype, rate):
    """The segmented pair on a packed batch's own segment ids (the training
    micro-batch's 512 at 12 heads of 64): forward (out, lse) and backward
    against the plain versions; the pad positions, tail and empty row, keep
    a finite output and lse and take exactly zero dq, dk and dv, whatever
    cotangent reaches them."""
    B, L, H, D = 8, 512, 12, 64
    seg = _packed_segment_ids(B, L, seed=7)
    pad = seg == 0
    assert pad[:-1].any() and pad[-1].all() and (seg.amax(1)[:-1] > 1).any()
    q, k, v, _, seeds = _inputs(B, L, H, D, dtype, 11, False)
    sd = seeds if rate else None
    kw = dict(rate=rate, segmented=True, want_lse=True)
    out, lse = fa.fused_attention_cuda(q, k, v, seg, sd, **kw)
    ref, ref_lse = fa.fused_attention_plain(q, k, v, seg, sd, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float32).cuda().to(dtype)
    args = (q, k, v, g, ref, ref_lse, seg, sd)
    got = fa.fused_attention_bwd_cuda(*args, rate=rate, segmented=True)
    want = fa.fused_attention_bwd_plain(*args, rate=rate, segmented=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        err, limit, rel = _bwd_errors(a, b)
        assert err <= limit and rel <= BWD_REL_L2, (name, err, rel)
        assert (a[pad] == 0).all() and (b[pad] == 0).all(), name


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


class _PairTransport:
    """Two ring ranks simulated in one process, for the forward: a rank's
    one hop receives the other rank's original blocks."""

    def __init__(self, other):
        self.other = other

    def hop(self, tensors):
        return list(self.other)


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "segments"])
def test_ring_forward_on_the_card_matches_one_call(cuda, segmented):
    """The ring's forward (ops/ring_attention.py) at seq:2 with both ranks'
    hops on the card: two hop launches a rank, at bases (row, col) in {0,
    L/2} and L_hash L, merged in f32; the merged output equals one kernel
    call over the whole sequence within the bf16 limit (one bf16 rounding
    per hop more), and each hop against its plain version."""
    from ml_recipe_tpu_torch.ops.ring_attention import (
        _stream_fwd_local, _stream_row_seeds)

    B, L, H, S = 2, 1024, 4, 2
    L_loc = L // S
    q, k, v, mask, _ = _inputs(B, L, H, 64, torch.bfloat16, 11, segmented)
    seeds = _stream_row_seeds(torch.tensor([1234]), B=B, H=H,
                              data_index=0).cuda()
    blocks = [[t[:, r * L_loc:(r + 1) * L_loc].contiguous()
               for t in (k, v, mask)] for r in range(S)]
    before = fa.KERNEL.launches
    outs = []
    for r in range(S):
        out, lse = _stream_fwd_local(
            q[:, r * L_loc:(r + 1) * L_loc].contiguous(), *blocks[r], seeds,
            transport=_PairTransport(blocks[1 - r]), seq_index=r,
            seq_size=S, rate=0.1, seg=segmented)
        assert torch.isfinite(lse).all()
        outs.append(out)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + S * S
    ring = torch.cat(outs, dim=1)
    one = fa.fused_attention_cuda(q, k, v, mask, seeds, 0.1, segmented)
    valid = (mask > 0)[:, :, None, None]
    err = ((ring.float() - one.float()) * valid).abs().max().item()
    assert err <= ATOL[torch.bfloat16], err


# -- the bf16 tensor-core design: tile edges, head dims, determinism -------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [200, 1000])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ragged_all_masked_row_matches_plain(cuda, dtype, L, rate):
    """A row whose key mask is all zero at a length that leaves the last
    K/V tile ragged: its valid columns score -1e30 and average v, the
    zero-filled columns past L score -inf and add nothing, in the forward's
    denominator and in both backward kernels. A tile that scored the
    padding -1e30 would average it in."""
    q, k, v, mask, seeds = _inputs(2, L, 4, 64, dtype, L + 1, False)
    mask[1] = 0
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(L),
                    dtype=torch.float32).cuda().to(dtype)
    _check_pair((q, k, v, g, mask, seeds if rate else None),
                dict(rate=rate, segmented=False), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("L", [333, 1000])
@pytest.mark.parametrize("segmented", [False, True], ids=["mask", "seg"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_head_dims_across_tiles_match_plain(cuda, D, L, segmented,
                                                 rate):
    """bf16 at the head dims beside bert's 64, over lengths that span
    several K/V tiles (and, at D = 128, the backward's 32-row stages) with
    a ragged last one."""
    q, k, v, mask, seeds = _inputs(2, L, 3, D, torch.bfloat16, L + D,
                                   segmented)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(D),
                    dtype=torch.float32).cuda().to(torch.bfloat16)
    _check_pair((q, k, v, g, mask, seeds if rate else None),
                dict(rate=rate, segmented=segmented), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_kernel_is_bit_stable(cuda, dtype):
    """Every dq, dk, dv element has one writer and is summed in a fixed
    order, never with atomics: two launches on the same inputs give the
    same bits."""
    args = _bwd_case(4, 1000, 12, 64, dtype, 11, True, 0.1)
    a = fa.fused_attention_bwd_cuda(*args, rate=0.1, segmented=True)
    b = fa.fused_attention_bwd_cuda(*args, rate=0.1, segmented=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_tc_kernels_keep_their_accumulators_in_registers(cuda, D):
    """No bf16 tensor-core kernel uses local memory (a spill or a stack
    array), and each asks for the dynamic shared memory it was built for."""
    attrs = fa.tc_kernel_attributes(D)
    assert set(attrs) == set(fa.TC_KERNELS)
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
        assert 0 < a["dynamic_smem_bytes"] <= 227 * 1024, (name, a)
        assert a["registers"] <= 255, (name, a)


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 1e-7, 0.3333333, 0.9999999])
def test_integer_keep_threshold_equals_the_float_compare(rate):
    """CPU: the bf16 kernels draw the keep-bit as ``n >= ceil(rate *
    2**24)`` on the hash's 24-bit integer n (attention_common.cuh
    ``keep_u24``), the f32 kernels and the plain version as ``n / 2**24 >=
    rate`` in f32. Both give the same bit for every n."""
    n = np.arange(1 << 24, dtype=np.int64)
    r = np.float32(rate)
    by_float = n.astype(np.float32) * np.float32(1.0 / (1 << 24)) >= r
    threshold = int(np.ceil(r * np.float32(1 << 24)))
    assert np.array_equal(by_float, n >= threshold)


def test_tc_kernel_attributes_refuse_other_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        fa.tc_kernel_attributes(48)


# -- LayerNorm -----------------------------------------------------------------
# kernel vs plain within the limits that ops/layer_norm.py states beside
# the plain versions (ln.fwd_limit, ln.dh_limit, ln.dparam_close)

# the smoke's 32x384 and 32x512 rows at bert-base width, and C in {32, 768,
# 1024} (tiny, base, large) with ragged row counts; then the backward's
# grid (8 warps a block, a warp a row, at most 264 blocks: 2112 rows a
# pass): one row, part of a block, 9 blocks (an odd count), a pass and a
# row, four passes and 64 rows; then validate's 16x512 rows
LN_SHAPES = [(12288, 768), (16384, 768), (77, 32), (1000, 768), (333, 1024),
             (1, 768), (40, 768), (65, 768), (2113, 768), (8512, 768),
             (8192, 768)]


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
    """dgamma/dbeta are summed over the blocks' rows in a fixed order, never
    with atomics: two launches on the same inputs give the same bits, also
    with a launch at another N between them."""
    h, gamma, _, g = ln.seeded_inputs(16384, 768, torch.bfloat16, 5)
    a = ln.layer_norm_bwd_cuda(h, gamma, g, 1e-12)
    ln.layer_norm_bwd_cuda(h[:8512], gamma, g[:8512], 1e-12)
    b = ln.layer_norm_bwd_cuda(h, gamma, g, 1e-12)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _device_kernel_names(run):
    """Names of the device kernels in a torch.profiler trace of ``run()``,
    traced again (up to three times) when a trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    pytest.fail("three profiler traces held no device events")


@pytest.mark.cuda
def test_layer_norm_backward_unaligned_g_takes_the_block_kernel(cuda):
    """g as a contiguous view 2 bytes past a 16-byte boundary: no 16-byte
    vectors, so the block kernel runs, and matches the plain version; the
    same g aligned runs the warp kernel."""
    N, C = 333, 768
    h, gamma, _, g = ln.seeded_inputs(N, C, torch.bfloat16, 11)
    buf = torch.empty(N * C + 1, dtype=g.dtype, device=g.device)
    g_off = buf[1:].view(N, C)
    g_off.copy_(g)
    assert g_off.is_contiguous() and g_off.data_ptr() % 16 == 2
    for grad, kernel in ((g_off, "layer_norm_bwd_kernel"),
                         (g, "layer_norm_bwd_warp_kernel")):
        got = []
        names = _device_kernel_names(
            lambda: got.append(ln.layer_norm_bwd_cuda(h, gamma, grad, 1e-12)))
        assert any(kernel in n for n in names), names
        assert any("layer_norm_bwd_sum_kernel" in n for n in names), names
        assert len([n for n in names if "layer_norm_bwd" in n]) == 2, names
        want = ln.layer_norm_bwd_plain(h, gamma, g, 1e-12)
        dh, dh_ref = got[0][0].float(), want[0].float()
        assert bool(((dh - dh_ref).abs() <= ln.dh_limit(want[0])).all())
        for a, b in zip(got[0][1:], want[1:]):
            assert ln.dparam_close(a, b)


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
# and ragged M, N, K; then the projections at validate's 16x512 (M = 8192)
Q8_SHAPES = [(12288, 768, 768), (12288, 768, 3072), (12288, 3072, 768),
             (32, 768, 768), (12288, 768, 2), (32, 768, 5), (8, 768, 1),
             (333, 36, 130), (5, 4, 3), (8192, 768, 768), (8192, 768, 3072),
             (8192, 3072, 768)]


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


# -- the int8 serving epilogues ------------------------------------------------
# q8_matmul's QuantLinear epilogue (int8_linear: + bias and the cast in the
# same launch), the row quantize kernel and the LayerNorm forward's quantize
# epilogue: bit for bit with their plain versions, and bit-stable


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", Q8_SHAPES)
def test_int8_linear_kernel_equals_plain(cuda, M, K, N, dtype):
    xq, xs, wq, ws = _q8_inputs(M, K, N, M + K + N)
    gen = torch.Generator().manual_seed(N)
    bias = (torch.randn(N, generator=gen) * 0.1).cuda()
    before = q8.KERNEL.launches
    got = q8.int8_linear_cuda(xq, xs, wq, ws, bias, dtype)
    again = q8.int8_linear_cuda(xq, xs, wq, ws, bias, dtype)
    ref = q8.int8_linear_plain(xq, xs, wq, ws, bias, dtype)
    torch.cuda.synchronize()
    assert q8.KERNEL.launches == before + 2
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, ref) and torch.equal(got, again)


def _quantize_rows_input(M, K, dtype, seed):
    """Rows of size ~3 with an all-zero row and, where K allows, rows of
    exact ties: amax 127 (scale 1) with values k + 0.5, and amax 254 (scale
    2) with odd values, so x / scale lands on k + 0.5."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((M, K), generator=gen) * 3
    x[0] = 0.0
    if M > 2 and K >= 4:
        x[1] = 0.5
        x[1, 0] = 127.0
        x[1, 1:4] = torch.tensor([2.5, -2.5, 1.5])
        x[2] = 1.0
        x[2, 0] = -254.0
        x[2, 1:4] = torch.tensor([5.0, -3.0, 7.0])
    return x.cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K", [(12288, 768), (12288, 3072), (32, 768),
                                 (333, 36), (5, 4), (7, 1000), (3, 5),
                                 (8192, 768), (8192, 3072)])
def test_quantize_kernel_equals_plain(cuda, M, K, dtype):
    x = _quantize_rows_input(M, K, dtype, M + K)
    before = q8.QUANT_KERNEL.launches
    q, s = q8.quantize_rowwise_cuda(x)
    q2, s2 = q8.quantize_rowwise_cuda(x)
    ref_q, ref_s = q8.quantize_rowwise(x)
    cpu_q, cpu_s = q8.quantize_rowwise(x.cpu())
    torch.cuda.synchronize()
    assert q8.QUANT_KERNEL.launches == before + 2
    assert q.dtype == torch.int8 and s.shape == (M, 1)
    assert torch.equal(q, ref_q) and torch.equal(s, ref_s)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert torch.equal(q.cpu(), cpu_q) and torch.equal(s.cpu(), cpu_s)
    assert not q[0].any()
    if M > 2 and K >= 4:   # half to even, not half away from zero
        assert q[1, :5].tolist() == [127, 2, -2, 2, 0][:K]
        assert q[2, :4].tolist() == [-127, 2, -2, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,C", [(12288, 768), (77, 32), (1000, 768),
                                 (333, 1024), (9, 36), (5, 2048),
                                 (8192, 768)])
def test_layer_norm_codes_are_quantize_rowwise_of_the_kernels_output(
        cuda, N, C, dtype):
    """The epilogue quantizes the rounded y the launch writes: its codes
    are quantize_rowwise of that y exactly, and y is the forward kernel's
    (within the plain version's limits). C = 36 (no whole 16-byte vectors
    of bf16) and C = 2048 take the block kernel, then the codes kernel, in
    the same launch."""
    h, gamma, beta, _ = ln.seeded_inputs(N, C, dtype, N * C)
    h[1] = 0.25                           # a constant row: y = beta
    f0, q0 = ln.FWD_KERNEL.launches, q8.QUANT_KERNEL.launches
    y, q, s = ln.layer_norm_q8(h, gamma, beta, eps=1e-12, dtype=dtype)
    y2, q2, s2 = ln.layer_norm_q8(h, gamma, beta, eps=1e-12, dtype=dtype)
    alone = ln.layer_norm_fwd_cuda(h, gamma, beta, 1e-12, dtype)
    ref = ln.layer_norm_plain(h, gamma, beta, 1e-12, dtype)
    want_q, want_s = q8.quantize_rowwise(y)
    torch.cuda.synchronize()
    assert ln.FWD_KERNEL.launches == f0 + 3
    assert q8.QUANT_KERNEL.launches == q0
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(y, alone)
    assert torch.equal(y, y2) and torch.equal(q, q2) and torch.equal(s, s2)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= ln.fwd_limit(ref)).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("ln_impl", ["fused", "xla"])
def test_int8_forward_runs_only_kernels(cuda, ln_impl, monkeypatch):
    """A quantized model's forward on the card: every projection one
    int8_linear launch, every quantize a kernel launch, each distinct input
    quantized once, and no plain quantize, product, bias or cast pass."""
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
    from ml_recipe_tpu_torch.quant import quantize_model

    cfg = EncoderConfig(vocab_size=100, hidden_size=64, num_layers=2,
                        num_heads=2, intermediate_size=128,
                        max_position_embeddings=64, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    fmodel = QAModel(cfg, dtype=torch.bfloat16, device="cuda",
                     ln_impl=ln_impl)
    qmodel, _ = quantize_model(fmodel.eval())

    def refuse(*args, **kw):
        raise AssertionError("a plain pass ran on a CUDA tensor")

    for name in ("quantize_rowwise", "int8_matmul_plain",
                 "int8_linear_plain"):
        monkeypatch.setattr(q8, name, refuse)
    ids = torch.randint(5, 100, (3, 48), device="cuda")
    before = {k: k.launches for k in (q8.KERNEL, q8.QUANT_KERNEL,
                                      ln.FWD_KERNEL)}
    with torch.inference_mode():
        out = qmodel(ids)
    torch.cuda.synchronize()
    L = cfg.num_layers
    fused = ln_impl == "fused"
    assert q8.KERNEL.launches - before[q8.KERNEL] == 6 * L + 5
    assert ln.FWD_KERNEL.launches - before[ln.FWD_KERNEL] == \
        (2 * L + 1 if fused else 0)
    # context, GELU output and pooled output; the LayerNorm outputs and the
    # pooler's [CLS] rows too when no fused LayerNorm wrote their codes
    assert q8.QUANT_KERNEL.launches - before[q8.QUANT_KERNEL] == \
        2 * L + 1 + (0 if fused else 2 * L + 2)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


@pytest.mark.cuda
@pytest.mark.parametrize("ln_impl", ["fused", "xla"])
def test_int8_forward_equals_its_composition_of_plain_passes(cuda, ln_impl,
                                                             monkeypatch):
    """The int8 model's wiring on the card, held exactly: the same model
    with every quantize, product, bias and cast a plain pass on the CUDA
    tensors, each input quantized by ``quantize_rowwise`` where it is read,
    and every LayerNorm the forward kernel without its codes. The kernels
    are bit for bit with those plain passes, the epilogue's codes are
    ``quantize_rowwise`` of the kernel's own y, and attention is the same
    deterministic kernel in both runs: so every output is equal. A wrong
    tensor's codes (a view's, a stale one's, the [CLS] rows', the 3-D
    reshape of the LayerNorm's codes) shows here."""
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
    from ml_recipe_tpu_torch.models.encoder import FusedLayerNorm
    from ml_recipe_tpu_torch.quant import layers as qlayers
    from ml_recipe_tpu_torch.quant import quantize_model

    cfg = EncoderConfig(vocab_size=100, hidden_size=64, num_layers=2,
                        num_heads=2, intermediate_size=128,
                        max_position_embeddings=64, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    fmodel = QAModel(cfg, dtype=torch.bfloat16, device="cuda",
                     ln_impl=ln_impl)
    qmodel, _ = quantize_model(fmodel.eval())
    ids = torch.randint(5, 100, (3, 48), device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 40:] = 0                      # a padded row
    with torch.inference_mode():
        got = qmodel(ids, mask)
    before = {k: k.launches for k in (q8.KERNEL, q8.QUANT_KERNEL)}
    monkeypatch.setattr(qlayers, "int8_linear", q8.int8_linear_plain)
    monkeypatch.setattr(qlayers, "quantize_rows", q8.quantize_rowwise)
    lns = [m for m in qmodel.modules() if isinstance(m, FusedLayerNorm)]
    assert len(lns) == (2 * cfg.num_layers + 1 if ln_impl == "fused" else 0)
    for m in lns:
        monkeypatch.setattr(m, "codes", False)
    with torch.inference_mode():
        want = qmodel(ids, mask)
    torch.cuda.synchronize()
    assert all(k.launches == n for k, n in before.items())
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _predictor_setup(tmp_path, *, dtype, attention_impl="auto", ln_impl="xla",
                     quantize="off", seed=0):
    """A small QA model on the card (heads of 64), seeded weights, and a
    ``Predictor`` over a tokenizer-bound collate (the ids-only wire)."""
    from ml_recipe_tpu_torch.compose import init_collate_fun
    from ml_recipe_tpu_torch.infer.predictor import Predictor
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, init_weights
    from ml_recipe_tpu_torch.quant import quantize_model
    from ml_recipe_tpu_torch.tokenizer import (
        Tokenizer,
        write_synthetic_bert_vocab,
    )

    vocab = write_synthetic_bert_vocab(tmp_path / "vocab.txt", size=300)
    tok = Tokenizer("bert", vocab, lowercase=True)
    cfg = EncoderConfig(vocab_size=len(tok), hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=256,
                        max_position_embeddings=130, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    model = QAModel(cfg, dtype=dtype, device="cuda",
                    attention_impl=attention_impl, ln_impl=ln_impl)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.eval()
    if quantize == "int8":
        model, _ = quantize_model(model)
    collate = init_collate_fun(tok, max_seq_len=128, return_items=True)
    return model, tok, lambda m, **kw: Predictor(m, collate_fun=collate,
                                                 batch_size=4, n_jobs=2, **kw)


class _ChunkDocs:
    """``n`` documents of 1-3 chunks of 20-128 tokens each."""

    def __init__(self, tok, n=7, seed=1):
        from ml_recipe_tpu_torch.data.datasets import ChunkItem

        rng = np.random.default_rng(seed)
        self.docs = []
        for d in range(n):
            q = rng.integers(110, 300, 6).tolist()
            chunks = []
            for c in range(int(rng.integers(1, 4))):
                body = rng.integers(110, 300,
                                    int(rng.integers(11, 120))).tolist()
                ids = [tok.cls_token_id, *q, tok.sep_token_id, *body,
                       tok.sep_token_id]
                chunks.append(ChunkItem(
                    item_id=str(d), input_ids=ids, start_id=-1, end_id=-1,
                    label_id=4, true_text="", true_question="", true_label=4,
                    true_start=-1, true_end=-1, question_len=len(q), t2o=[],
                    chunk_start=c, chunk_end=c + 1, start_position=0.0,
                    end_position=0.0))
            self.docs.append(chunks)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i]


def _per_chunk(predictor):
    out = {}
    for scores, starts, ends, labels, items in predictor.dump:
        for r, item in enumerate(items):
            out[(item.item_id, item.chunk_start)] = (
                float(scores[r]), int(starts[r]), int(ends[r]), int(labels[r]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("length_buckets", [None, [64, 128]],
                         ids=["padmax", "buckets"])
def test_predictor_runs_the_attention_kernel_and_agrees_with_plain(
        cuda, tmp_path, length_buckets, monkeypatch):
    """The predictor on the card: every scored batch is one forward kernel
    launch per layer and no backward, with no plain attention pass; its
    per-chunk spans and labels equal those of the same weights with the
    plain attention, and its scores lie within ``SCORE_ATOL``."""
    model, tok, make = _predictor_setup(tmp_path, dtype=torch.float32)
    plain_model, _, _ = _predictor_setup(tmp_path, dtype=torch.float32,
                                         attention_impl="xla")
    docs = _ChunkDocs(tok)
    want = _per_chunk(make(plain_model, length_buckets=length_buckets)(
        docs, save_dump=True))

    def refuse(*args, **kw):
        raise AssertionError("plain attention ran on the kernel path")

    monkeypatch.setattr(fa, "fused_attention_plain", refuse)
    fwd0, bwd0 = fa.KERNEL.launches, fa.BWD_KERNEL.launches
    predictor = make(model, length_buckets=length_buckets)(docs, save_dump=True)
    torch.cuda.synchronize()
    batches = predictor.stats["batches"]
    assert batches == len(predictor.dump) >= 2
    assert fa.KERNEL.launches - fwd0 == 2 * batches
    assert fa.BWD_KERNEL.launches == bwd0
    got = _per_chunk(predictor)
    assert set(got) == set(want) and len(got) == predictor.stats["chunks"]
    for key, (score, start, end, label) in want.items():
        assert got[key][1:] == (start, end, label), key
        assert abs(got[key][0] - score) <= SCORE_ATOL, key


# f32 scores: the same forward with the kernel's attention summed in another
# order, on O(1) logits
SCORE_ATOL = 1e-3


@pytest.mark.cuda
def test_int8_predictor_runs_only_kernels(cuda, tmp_path, monkeypatch):
    """``--quantize int8 --ln_impl fused`` through the predictor: every
    projection, quantize and LayerNorm of every scored batch is a kernel
    launch (77/25/25 per forward at 12 layers; 6L + 5, 2L + 1 and 2L + 1
    here) and no plain pass runs."""
    model, tok, make = _predictor_setup(tmp_path, dtype=torch.bfloat16,
                                        ln_impl="fused", quantize="int8")

    def refuse(*args, **kw):
        raise AssertionError("a plain pass ran on a CUDA tensor")

    for name in ("quantize_rowwise", "int8_matmul_plain", "int8_linear_plain"):
        monkeypatch.setattr(q8, name, refuse)
    monkeypatch.setattr(fa, "fused_attention_plain", refuse)
    kernels = (q8.KERNEL, q8.QUANT_KERNEL, ln.FWD_KERNEL, fa.KERNEL)
    before = {k: k.launches for k in kernels}
    predictor = make(model)(_ChunkDocs(tok), save_dump=True)
    torch.cuda.synchronize()
    n = predictor.stats["batches"]
    L = 2
    assert {k: k.launches - before[k] for k in kernels} == {
        q8.KERNEL: (6 * L + 5) * n, q8.QUANT_KERNEL: (2 * L + 1) * n,
        ln.FWD_KERNEL: (2 * L + 1) * n, fa.KERNEL: L * n}
    assert predictor.stats["chunks"] == sum(map(len, _ChunkDocs(tok).docs))


# -- data parallelism ------------------------------------------------------------

@pytest.mark.cuda
def test_nccl_one_rank_bucketed_all_reduce_round_trip(cuda):
    """A one-rank NCCL group: the bucketed gradient all-reduce (a missing
    gradient summed as zeros) and the parameter broadcast give back their
    inputs bit for bit. This shows the backend runs the bucketed path; it
    says nothing of several cards."""
    from ml_recipe_tpu_torch.parallel import collectives
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from torch_ddp_worker import free_port

    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
        backend="nccl", device=torch.device("cuda", 0))
    try:
        assert pdist.backend() == "nccl" and pdist.process_count() == 1
        g = torch.Generator(device=cuda).manual_seed(0)
        params = [(f"p{i}", torch.nn.Parameter(
            torch.randn(n, device=cuda, generator=g)))
            for i, n in enumerate([5, 1 << 20, 7, 3 << 20, 1, 333])]
        for name, p in params[:-1]:
            p.grad = torch.randn(p.shape, device=cuda, generator=g)
        want = {n: (p.grad.clone() if p.grad is not None
                    else torch.zeros_like(p)) for n, p in params}
        assert collectives.all_reduce_gradients(params,
                                                bucket_numel=1 << 21) == 3
        for name, p in params:
            assert torch.equal(p.grad, want[name]), name
        before = {n: p.detach().clone() for n, p in params}
        assert collectives.broadcast_parameters(params,
                                                bucket_numel=1 << 21) == 3
        for name, p in params:
            assert torch.equal(p.detach(), before[name]), name
    finally:
        pdist.shutdown()


# f32 gradients of the same global micro-batches through cuBLAS products
# and the attention kernels at 2 rows per rank against 4 in one process,
# and the gradient sum split at the all-reduce; a missing all-reduce is
# ~0.5 (tests/test_torch_ddp.py)
DP_GRAD_REL_L2 = 1e-4


@pytest.mark.cuda
def test_two_ranks_over_gloo_on_the_card_equal_the_one_process_step(
        cuda, tmp_path):
    """Two ranks share the card and reduce CUDA tensors over gloo, through
    the tiny trainer of ``tests/torch_ddp_worker.py`` (kernel attention and
    LayerNorm): the replicas end bit-identical, and the first step's summed
    gradient is the one-process step's on the regrouped global batch."""
    import torch_ddp_worker as worker

    for rc, err in worker.worker_pairs("trainer", out=tmp_path,
                                       device="cuda")[0]:
        assert rc == 0, err[-3000:]
    record = [torch.load(tmp_path / "trainer" / f"rank{r}.pt")
              for r in range(2)]
    for name in record[0]["params"]:
        assert torch.equal(record[0]["params"][name],
                           record[1]["params"][name]), name
    ref = worker.oracle(tmp_path, record, "cuda")
    rel = worker.rel_l2(record[0]["grads"], ref.grads)
    assert rel <= DP_GRAD_REL_L2, rel
    for got, want in zip(record[0]["values"], ref.values):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


# -- the training options: loss scaling and AdaMod on the card -----------------

# a micro-batch's unscaled gradient at scale 2^15 against scale 1: a power
# of two scales every bf16 and f32 value exactly, so only reductions whose
# order follows the scheduling of atomics may differ (chip_smoke.py's remat
# gate); a scale never undone misses by 2^15
LS_GRAD_REL_L2 = 1e-5


def _bf16_micro_batch(tmp_path, cuda):
    """A bf16 tiny model (f32 master weights, the kernels' head dim 32,
    the fused LayerNorm), its loss, and 4 rows of the workers' items."""
    import torch_ddp_worker as worker
    from ml_recipe_tpu_torch.data.collate import make_collate_fun
    from ml_recipe_tpu_torch.losses import build_loss
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, init_weights
    from ml_recipe_tpu_torch.tokenizer import Tokenizer
    from helpers import write_vocab

    tok = Tokenizer("bert", str(write_vocab(tmp_path)), lowercase=True)
    cfg = EncoderConfig(vocab_size=len(tok), **worker.TINY_MODEL)
    model = QAModel(cfg, dtype=torch.bfloat16, device=cuda, ln_impl="fused")
    init_weights(model, torch.Generator().manual_seed(0))
    data = worker.VariedDataset(tok, 4, seed=1)
    inputs, labels = make_collate_fun(tok, max_seq_len=worker.MAX_SEQ_LEN)(
        [data[i] for i in range(4)])[:2]
    return (model, build_loss(worker.trainer_params()),
            {k: torch.from_numpy(v).to(cuda) for k, v in inputs.items()},
            {k: torch.from_numpy(v).to(cuda) for k, v in labels.items()})


@pytest.mark.cuda
def test_loss_scale_unscaled_gradients_are_exact_on_the_card(cuda, tmp_path):
    from ml_recipe_tpu_torch.train import loss_scale as ls

    model, loss, inputs, labels = _bf16_micro_batch(tmp_path, cuda)
    flat = []
    for state in (ls.init_state("dynamic"), ls.init_state(1.0)):
        model.zero_grad(set_to_none=True)
        before = (fa.BWD_KERNEL.launches, ln.BWD_KERNEL.launches)
        gen = torch.Generator(device=cuda).manual_seed(7)
        preds = model(input_ids=inputs["input_ids"].long(),
                      attention_mask=inputs["attention_mask"],
                      token_type_ids=inputs["token_type_ids"].long(),
                      generator=gen)
        total, _ = loss(preds, labels)
        ls.scale_loss(total, state).backward()
        # the scaled gradient went through both backward kernels
        assert fa.BWD_KERNEL.launches - before[0] == 2
        assert ln.BWD_KERNEL.launches - before[1] == 5
        grads = [p.grad for p in model.parameters()]
        ls.unscale_(grads, state)
        assert ls.all_finite(grads)
        flat.append(torch.cat([g.float().reshape(-1) for g in grads]))
    rel = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    assert rel <= LS_GRAD_REL_L2, rel


@pytest.mark.cuda
def test_planted_overflow_leaves_the_step_bit_identical_on_the_card(
        cuda, tmp_path):
    """The dynamic state at 2^127 and an infinite gradient planted in the
    classifier bias: the step changes no parameter, moment or count, and
    the scale backs off to 2^126."""
    import torch_ddp_worker as worker
    from ml_recipe_tpu_torch.train import loss_scale as ls

    trainer = worker.tiny_trainer(tmp_path, "cuda", options=worker.OPTIONS)
    batch = trainer.collate_fun([trainer.train_dataloader.dataset[i]
                                 for i in range(worker.TRAIN_BATCH)])
    inputs, labels = ({k: torch.from_numpy(v).to(cuda) for k, v in t.items()}
                      for t in batch[:2])
    trainer.train_step(inputs, labels)      # moments that are not zero
    opt = trainer.optimizer

    def state():
        return ([p.detach().clone() for p in opt.params.values()]
                + [t.clone() for k in ("exp_avg", "exp_avg_sq", "exp_avg_lr")
                   for t in getattr(opt, k).values()], opt.count)

    before = state()
    trainer.loss_scale = ls.LossScaleState(2.0 ** 127, 5, True)
    hook = trainer.model.classifier.bias.register_hook(
        lambda g: torch.full_like(g, float("inf")))
    try:
        values = trainer.train_step(inputs, labels)
    finally:
        hook.remove()
    after = state()
    assert values["grads_finite"] == 0.0
    assert trainer.loss_scale == ls.LossScaleState(2.0 ** 126, 0, True)
    assert after[1] == before[1] == 1
    assert all(torch.equal(a, b) for a, b in zip(after[0], before[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamod", "adam"])
def test_optimizer_step_on_the_card_matches_the_cpu(cuda, optimizer):
    """Five steps of the chain on CUDA tensors against the same steps on
    the CPU: the same f32 elementwise arithmetic, so equal but for the
    last bit of a square root or a division."""
    from types import SimpleNamespace

    from ml_recipe_tpu_torch.train.optim import build_optimizer

    tp = SimpleNamespace(optimizer=optimizer, lr=1e-2, weight_decay=0.1,
                         warmup_coef=0.3, finetune=False)
    rng = np.random.default_rng(0)
    shapes = {"transformer.layer_0.attention.query.weight": (64, 64),
              "transformer.layer_0.attention.query.bias": (64,),
              "transformer.embeddings.layer_norm.weight": (64,),
              "classifier.weight": (5, 64)}
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    sides = {}
    for device in ("cpu", "cuda"):
        params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()).to(device))
                  for n, v in init.items()}
        opt = build_optimizer(tp, params, num_training_steps=10)
        grads_rng = np.random.default_rng(1)
        for _ in range(5):
            opt.step({n: torch.from_numpy(grads_rng.normal(size=s).astype(
                np.float32)).to(device) for n, s in shapes.items()})
        sides[device] = {n: p.detach().cpu() for n, p in params.items()}
    for name in shapes:
        torch.testing.assert_close(sides["cuda"][name], sides["cpu"][name],
                                   rtol=1e-6, atol=1e-7)


# -- the serving caches and the kernel build counters (fleet slice) ------------


@pytest.mark.cuda
def test_kernel_build_counts_an_nvcc_run_as_a_miss_and_a_load_as_a_hit(
        cuda, tmp_path, monkeypatch):
    from ml_recipe_tpu_torch.ops import aot, cuda_build

    # an empty store of its own (ops/aot.py), restored after the test
    monkeypatch.setattr(aot, "_instance", aot.ProgramCache(
        cache_dir=tmp_path / "build", enabled=True))
    before = cuda_build.build_counts()
    first = cuda_build.CudaLibrary("layer_norm.cu", ln._declare)
    first.lib()  # nothing in the empty store: nvcc runs
    mid = cuda_build.build_counts()
    assert (mid["misses"] - before["misses"], mid["hits"] - before["hits"]) \
        == (1, 0)
    assert first.built and first.outcome == "miss"
    assert [p.name for p in (tmp_path / "build").rglob("*.ptaot")] == [
        "layer_norm.ptaot"]
    again = cuda_build.CudaLibrary("layer_norm.cu", ln._declare)
    again.lib()  # the library is there now: loaded, not built
    after = cuda_build.build_counts()
    assert (after["misses"] - mid["misses"], after["hits"] - mid["hits"]) \
        == (0, 1)
    assert not again.built and again.outcome == "hit"
    assert aot.main(["--cache_dir", str(tmp_path / "build"), "--verify"]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ln_impl,quantize", [("xla", "off"),
                                              ("fused", "int8")])
def test_cached_engine_hot_equals_cold_on_the_card(cuda, tmp_path, ln_impl,
                                                   quantize):
    from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
    from ml_recipe_tpu_torch.serve.cache import params_fingerprint
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    model, tok, _ = _predictor_setup(tmp_path, dtype=torch.bfloat16,
                                     ln_impl=ln_impl, quantize=quantize)
    rng = np.random.default_rng(5)
    words = [f"tok{4 * int(i) + 1}" for i in rng.integers(1, 48, 400)]
    document = " ".join(words)
    engine = QAEngine(model, tok, grid=BucketGrid.from_spec("4x128,8x128"),
                      max_batch_delay_ms=2, max_question_len=16,
                      doc_stride=64, serve_cache_bytes=1 << 20,
                      doc_cache_bytes=1 << 20)
    try:
        report = engine.warmup()
        assert report["attention_route"] == "fused"
        # the fingerprint sliced the card's tensors: same weights, same value
        assert params_fingerprint(model) == engine._fingerprint
        before = fa.KERNEL.launches
        cold = engine.submit("tok3 tok5 tok7 ?", document).result(timeout=60)
        launched = fa.KERNEL.launches - before
        batches = engine.m_batches.value
        hot = engine.submit("tok3 tok5 tok7 ?", document).result(timeout=60)
        assert cold.n_chunks >= 3 and launched > 0
        assert hot.to_json() | {"latency_ms": 0} == \
            cold.to_json() | {"latency_ms": 0}
        assert engine.m_batches.value == batches
        assert fa.KERNEL.launches - before == launched  # no device work
        stats = engine.cache_stats()
        assert stats["chunk"]["hits"] == cold.n_chunks
        assert stats["doc"]["hits"] == 1
        page = engine.render_metrics()
        assert "qa_kernel_build_misses_total" in page
        assert 'qa_kernel_launches_total{kernel="fused_attention_fwd"}' in page
    finally:
        engine.close()


@pytest.mark.cuda
def test_profiler_window_captures_the_hand_written_kernels(cuda, tmp_path):
    """``--trace``'s capture (``metrics.trace.ProfilerWindow``) over one
    bf16 micro-batch forward+backward with the fused LayerNorm: the Chrome
    trace holds the attention pair's and the LayerNorm pair's kernels by
    name, once per launch of their wrappers."""
    import json

    from ml_recipe_tpu_torch.metrics.trace import ProfilerWindow

    model, loss, inputs, labels = _bf16_micro_batch(tmp_path, cuda)
    window = ProfilerWindow(tmp_path / "trace", start=0, steps=1,
                            device=cuda)
    before = (fa.KERNEL.launches, fa.BWD_KERNEL.launches,
              ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches)
    # a capture without CUDA activity moves on to the next step
    while not window.done:
        window.on_step_start()
        preds = model(input_ids=inputs["input_ids"].long(),
                      attention_mask=inputs["attention_mask"],
                      token_type_ids=inputs["token_type_ids"].long(),
                      generator=torch.Generator(device=cuda).manual_seed(3))
        loss(preds, labels)[0].backward()
        window.on_step_end()
    launched = [now - was for now, was in zip(
        (fa.KERNEL.launches, fa.BWD_KERNEL.launches,
         ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches), before)]
    steps = window.empty_captures + 1
    assert launched == [2 * steps, 2 * steps, 5 * steps, 5 * steps]
    assert window.device_events > 0
    events = json.loads(open(window.path).read())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    count = lambda key, skip=None: sum(
        key in n and not (skip and skip in n) for n in kernels)
    assert count("fused_attention_fwd") == 2
    assert count("fused_attention_bwd_dq") == 2    # one per backward launch
    assert count("layer_norm_fwd") == 5
    assert count("layer_norm_bwd", skip="_sum") == 5


# -- the warm-up plane: bucket graphs, the memory pre-flight ------------------


def _graph_engine(tmp_path, ln_impl, quantize, monkeypatch):
    from ml_recipe_tpu_torch.ops import aot
    from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    monkeypatch.setattr(aot, "_instance", aot.ProgramCache(enabled=True))
    model, tok, _ = _predictor_setup(tmp_path, dtype=torch.bfloat16,
                                     ln_impl=ln_impl, quantize=quantize)
    engine = QAEngine(model, tok, grid=BucketGrid.from_spec("4x64,4x128,8x128"),
                      max_batch_delay_ms=2, max_question_len=16, doc_stride=64)
    return engine, tok


def _real_batch(tok, batch, seq, seed):
    """Ragged [CLS] question [SEP] body [SEP] rows, padded: a traffic
    batch's ids."""
    rng = np.random.default_rng(seed)
    ids = np.full((batch, seq), tok.pad_token_id, np.int32)
    for r in range(batch):
        n = int(rng.integers(12, seq + 1))
        row = rng.integers(110, 300, n)
        row[0], row[7], row[n - 1] = (tok.cls_token_id, tok.sep_token_id,
                                      tok.sep_token_id)
        ids[r, :n] = row
    return {"input_ids": ids}


@pytest.mark.cuda
@pytest.mark.parametrize("ln_impl,quantize", [("xla", "off"),
                                              ("fused", "int8")])
def test_bucket_graph_replay_equals_eager(cuda, tmp_path, monkeypatch,
                                          ln_impl, quantize):
    """Each kept bucket's CUDA graph, replayed on a real batch, gives the
    eager forward's ``[6, B]`` bit for bit, and each replay adds to the
    kernels' counts what one eager forward launches."""
    from ml_recipe_tpu_torch.serve.engine import kernel_launches

    engine, tok = _graph_engine(tmp_path, ln_impl, quantize, monkeypatch)
    try:
        report = engine.warmup(hbm_preflight=False)
        assert report["dispatch"] == "graph"
        assert set(report["graphs"]) == {"4x64", "4x128", "8x128"}
        for i, bucket in enumerate(engine.grid):
            inputs = _real_batch(tok, bucket.batch, bucket.seq, seed=i)
            c0 = kernel_launches()
            eager = engine.run_packed(inputs)
            c1 = kernel_launches()
            graph = engine._dispatch(bucket.batch, bucket.seq, inputs)
            c2 = kernel_launches()
            again = engine._dispatch(bucket.batch, bucket.seq,
                                     _real_batch(tok, bucket.batch,
                                                 bucket.seq, seed=i))
            assert np.array_equal(graph, eager), bucket
            assert np.array_equal(again, eager), bucket
            per_eager = {k: c1[k] - c0[k] for k in c0}
            per_replay = {k: c2[k] - c1[k] for k in c0}
            assert per_replay == per_eager, bucket
            assert {k: n for k, n in per_eager.items() if n} == \
                report["graphs"][str(bucket)]
            assert per_eager["fused_attention_fwd"] == 2   # 2 layers
            if quantize == "int8":
                assert per_eager["q8_matmul"] > 0 and \
                    per_eager["q8_quantize"] > 0
        # traffic through the batcher runs the graphs
        before = engine.device_forwards
        result = engine.submit("tok3 tok5 ?", " ".join(
            f"tok{4 * i + 1}" for i in range(60))).result(timeout=60)
        assert result.n_chunks >= 1
        assert engine.device_forwards > before
    finally:
        engine.close()


@pytest.mark.cuda
def test_store_off_dispatches_eagerly_on_the_card(cuda, tmp_path,
                                                  monkeypatch):
    from ml_recipe_tpu_torch.ops import aot

    engine, tok = _graph_engine(tmp_path, "xla", "off", monkeypatch)
    monkeypatch.setattr(aot, "_instance", aot.ProgramCache(enabled=False))
    try:
        report = engine.warmup(hbm_preflight=False)
        assert report["dispatch"] == "eager" and engine._graphs == {}
    finally:
        engine.close()


_FAILED_CAPTURE = """
import sys, torch
from pathlib import Path
sys.path.insert(0, "tests")
from test_torch_cuda import _graph_engine

class _Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

engine, tok = _graph_engine(Path(sys.argv[1]), "xla", "off", _Patch())
score = engine._score

def syncing(packed):
    out = score(packed)
    out[0, 0].item()          # a host sync: illegal under capture
    return out

engine._score = syncing
try:
    engine.warmup(hbm_preflight=False)
except RuntimeError as e:   # torch's AcceleratorError is one
    print("RAISED", type(e).__name__, repr(str(e)[:200]), len(engine._graphs))
    sys.exit(0)
print("NOT RAISED", engine.warmup_report)
sys.exit(1)
"""


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, tmp_path):
    """A forward that cannot be captured (a host read of a device value)
    fails the warm-up: no quiet fall back to eager launches. In a process of
    its own: a failed capture leaves the CUDA generator of that process
    mid-capture."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE,
                           str(tmp_path)], cwd=str(repo), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.startswith("RAISED ") and proc.stdout.strip(
        ).endswith(" 0"), proc.stdout


@pytest.mark.cuda
def test_serve_preflight_measures_and_drops_on_the_card(cuda, tmp_path,
                                                        monkeypatch):
    engine, tok = _graph_engine(tmp_path, "xla", "off", monkeypatch)
    try:
        needs = {str(b): engine.preflight_predict_step(b)["bytes"]
                 for b in engine.grid}
        assert needs["4x64"] < needs["4x128"] < needs["8x128"]
        limit = (needs["4x128"] + needs["8x128"]) // 2
        report = engine.warmup(limit_bytes=limit)
        assert report["dropped"] == ["8x128"]
        assert report["buckets"] == ["4x64", "4x128"]
        assert all(v["limit"] == limit for v in report["preflight"].values())
        result = engine.submit("tok3 tok5 ?", " ".join(
            f"tok{4 * i + 1}" for i in range(300))).result(timeout=60)
        assert result.n_chunks >= 2
    finally:
        engine.close()


@pytest.mark.cuda
def test_train_preflight_that_fits_is_bit_identical_on_the_card(cuda,
                                                                tmp_path):
    """Dropout 0.1, bf16 on the card: a run with the measured pre-flight
    (its probe fits the card) equals the same run without it bit for bit."""
    from helpers import write_vocab
    from ml_recipe_tpu_torch.data.collate import make_collate_fun
    from ml_recipe_tpu_torch.data.datasets import DummyDataset
    from ml_recipe_tpu_torch.losses import build_loss
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, init_weights
    from ml_recipe_tpu_torch.tokenizer import Tokenizer
    from ml_recipe_tpu_torch.train.trainer import Trainer
    import torch_ddp_worker as worker

    tok = Tokenizer("bert", str(write_vocab(tmp_path)), lowercase=True)
    runs = []
    for preflight in (False, True):
        cfg = EncoderConfig(vocab_size=len(tok), **{
            **worker.TINY_MODEL, "hidden_dropout_prob": 0.1,
            "attention_probs_dropout_prob": 0.1})
        model = QAModel(cfg, dtype=torch.bfloat16, device=cuda,
                        ln_impl="fused")
        init_weights(model, torch.Generator().manual_seed(0))
        data = DummyDataset(tokenizer=tok, max_seq_len=worker.MAX_SEQ_LEN,
                            max_question_len=worker.MAX_Q_LEN, dataset_len=16,
                            rng=np.random.default_rng(0))
        trainer = Trainer(model, build_loss(worker.trainer_params()),
                          make_collate_fun(tok, max_seq_len=worker.MAX_SEQ_LEN),
                          trainer_params=worker.trainer_params(),
                          train_dataset=data, n_epochs=1, train_batch_size=8,
                          batch_split=2, n_jobs=2, seed=0,
                          hbm_preflight=preflight)
        trainer.train()
        runs.append(trainer)
    off, on = runs
    assert on.preflight_probes == 1 and off.preflight_probes == 0
    report = on.preflight_report
    assert report["applied"] is False and 0 < report["bytes"] < \
        report["limit_bytes"]
    assert [h["loss"] for h in on.history] == [h["loss"] for h in off.history]
    for (name, a), (_, b) in zip(off.model.state_dict().items(),
                                 on.model.state_dict().items()):
        assert torch.equal(a, b), name


_LOWERED_CAP = """
import gc, json, sys, torch
import numpy as np
from pathlib import Path
sys.path.insert(0, "tests")
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import DummyDataset
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, init_weights
from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
from ml_recipe_tpu_torch.serve.engine import QAEngine
from ml_recipe_tpu_torch.tokenizer import Tokenizer, write_synthetic_bert_vocab
from ml_recipe_tpu_torch.train.trainer import Trainer
import torch_ddp_worker as worker

tmp = Path(sys.argv[1])
tok = Tokenizer("bert", write_synthetic_bert_vocab(tmp / "vocab.txt", size=300),
                lowercase=True)
total = torch.cuda.get_device_properties(0).total_memory


def cfg(dropout):
    return EncoderConfig(vocab_size=len(tok), hidden_size=768, num_layers=2,
                         num_heads=12, intermediate_size=3072,
                         max_position_embeddings=512, hidden_dropout_prob=dropout,
                         attention_probs_dropout_prob=dropout)


def cap(extra):
    # the process may hold what it holds now and ``extra`` bytes more
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_reserved() + extra) / total)


# serving: the 128-row bucket's forward cannot run under the cap
model = QAModel(cfg(0.0), dtype=torch.bfloat16, device="cuda")
init_weights(model, torch.Generator().manual_seed(0))
engine = QAEngine(model.eval(), tok, grid=BucketGrid.from_spec("8x512,128x512"),
                  max_batch_delay_ms=2, max_question_len=16, doc_stride=128)
needs = {str(b): engine.preflight_predict_step(b) for b in engine.grid}
assert all(v["fits"] for v in needs.values()), needs
extra = {k: v["bytes"] - engine._weight_bytes for k, v in needs.items()}
assert extra["128x512"] > 8 * extra["8x512"], extra
cap(extra["128x512"] // 2)
report = engine.warmup()
serve = {"needs": extra, "dropped": report["dropped"],
         "buckets": report["buckets"], "preflight": report["preflight"]}
assert report["dropped"] == ["128x512"] and report["buckets"] == ["8x512"], serve
assert report["preflight"]["128x512"]["fits"] is False
assert report["preflight"]["128x512"]["out_of_memory"] is True
result = engine.submit("tok3 tok5 ?", " ".join(
    f"tok{4 * i + 1}" for i in range(900))).result(timeout=120)
assert result.n_chunks >= 2
engine.close()
torch.cuda.set_per_process_memory_fraction(1.0)
del engine, model
gc.collect()
torch.cuda.empty_cache()

# training: the whole batch's step cannot run under the cap
model = QAModel(cfg(0.1), dtype=torch.bfloat16, device="cuda", ln_impl="fused")
init_weights(model, torch.Generator().manual_seed(0))
data = DummyDataset(tokenizer=tok, max_seq_len=384, max_question_len=16,
                    dataset_len=64, rng=np.random.default_rng(0))
collate = make_collate_fun(tok, max_seq_len=384)
trainer = Trainer(model, build_loss(worker.trainer_params()), collate,
                  trainer_params=worker.trainer_params(), train_dataset=data,
                  n_epochs=1, train_batch_size=64, batch_split=1, n_jobs=2,
                  seed=0, hbm_preflight=True)
inputs, labels = collate([data[i] for i in range(64)])[:2]
probe = trainer._probe_step(trainer._placed(inputs), trainer._placed(labels))
whole = probe.output_size_in_bytes + probe.temp_size_in_bytes
params = sum(p.numel() * p.element_size() for p in model.parameters())
cap(int(0.3 * whole) + 3 * params)
trainer.train()
rep = trainer.preflight_report
train = {"whole_step_bytes": whole, "batch_split_before": rep["batch_split_before"],
         "batch_split": rep["batch_split"], "applied": rep["applied"],
         "loss": [h["loss"] for h in trainer.history]}
assert rep["applied"] is True and rep["batch_split_before"] == 1, train
assert rep["batch_split"] > 1 and trainer.batch_split == rep["batch_split"], train
assert train["loss"] and all(np.isfinite(train["loss"])), train
print("CAPPED", json.dumps({"serve": serve, "train": train}, default=str))
"""


@pytest.mark.cuda
def test_preflight_under_a_lowered_process_cap_drops_and_raises_the_split(
        cuda, tmp_path):
    """No injected limit: the process's own cap is lowered
    (``torch.cuda.set_per_process_memory_fraction``) under the need of the
    largest serving bucket and of the whole training batch. The measured
    forward and step run out of memory, and that is the verdict: the bucket
    is dropped and ``batch_split`` is raised, then the engine answers and
    the raised split trains. In a process of its own: the cap and the
    out-of-memory errors stay there."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _LOWERED_CAP, str(tmp_path)],
                          cwd=str(repo), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "CAPPED " in proc.stdout, proc.stdout[-3000:]
    print(proc.stdout.strip().splitlines()[-1])    # the needs and decisions
