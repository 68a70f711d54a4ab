"""Fused attention: the Hopper kernels' wrappers and their plain versions.

Replaces the attention kernels of the TPU package's three regimes, which
compute one function and differ only in how they tile it for VMEM (the
dispatcher, ``ops/attention.py``, says which lengths each stands for):

- the forwards ``_fused_fwd_kernel``, ``_blocked_fwd_kernel``
  (``ml_recipe_tpu/ops/flash_attention.py``) and ``_stream_fwd_kernel``
  (``ml_recipe_tpu/ops/flash_streaming.py``) by ``csrc/fused_attention_fwd.cu``;
- the backwards ``_fused_bwd_kernel`` (math ``_attention_bwd_math``),
  ``_blocked_bwd_kernel``, ``_stream_dq_kernel`` and ``_stream_dkv_kernel`` by
  ``csrc/fused_attention_bwd.cu``.

Each kernel's design note (what bounds it on the card and what the design
does about it) heads its source; both keep the [L, L] scores on chip at any
L.

Semantics shared by the kernels and their plain versions, which are the
TPU kernels':

- scores ``q k^T / sqrt(D)`` in f32; disallowed scores are ``-1e30`` (never
  ``-inf``, so all-masked rows stay finite);
- the key mask (``mask > 0``) or, ``segmented``, the block-diagonal grid
  ``seg[row] == seg[col] != 0``; with ``seg_split`` the ids are one
  ``[B, 2L]`` plane, the q-side ids first (``_stream_mask_tile``);
- the softmax denominator is summed BEFORE dropout; kept probabilities are
  scaled by ``1/(1-rate)``, cast to v's dtype before the PV product, and
  the divide by the denominator is folded into the output;
- the dropout keep-bit ``hash_uniform(((row_base + row)*L_hash + col_base +
  col) ^ (seed[b] + h*-1640531527)) >= rate`` with the per-row seeds of
  :func:`row_seeds`, in 32-bit wraparound arithmetic; a single-chip call
  has ``base = (0, 0)`` and ``L_hash = L`` (``_keep_tile``, ``_zero_base``);
- the forward's optional per-row logsumexp ``[B, H, L]`` f32, from which
  the backward recomputes the probabilities, with the row term of the
  softmax backward from the delta identity ``sum(g * out)``.

:func:`fused_attention` is the entry point. Without a gradient to track it
runs the forward alone (one forward launch, no lse). When grad mode is on
and q, k or v requires grad it goes through :class:`FusedAttention`, the
``torch.autograd.Function`` around the kernel pair: a CUDA tensor launches
the kernels (their wrappers raise on anything they do not take), a CPU
tensor runs the plain versions. The plain versions are also what
``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from .cuda_build import CudaLibrary, Kernel

NEG_INF = -1e30          # the TPU kernel's masked score (_NEG_INF)
KERNEL_HEAD_DIMS = (32, 64, 128)

_PRIME = -1640531527     # 2654435761 as int32 (0x9E3779B9)
_M32 = 0xFFFFFFFF

SeedLike = Union[None, int, torch.Tensor]
BaseLike = Union[None, Sequence[int], torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2**32): the product
    is split at bit 16 so no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_uniform(x: torch.Tensor) -> torch.Tensor:
    """``ml_recipe_tpu.ops.flash_attention.hash_uniform`` on the 32-bit
    patterns held in int64 ``x`` (any value; only its low 32 bits count):
    uniform float32 in [0, 1) from the 3-stage finalizer."""
    x = x & _M32
    x = _mul32(x, 0xCC9E2D51)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x1B873593)
    u24 = (x >> 7) & 0x00FFFFFF
    return u24.to(torch.float32) * (1.0 / (1 << 24))


def uniform_grid(seeds: torch.Tensor, H: int, L: int, row_offset: int = 0,
                 col_offset: int = 0,
                 L_hash: Optional[int] = None) -> torch.Tensor:
    """``[B, H, L, L]`` dropout uniforms: ``_uniform_grid(seed[b], h,
    L_hash, rows=L, row_offset, cols=L, col_offset)`` of the TPU kernels
    for every (batch row, head). ``L_hash`` defaults to ``L``."""
    dev = seeds.device
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    L_hash = L if L_hash is None else int(L_hash)
    x = ((idx[:, None] + int(row_offset)) * L_hash
         + (idx[None, :] + int(col_offset)))                   # [L, L]
    heads = torch.arange(H, dtype=torch.int64, device=dev)
    key = (seeds.to(torch.int64)[:, None] + heads[None, :] * _PRIME) & _M32
    return hash_uniform(x[None, None] ^ key[:, :, None, None])


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 the way int32 arithmetic wraps."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def row_seeds(seed: SeedLike, B: int, H: int,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Per-batch-row int32 dropout seeds (``_row_seeds`` of the TPU
    package): a ``[B]`` seed vector is taken as given when B > 1, otherwise
    row ``b`` gets ``seed[0] + b*H*-1640531527`` with int32 wraparound."""
    if seed is None:
        seed = 0
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(-1).to(device)
    if seed.numel() == B and B > 1:
        return _as_int32(seed)
    rows = torch.arange(B, dtype=torch.int64, device=seed.device)
    return _as_int32(seed[0] + rows * (H * _PRIME))


def _split_ids(mask: torch.Tensor, seg_split: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q-side ids, k-side ids)`` of a mask operand: the [B, L] mask for
    both, or the two halves of a ``seg_split`` [B, 2L] plane."""
    if seg_split:
        L = mask.shape[1] // 2
        return mask[:, :L], mask[:, L:]
    return mask, mask


def _allowed(mask: torch.Tensor, segmented: bool,
             seg_split: bool = False) -> torch.Tensor:
    """[B, 1, Lq, Lk] attend-permission grid (``_allowed_grid``)."""
    qids, kids = _split_ids(mask, seg_split)
    if segmented:
        grid = (qids[:, :, None] == kids[:, None, :]) & (kids[:, None, :] > 0)
        return grid[:, None]
    return (kids > 0)[:, None, None, :]


def _coords(base: BaseLike, L_hash: Optional[int], L: int
            ) -> Tuple[int, int, int]:
    """``(row_base, col_base, L_hash)`` as plain ints: ``base`` is None (the
    single-chip ``(0, 0)``), a pair of ints or a (2,) tensor."""
    if base is None:
        row_base, col_base = 0, 0
    else:
        if isinstance(base, torch.Tensor):
            base = base.reshape(-1).tolist()
        row_base, col_base = (int(x) for x in base)
    L_hash = L if L_hash is None else int(L_hash)
    for name, x in (("row base", row_base), ("column base", col_base),
                    ("L_hash", L_hash)):
        if not -(1 << 31) <= x < (1 << 31):
            raise ValueError(f"{name} {x} does not fit int32")
    if L_hash < 1:
        raise ValueError(f"L_hash must be positive; got {L_hash}")
    return row_base, col_base, L_hash


def fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
    segmented: bool = False, want_lse: bool = False, base: BaseLike = None,
    L_hash: Optional[int] = None, seg_split: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in plain PyTorch, on any device.

    ``q, k, v``: [B, L, H, D]; ``mask``: [B, L] key mask or segment ids
    ([B, 2L] q-side then k-side ids with ``seg_split``); ``seeds``: [B]
    int32 row seeds (:func:`row_seeds`, read when rate > 0); ``base``,
    ``L_hash``: where the call's rows and columns sit for the dropout hash
    (default ``(0, 0)`` and ``L``). Returns out [B, L, H, D] in q's dtype,
    and lse [B, H, L] f32 when ``want_lse``. Materialises the [B, H, L, L]
    scores: a reference, not a fast path."""
    B, L, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / D ** 0.5)
    s = torch.where(_allowed(mask, segmented, seg_split), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)                               # [B,H,L,1]
    if rate > 0.0:
        if seeds is None:
            raise ValueError("rate > 0 needs the [B] row seeds")
        row_base, col_base, L_hash = _coords(base, L_hash, L)
        u = uniform_grid(seeds.to(s.device), H, L, row_base, col_base, L_hash)
        e = torch.where(u >= rate, e * (1.0 / (1.0 - rate)), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    o = (o * (1.0 / l).permute(0, 2, 1, 3)).to(q.dtype).contiguous()
    if want_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def _declare_fwd(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_attention_fwd.argtypes = [
        vp, vp, vp,                       # q k v
        vp, vp, ctypes.c_longlong,        # qids kids ids_stride
        vp, vp, vp,                       # seeds out lse
        ci, ci, ci, ci, ci,               # B L H D is_bf16
        ci, ci, ci,                       # row_base col_base L_hash
        cf, cf, cf, ci,                   # scale rate keep_scale segmented
        vp,                               # stream
    ]
    lib.fused_attention_fwd.restype = ci
    lib.fused_attention_fwd_attrs.argtypes = [ci, ctypes.POINTER(ci)]
    lib.fused_attention_fwd_attrs.restype = ci


def _declare_bwd(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_attention_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp,           # q k v g out lse
        vp, vp, ctypes.c_longlong,        # qids kids ids_stride
        vp,                               # seeds
        vp, vp, vp, vp,                   # dq dk dv delta
        ci, ci, ci, ci, ci,               # B L H D is_bf16
        ci, ci, ci,                       # row_base col_base L_hash
        cf, cf, cf, ci,                   # scale rate keep_scale segmented
        vp,                               # stream
    ]
    lib.fused_attention_bwd.restype = ci
    lib.fused_attention_bwd_attrs.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.fused_attention_bwd_attrs.restype = ci


KERNEL = Kernel(CudaLibrary("fused_attention_fwd.cu", _declare_fwd))
BWD_KERNEL = Kernel(CudaLibrary("fused_attention_bwd.cu", _declare_bwd))

# the bf16 tensor-core kernels, by the name the profiler shows
TC_KERNELS = ("fused_attention_fwd_tc", "fused_attention_bwd_dkdv_tc",
              "fused_attention_bwd_dq_tc")


def tc_kernel_attributes(D: int) -> dict:
    """Registers, static and dynamic shared memory and local-memory bytes
    (stack and spills) of each bf16 tensor-core kernel at head dim ``D``,
    from ``cudaFuncGetAttributes`` on the built libraries (needs the card)."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {KERNEL_HEAD_DIMS}")
    result = {}
    for name in TC_KERNELS:
        attrs = (ctypes.c_int * 4)()
        if name.startswith("fused_attention_fwd"):
            err = KERNEL.library.lib().fused_attention_fwd_attrs(D, attrs)
        else:
            err = BWD_KERNEL.library.lib().fused_attention_bwd_attrs(
                D, int(name.endswith("dq_tc")), attrs)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes({name}<{D}>) failed: "
                               f"cudaError_t {err}")
        result[name] = dict(zip(("registers", "static_smem_bytes",
                                 "dynamic_smem_bytes", "local_bytes"), attrs))
    return result


def _check_operands(q, k, v, mask, seeds, rate, what: str, extra=(),
                    seg_split: bool = False, segmented: bool = False):
    """Raise on anything the kernels do not take; ``extra`` are further
    tensors that must match q's shape and dtype (g and out)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"{what} launches a CUDA kernel; got a tensor on {q.device} (use "
            f"fused_attention, which routes CPU tensors to the plain version)")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, L, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in extra:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"g and out must match q ({q.dtype} "
                             f"{tuple(q.shape)}); got {t.dtype} "
                             f"{tuple(t.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {KERNEL_HEAD_DIMS}")
    _check_mask(mask, B, L, segmented, seg_split)
    tensors = [q, k, v, mask, *extra]
    if rate > 0.0:
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
        if seeds is None or seeds.shape != (B,) or seeds.dtype != torch.int32:
            raise ValueError("rate > 0 needs int32 [B] row seeds")
        tensors.append(seeds)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}; one is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all operands must be contiguous")
    # the bf16 kernels copy rows of q, k, v (and g) 16 bytes at a time
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, *extra)):
        raise ValueError("bfloat16 q, k, v, g and out must start on a "
                         "16-byte boundary")


def _check_mask(mask, B: int, L: int, segmented: bool, seg_split: bool):
    if seg_split and not segmented:
        raise ValueError("seg_split splits segment ids: it needs segmented")
    width = 2 * L if seg_split else L
    if mask.shape != (B, width) or mask.dtype != torch.int32:
        raise ValueError(f"mask must be int32 [B, {'2L' if seg_split else 'L'}]"
                         f" = [{B}, {width}]; got {mask.dtype} "
                         f"{tuple(mask.shape)}")


def _ids_args(mask: torch.Tensor, L: int, seg_split: bool):
    """``(qids, kids, ids_stride)`` pointers and stride for the kernels."""
    ptr = mask.data_ptr()
    if seg_split:
        return ptr, ptr + L * mask.element_size(), 2 * L
    return ptr, ptr, L


def _keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def fused_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
    segmented: bool = False, want_lse: bool = False, base: BaseLike = None,
    L_hash: Optional[int] = None, seg_split: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch ``csrc/fused_attention_fwd.cu`` on CUDA tensors; same
    arguments and results as :func:`fused_attention_plain`. Raises on
    anything the kernel does not take (CPU tensors included). The result
    carries no autograd history: :class:`FusedAttention` adds it."""
    _check_operands(q, k, v, mask, seeds, rate, "fused_attention_cuda",
                    seg_split=seg_split, segmented=segmented)
    B, L, H, D = q.shape
    row_base, col_base, L_hash = _coords(base, L_hash, L)
    lib = KERNEL.library.lib()
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, L), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_ids_args(mask, L, seg_split),
            seeds.data_ptr() if rate > 0.0 else None, out.data_ptr(),
            lse.data_ptr() if want_lse else None,
            B, L, H, D, int(q.dtype == torch.bfloat16),
            row_base, col_base, L_hash,
            1.0 / D ** 0.5, float(rate), _keep_scale(rate),
            int(bool(segmented)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_attention_fwd launch failed: cudaError_t {err} "
            f"(B={B}, L={L}, H={H}, D={D}, {q.dtype})")
    KERNEL.launches += 1
    return (out, lse) if want_lse else out


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
    segmented: bool = False, base: BaseLike = None,
    L_hash: Optional[int] = None, seg_split: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, on any device: the
    TPU kernels' ``_attention_bwd_math`` / ``_stream_tile_ds`` with ``lse``
    and ``out`` given, step for step. ``g``, ``out``: [B, L, H, D] (g is
    cast to q's dtype); ``lse``: [B, H, L] f32 from the forward; ``mask``,
    ``base``, ``L_hash``, ``seg_split``: the forward's. Returns ``(dq, dk,
    dv)`` in q's dtype. Materialises [B, H, L, L] f32 grids: a reference,
    not a fast path."""
    B, L, H, D = q.shape
    scale = 1.0 / D ** 0.5
    g = g.to(q.dtype)
    allowed = _allowed(mask, segmented, seg_split)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(allowed, s, NEG_INF)
    p = torch.exp(s - lse[..., None])                   # pre-dropout
    if segmented:
        # all-masked pad rows: lse is -1e30 itself and exp(s - lse) would
        # be 1 on the very keys the grid forbids
        p = torch.where(allowed, p, 0.0)
    keep = None
    if rate > 0.0:
        if seeds is None:
            raise ValueError("rate > 0 needs the [B] row seeds")
        row_base, col_base, L_hash = _coords(base, L_hash, L)
        keep = uniform_grid(seeds.to(s.device), H, L, row_base, col_base,
                            L_hash) >= rate
        p_drop = torch.where(keep, p * _keep_scale(rate), 0.0)
    else:
        p_drop = p
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop.to(g.dtype).float(), g.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    if keep is not None:
        dp = torch.where(keep, dp * _keep_scale(rate), 0.0)
    row = (g.float() * out.float()).sum(dim=-1)         # [B, L, H]
    ds = p * (dp - row.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype))


def fused_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
    segmented: bool = False, base: BaseLike = None,
    L_hash: Optional[int] = None, seg_split: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused_attention_bwd.cu`` on CUDA tensors; same
    arguments and results as :func:`fused_attention_bwd_plain` (g must
    already be in q's dtype). Raises on anything the kernel does not take."""
    _check_operands(q, k, v, mask, seeds, rate, "fused_attention_bwd_cuda",
                    extra=(g, out), seg_split=seg_split, segmented=segmented)
    B, L, H, D = q.shape
    row_base, col_base, L_hash = _coords(base, L_hash, L)
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [B, H, L] = [{B}, {H}, "
                         f"{L}] on {q.device}; got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    lib = BWD_KERNEL.library.lib()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            *_ids_args(mask, L, seg_split),
            seeds.data_ptr() if rate > 0.0 else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, L, H, D, int(q.dtype == torch.bfloat16),
            row_base, col_base, L_hash,
            1.0 / D ** 0.5, float(rate), _keep_scale(rate),
            int(bool(segmented)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_attention_bwd launch failed: cudaError_t {err} "
            f"(B={B}, L={L}, H={H}, D={D}, {q.dtype})")
    BWD_KERNEL.launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The kernel pair under autograd (the port's ``_flash_core`` and
    ``_stream_core`` custom VJPs): the forward keeps its output and
    logsumexp, the backward runs the fused backward on them with the
    forward's ids and dropout coordinates. CUDA tensors launch the kernels,
    CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seeds, rate: float, segmented: bool,
                coords: tuple = (None, None, False)):
        base, L_hash, seg_split = coords
        fwd = (fused_attention_plain if q.device.type == "cpu"
               else fused_attention_cuda)
        out, lse = fwd(q, k, v, mask, seeds, rate, segmented, want_lse=True,
                       base=base, L_hash=L_hash, seg_split=seg_split)
        ctx.save_for_backward(q, k, v, mask, seeds, out, lse)
        ctx.rate, ctx.segmented, ctx.coords = rate, segmented, coords
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seeds, out, lse = ctx.saved_tensors
        base, L_hash, seg_split = ctx.coords
        g = g.to(q.dtype).contiguous()   # _bwd's g.astype(q.dtype)
        bwd = (fused_attention_bwd_plain if q.device.type == "cpu"
               else fused_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, g, out, lse, mask, seeds, ctx.rate,
                         ctx.segmented, base=base, L_hash=L_hash,
                         seg_split=seg_split)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None, seed: SeedLike = None,
    rate: float = 0.0, segmented: bool = False, want_lse: bool = False,
    base: BaseLike = None, L_hash: Optional[int] = None,
    seg_split: bool = False,
):
    """Fused attention over [B, L, H, D] with a [B, L] key mask (or segment
    ids when ``segmented``): the port's ``flash_attention`` at any L.

    ``seed``: an int or a (1,) / [B] int32 tensor keying the dropout mask
    (expanded by :func:`row_seeds`; ignored when ``rate == 0``). ``base``,
    ``L_hash`` and ``seg_split`` are the streaming kernels' contract (see
    ``ops/flash_streaming.py``); the defaults are a single-chip call. With
    grad mode on and q, k or v requiring grad, the call goes through
    :class:`FusedAttention` (``want_lse`` is then not offered); otherwise
    CUDA tensors run the forward kernel alone and CPU tensors its plain
    version."""
    B, L, H, _ = q.shape
    if mask is None:
        if seg_split:
            raise ValueError("seg_split needs the [B, 2L] segment ids")
        mask = torch.ones((B, L), dtype=torch.int32, device=q.device)
    mask = mask.to(torch.int32).contiguous()
    _check_mask(mask, B, L, segmented, seg_split)
    row_base, col_base, L_hash = _coords(base, L_hash, L)
    coords = ((row_base, col_base), L_hash, bool(seg_split))
    seeds = row_seeds(seed, B, H, q.device) if rate > 0.0 else None
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        if want_lse:
            raise ValueError("want_lse is for calls without autograd; the "
                             "differentiable path keeps the lse itself")
        return FusedAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), mask, seeds, float(rate),
                                    bool(segmented), coords)
    fwd = fused_attention_plain if q.device.type == "cpu" else fused_attention_cuda
    return fwd(q, k, v, mask, seeds, rate, segmented, want_lse,
               *coords)
