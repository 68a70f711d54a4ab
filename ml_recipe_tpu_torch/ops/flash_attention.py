"""Fused attention forward: the Hopper kernel's wrapper and its plain version.

Replaces ``ml_recipe_tpu/ops/flash_attention.py`` ``_fused_fwd_kernel``, the
TPU kernel that every serving bucket runs (L <= 512). The kernel is
``csrc/fused_attention_fwd.cu``; its design note (what bounds it on the card
and what the design does about it) heads that file. In short: at the serving
shapes the function moves 4*B*L*H*D elements and does 4*B*H*L^2*D
operations, so the memory rate bounds it; the kernel keeps the [L, L] scores
on chip and streams K/V tiles through shared memory with an online softmax.

Semantics shared by the kernel and :func:`fused_attention_plain`, which are
the TPU kernel's:

- scores ``q k^T / sqrt(D)`` in f32; disallowed scores are ``-1e30`` (never
  ``-inf``, so all-masked rows stay finite);
- the key mask (``mask > 0``) or, ``segmented``, the block-diagonal grid
  ``seg[row] == seg[col] != 0``;
- the softmax denominator is summed BEFORE dropout; kept probabilities are
  scaled by ``1/(1-rate)``, cast to v's dtype before the PV product, and the
  divide by the denominator is folded into the output;
- the dropout keep-bit ``hash_uniform((row*L + col) ^ (seed[b] +
  h*-1640531527)) >= rate`` with the per-row seeds of :func:`row_seeds`;
- optional per-row logsumexp ``[B, H, L]`` f32.

:func:`fused_attention` is the entry point: a CUDA tensor goes to the kernel
(through :func:`fused_attention_cuda`, which raises on anything else), a CPU
tensor to the plain version. The plain version is also what ``chip_smoke.py``
holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from .cuda_build import CudaLibrary

NEG_INF = -1e30          # the TPU kernel's masked score (_NEG_INF)
FUSED_MAX_LEN = 512      # the TPU's fully-fused regime (_FUSED_BWD_MAX_LEN)
KERNEL_HEAD_DIMS = (32, 64, 128)

_PRIME = -1640531527     # 2654435761 as int32 (0x9E3779B9)
_M32 = 0xFFFFFFFF

SeedLike = Union[None, int, torch.Tensor]


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


def uniform_grid(seeds: torch.Tensor, H: int, L: int) -> torch.Tensor:
    """``[B, H, L, L]`` dropout uniforms: ``_uniform_grid(seed[b], h, L)``
    of the TPU kernel for every (batch row, head)."""
    dev = seeds.device
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    x = idx[:, None] * L + idx[None, :]                        # [L, L]
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


def _allowed(mask: torch.Tensor, segmented: bool) -> torch.Tensor:
    """[B, 1, Lq, Lk] attend-permission grid (``_allowed_grid``)."""
    if segmented:
        grid = (mask[:, :, None] == mask[:, None, :]) & (mask[:, None, :] > 0)
        return grid[:, None]
    return (mask > 0)[:, None, None, :]


def fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
    segmented: bool = False, want_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in plain PyTorch, on any device.

    ``q, k, v``: [B, L, H, D]; ``mask``: [B, L] key mask or segment ids;
    ``seeds``: [B] int32 row seeds (:func:`row_seeds`, read when rate > 0).
    Returns out [B, L, H, D] in q's dtype, and lse [B, H, L] f32 when
    ``want_lse``. Materialises the [B, H, L, L] scores: a reference, not a
    fast path."""
    B, L, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / D ** 0.5)
    s = torch.where(_allowed(mask, segmented), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)                               # [B,H,L,1]
    if rate > 0.0:
        if seeds is None:
            raise ValueError("rate > 0 needs the [B] row seeds")
        u = uniform_grid(seeds.to(s.device), H, L)
        e = torch.where(u >= rate, e * (1.0 / (1.0 - rate)), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    o = (o * (1.0 / l).permute(0, 2, 1, 3)).to(q.dtype)
    if want_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,       # q k v mask seeds out lse
        ci, ci, ci, ci, ci,               # B L H D is_bf16
        cf, cf, cf, ci,                   # scale rate keep_scale segmented
        vp,                               # stream
    ]
    lib.fused_attention_fwd.restype = ci


class _Kernel:
    """The built library and the count of launches of its kernel."""

    def __init__(self):
        self.library = CudaLibrary("fused_attention_fwd.cu", _declare)
        self.launches = 0


KERNEL = _Kernel()


def fused_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
    segmented: bool = False, want_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch ``csrc/fused_attention_fwd.cu`` on CUDA tensors; same
    arguments and results as :func:`fused_attention_plain`. Raises on
    anything the kernel does not take (CPU tensors included)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"fused_attention_cuda launches a CUDA kernel; got a tensor on "
            f"{q.device} (use fused_attention, which routes CPU tensors to "
            f"the plain version)")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, L, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, H, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {KERNEL_HEAD_DIMS}")
    if mask.shape != (B, L) or mask.dtype != torch.int32:
        raise ValueError(f"mask must be int32 [B, L] = [{B}, {L}]; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    tensors = [q, k, v, mask]
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

    lib = KERNEL.library.lib()
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, L), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            seeds.data_ptr() if rate > 0.0 else None, out.data_ptr(),
            lse.data_ptr() if want_lse else None,
            B, L, H, D, int(q.dtype == torch.bfloat16),
            1.0 / D ** 0.5, float(rate),
            1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
            int(bool(segmented)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_attention_fwd launch failed: cudaError_t {err} "
            f"(B={B}, L={L}, H={H}, D={D}, {q.dtype})")
    KERNEL.launches += 1
    return (out, lse) if want_lse else out


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None, seed: SeedLike = None,
    rate: float = 0.0, segmented: bool = False, want_lse: bool = False,
):
    """Fused attention over [B, L, H, D] with a [B, L] key mask (or segment
    ids when ``segmented``): the port's ``flash_attention``.

    ``seed``: an int or a (1,) / [B] int32 tensor keying the dropout mask
    (expanded by :func:`row_seeds`; ignored when ``rate == 0``). CUDA
    tensors run the kernel, CPU tensors the plain version."""
    B, L, H, _ = q.shape
    if mask is None:
        mask = torch.ones((B, L), dtype=torch.int32, device=q.device)
    mask = mask.to(torch.int32).contiguous()
    seeds = row_seeds(seed, B, H, q.device) if rate > 0.0 else None
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, mask, seeds, rate, segmented,
                                     want_lse)
    return fused_attention_cuda(q, k, v, mask, seeds, rate, segmented,
                                want_lse)
