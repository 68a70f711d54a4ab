"""Fused LayerNorm: the Hopper kernels' wrappers and their plain versions.

The port of ``ml_recipe_tpu/ops/layer_norm.py``. ``csrc/layer_norm.cu``
replaces its two TPU kernels: ``_ln_fwd_kernel`` by the forward and
``_ln_bwd_kernel`` by the backward (the design note heads the source).

The function is the TPU kernel's (``_xla_layer_norm`` in the JAX package),
over the trailing axis of ``h``: the row mean and the CENTRED variance in
f32, ``rsqrt(var + eps)``, the affine in f32 and one cast to the output
dtype. The backward recomputes the statistics from ``h`` and gives

    dh = (g*gamma - mean(g*gamma) - xhat * mean(g*gamma*xhat)) * rstd

in ``h``'s dtype, with dgamma = sum(g*xhat) and dbeta = sum(g) over rows in
f32. It is a different rounding of the function flax's ``nn.LayerNorm``
computes (``models/encoder.py`` ``LayerNorm``, ``ln_impl='xla'``).

:func:`layer_norm` is the entry point (``impl`` 'xla', 'fused' or 'auto').
With a gradient to track it goes through :class:`FusedLayerNormFn`; a CUDA
tensor launches the kernels, a CPU tensor runs the plain versions, which
are also what ``chip_smoke.py`` holds the kernels against on the card.
:func:`layer_norm_q8` is the int8 model's: the same forward, and in the
same launch the int8 codes and row scales of its own output, as
``ops.quant_matmul.quantize_rowwise`` would give them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import quant_matmul
from .cuda_build import CudaLibrary, Kernel, launch_scope, stream_of

IMPLS = ("xla", "fused", "auto")
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_C = 4096          # csrc/layer_norm.cu kMaxC: 1024 threads x 4 columns


def layer_norm_plain(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, on any device, over
    the trailing axis of ``h``; the result in ``dtype``."""
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    xc = hf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    xhat = xc * torch.rsqrt(var + eps)
    return (xhat * gamma.float() + beta.float()).to(dtype)


def layer_norm_bwd_plain(h: torch.Tensor, gamma: torch.Tensor,
                         g: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, on any device:
    ``h``, ``g`` [N, C] -> ``(dh, dgamma, dbeta)``, dh in ``h``'s dtype,
    dgamma and dbeta f32 [C]."""
    hf, gf = h.float(), g.float()
    mu = hf.mean(dim=-1, keepdim=True)
    xc = hf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    gg = gf * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dh = ((gg - m1 - xhat * m2) * rstd).to(h.dtype)
    return dh, (gf * xhat).sum(dim=0), gf.sum(dim=0)


# The kernels' limits against the plain versions, on one set of inputs
# (chip_smoke.py and tests/test_torch_cuda.py hold them to these). Forward:
# the same formula with the statistics summed in another order and rsqrtf
# (2 ulp), so f32 within FWD_REL of max(|ref|, 1); a bf16 output rounds
# those f32 values and may land one bf16 step away at the element's size,
# on top of the f32 limit (which is what remains where xhat*gamma + beta
# cancels to near zero). Backward: dh's (g*gamma - m1 - xhat*m2) cancels on
# near-zero elements, so reordered sums show at ~1e-7 of the row scale:
# within BWD_REL of max|ref| (plus one bf16 step for a bf16 dh); dgamma and
# dbeta sum up to 16384 rows in another order: rtol DPARAM_RTOL, atol
# BWD_REL of max|ref|.
FWD_REL = 1e-5
BWD_REL = 1e-5
DPARAM_RTOL = 1e-4


def bf16_steps(x: torch.Tensor) -> torch.Tensor:
    """bf16 spacing at each element's magnitude (8 significant bits)."""
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def fwd_limit(ref: torch.Tensor) -> torch.Tensor:
    """Per-element limit of |kernel - plain| for a forward result ``ref``
    (the plain version's output, in the output dtype)."""
    r = ref.float()
    tol = FWD_REL * r.abs().clamp_min(1.0)
    return tol + bf16_steps(r) if ref.dtype == torch.bfloat16 else tol


def dh_limit(dh_ref: torch.Tensor) -> torch.Tensor:
    """Limit of |kernel - plain| for the backward's dh (per element for a
    bf16 dh)."""
    r = dh_ref.float()
    tol = BWD_REL * r.abs().max()
    return tol + bf16_steps(r) if dh_ref.dtype == torch.bfloat16 else tol


def dparam_close(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Whether a kernel's dgamma or dbeta is within the limits of the plain
    version's."""
    return bool(torch.allclose(got, ref, rtol=DPARAM_RTOL,
                               atol=BWD_REL * ref.abs().max().item()))


def seeded_inputs(N: int, C: int, dtype: torch.dtype, seed: int,
                  device="cuda"):
    """``(h, gamma, beta, g)`` for the kernel checks: h [N, C] of mean 0.5
    and size 2 and g [N, C] unit normal in ``dtype``, gamma and beta f32
    [C] about 1 and 0, drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    h = (torch.randn((N, C), generator=gen) * 2 + 0.5).to(device, dtype)
    gamma = (torch.randn(C, generator=gen) * 0.2 + 1.0).to(device)
    beta = (torch.randn(C, generator=gen) * 0.1).to(device)
    g = torch.randn((N, C), generator=gen).to(device, dtype)
    return h, gamma, beta, g


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.layer_norm_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp,           # h gamma beta y q qscale
        ci, ci, ci, ci, cf,               # N C h_bf16 y_bf16 eps
        vp,                               # stream
    ]
    lib.layer_norm_fwd.restype = ci
    lib.layer_norm_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,       # h gamma g dh partial dgamma dbeta
        ci, ci, ci, ci, cf,               # N C h_bf16 g_bf16 eps
        vp,                               # stream
    ]
    lib.layer_norm_bwd.restype = ci
    lib.layer_norm_bwd_scratch_rows.argtypes = []
    lib.layer_norm_bwd_scratch_rows.restype = ci
    # the most rows of the backward's partial-sum scratch: read here, once,
    # and not on every launch
    lib.scratch_rows = lib.layer_norm_bwd_scratch_rows()


# one library, two kernels, one count each (the backward's launch runs its
# row kernel and the fixed-order column sum and counts once)
LIBRARY = CudaLibrary("layer_norm.cu", _declare)
FWD_KERNEL = Kernel(LIBRARY)
BWD_KERNEL = Kernel(LIBRARY)


def _check(what: str, h: torch.Tensor, params, others=()):
    """Raise on anything the kernels do not take: ``params`` are the f32
    [C] tensors (gamma, beta), ``others`` further [N, C] tensors (g).
    Allocates nothing."""
    if h.device.type != "cuda":
        raise ValueError(
            f"{what} launches a CUDA kernel; got a tensor on {h.device} (use "
            f"layer_norm, which routes CPU tensors to the plain version)")
    if h.dim() != 2:
        raise ValueError(f"{what} takes h as [N, C]; got {tuple(h.shape)}")
    N, C = h.shape
    if not 0 < C <= MAX_C:
        raise ValueError(
            f"{what}: C = {C} is past the kernel's limit of {MAX_C} (one "
            f"block holds a row, 4 columns a thread)")
    for t in (h, *others):
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{what} takes bfloat16 or float32; got "
                             f"{t.dtype}")
    for t in others:
        if t.shape != h.shape:
            raise ValueError(f"{what}: g must match h {tuple(h.shape)}; got "
                             f"{tuple(t.shape)}")
    for t in params:
        if t.shape != (C,) or t.dtype is not torch.float32:
            raise ValueError(f"{what}: gamma and beta must be f32 [{C}]; got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (h, *params, *others):
        if t.device != h.device:
            raise ValueError(f"all operands must be on {h.device}; one is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all operands must be contiguous")


def _fwd_cuda(what: str, h, gamma, beta, eps, dtype, codes: bool):
    """One forward launch: y, and with ``codes`` the int8 codes of y and
    their f32 row scales [N, 1]."""
    _check(what, h, (gamma, beta))
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what} writes bfloat16 or float32; got {dtype}")
    N, C = h.shape
    dev = h.device
    y = torch.empty((N, C), dtype=dtype, device=dev)
    q = torch.empty((N, C), dtype=torch.int8, device=dev) if codes else None
    scale = (torch.empty((N, 1), dtype=torch.float32, device=dev) if codes
             else None)
    if N == 0:
        return (y, q, scale) if codes else y
    lib = LIBRARY.lib()
    with launch_scope(dev):
        err = lib.layer_norm_fwd(
            h.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            q.data_ptr() if codes else None,
            scale.data_ptr() if codes else None, N, C,
            int(h.dtype is torch.bfloat16), int(dtype is torch.bfloat16),
            float(eps), stream_of(dev))
    if err != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed: cudaError_t {err} "
                           f"(N={N}, C={C}, {h.dtype} -> {dtype}, codes "
                           f"{codes})")
    FWD_KERNEL.count()
    return (y, q, scale) if codes else y


def layer_norm_fwd_cuda(h: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float,
                        dtype: torch.dtype) -> torch.Tensor:
    """Launch the forward kernel of ``csrc/layer_norm.cu`` on CUDA tensors:
    ``h`` [N, C], ``gamma``/``beta`` f32 [C] -> y [N, C] in ``dtype``. Same
    result as :func:`layer_norm_plain`; raises on anything the kernel does
    not take. The result carries no autograd history."""
    return _fwd_cuda("layer_norm_fwd_cuda", h, gamma, beta, eps, dtype, False)


def layer_norm_q8_plain(h: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float, dtype: torch.dtype):
    """``(y, q, scale)``: :func:`layer_norm_plain`, then
    ``quantize_rowwise`` of that y."""
    y = layer_norm_plain(h, gamma, beta, eps, dtype)
    return (y, *quant_matmul.quantize_rowwise(y))


def layer_norm_q8_cuda(h: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float, dtype: torch.dtype):
    """Launch the forward with its quantize epilogue on CUDA tensors ``h``
    [N, C]: ``(y, q, scale)``, y as :func:`layer_norm_fwd_cuda` gives it
    and ``(q, scale)`` equal to ``quantize_rowwise(y)`` of that y, bit for
    bit."""
    return _fwd_cuda("layer_norm_q8_cuda", h, gamma, beta, eps, dtype, True)


def layer_norm_bwd_cuda(h: torch.Tensor, gamma: torch.Tensor,
                        g: torch.Tensor, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward of ``csrc/layer_norm.cu`` on CUDA tensors: same
    arguments and results as :func:`layer_norm_bwd_plain`. One warp a row
    for C <= 1024 with 16-byte aligned rows, a block a row otherwise; then
    the column sum. Deterministic: dgamma/dbeta are summed over the blocks'
    rows in a fixed order."""
    _check("layer_norm_bwd_cuda", h, (gamma,), (g,))
    N, C = h.shape
    dh = torch.empty_like(h)
    dgamma = torch.empty((C,), dtype=torch.float32, device=h.device)
    dbeta = torch.empty_like(dgamma)
    if N == 0:
        return dh, dgamma.zero_(), dbeta.zero_()
    lib = LIBRARY.lib()
    partial = torch.empty((min(N, lib.scratch_rows), 2, C),
                          dtype=torch.float32, device=h.device)
    with launch_scope(h.device):
        err = lib.layer_norm_bwd(
            h.data_ptr(), gamma.data_ptr(), g.data_ptr(), dh.data_ptr(),
            partial.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            N, C, int(h.dtype is torch.bfloat16),
            int(g.dtype is torch.bfloat16), float(eps), stream_of(h.device))
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd launch failed: cudaError_t {err} "
                           f"(N={N}, C={C}, h {h.dtype}, g {g.dtype})")
    BWD_KERNEL.count()
    return dh, dgamma, dbeta


class FusedLayerNormFn(torch.autograd.Function):
    """The kernel pair under autograd (the JAX package's ``_fused_ln_flat``
    custom VJP): the forward saves only ``h`` and ``gamma`` and the backward
    recomputes the statistics. ``h`` is [N, C]; CUDA tensors launch the
    kernels, CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, h, gamma, beta, eps: float, dtype: torch.dtype):
        fwd = layer_norm_plain if h.device.type == "cpu" else layer_norm_fwd_cuda
        ctx.save_for_backward(h, gamma)
        ctx.eps = eps
        ctx.out_dtype = dtype
        return fwd(h, gamma, beta, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        h, gamma = ctx.saved_tensors
        g = g.to(ctx.out_dtype).contiguous()  # the kernel reads g as y's dtype
        bwd = layer_norm_bwd_plain if h.device.type == "cpu" else layer_norm_bwd_cuda
        dh, dgamma, dbeta = bwd(h, gamma, g, ctx.eps)
        return (dh, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None,
                None)


def layer_norm(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = 1e-12, dtype: torch.dtype = torch.float32,
               impl: str = "fused") -> torch.Tensor:
    """LayerNorm over the trailing axis of ``h`` ([..., C]) with f32
    statistics; the result in ``dtype``.

    ``impl``:
    - 'xla': the plain version, differentiated by autograd;
    - 'fused': the kernels on a CUDA tensor (their wrappers raise on what
      they do not take), the plain versions on a CPU tensor, in both cases
      under :class:`FusedLayerNormFn` when a gradient is tracked;
    - 'auto': as 'fused' (the JAX package's 'auto' picks its kernel on a
      TPU, as this one does on a CUDA tensor)."""
    if impl not in IMPLS:
        raise ValueError(f"layer_norm impl must be one of {IMPLS}; got "
                         f"{impl!r}")
    if impl == "xla":
        return layer_norm_plain(h, gamma, beta, eps, dtype)
    C = h.shape[-1]
    h2 = h.reshape(-1, C).contiguous()
    gamma, beta = _f32(gamma), _f32(beta)
    if torch.is_grad_enabled() and (h.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        y = FusedLayerNormFn.apply(h2, gamma, beta, float(eps), dtype)
    else:
        fwd = (layer_norm_plain if h.device.type == "cpu"
               else layer_norm_fwd_cuda)
        y = fwd(h2, gamma, beta, float(eps), dtype)
    return y.reshape(h.shape)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take a parameter: f32 and contiguous (no copy
    when it already is)."""
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def layer_norm_q8(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  *, eps: float = 1e-12, dtype: torch.dtype = torch.float32):
    """``(y, q, scale)``: :func:`layer_norm` ('fused') of ``h`` [..., C] and
    the int8 codes and f32 row scales [..., 1] of that y, equal to
    ``quantize_rowwise(y)``. On a CUDA tensor one launch writes all three;
    on a CPU tensor the plain versions. With a gradient to track, y comes
    from :func:`layer_norm` and the codes, which carry none, from its
    values."""
    C = h.shape[-1]
    if torch.is_grad_enabled() and (h.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        y = layer_norm(h, gamma, beta, eps=eps, dtype=dtype, impl="fused")
        return (y, *quant_matmul.quantize_rows(y.detach()))
    h2 = h.reshape(-1, C).contiguous()
    gamma, beta = _f32(gamma), _f32(beta)
    fwd = layer_norm_q8_plain if h.device.type == "cpu" else layer_norm_q8_cuda
    y, q, scale = fwd(h2, gamma, beta, float(eps), dtype)
    lead = h.shape[:-1]
    return y.reshape(h.shape), q.reshape(h.shape), scale.reshape(*lead, 1)
