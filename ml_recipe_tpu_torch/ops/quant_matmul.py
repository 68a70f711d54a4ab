"""Int8 quantized matmul: the Hopper kernel's wrapper and its plain version.

The port of ``ml_recipe_tpu/ops/quant_matmul.py``. ``csrc/q8_matmul.cu``
replaces its TPU kernel ``_q8_matmul_kernel`` (the design note heads the
source). The arithmetic is the TPU kernel's, bit for bit:

- activations are quantized per ROW in f32 (:func:`quantize_rowwise`):
  ``scale = max(amax, 1e-8) / 127``, codes ``round_half_even(x / scale)``
  clipped to [-127, 127] (division, not a multiply by the reciprocal);
- weights arrive quantized per OUTPUT channel (``quant/quantize.py``);
- the product accumulates exactly in int32 over all of K, then the dequant
  ``float(acc) * x_scale * w_scale`` in that order (:func:`_rescale`).

One layout differs from the JAX package's: the weight codes are ``[N, K]``
(K-contiguous, as the kernel streams both operands along K); the JAX
package's are ``[K, N]``. ``models/convert.py`` transposes between them.

:func:`int8_matmul` is the entry point: a CUDA tensor launches the kernel at
every shape (ragged M and N included: the QA heads and the pooler), a CPU
tensor runs :func:`int8_matmul_plain`, which is also what ``chip_smoke.py``
holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, Kernel

# symmetric int8 grid: +-127 (the -128 code is unused so negation is exact)
INT8_MAX = 127.0
# activation amax floor: an all-zero row quantizes to zeros with this scale
_EPS = 1e-8


def quantize_rowwise(x: torch.Tensor, *, eps: float = _EPS):
    """Dynamic symmetric per-row activation quantization: ``x`` [..., K]
    float -> ``(q, scale)``, q int8 of x's shape and scale f32 [..., 1],
    computed in f32 whatever x's dtype."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(eps) / INT8_MAX
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def _rescale(acc: torch.Tensor, x_scale: torch.Tensor,
             w_scale: torch.Tensor) -> torch.Tensor:
    """The fused dequant: int32 accumulator -> f32, in the kernel's order."""
    return acc.to(torch.float32) * x_scale * w_scale


def int8_matmul_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: ``x_q`` int8
    [..., K] with f32 scales [..., 1], ``w_q`` int8 [N, K] with f32 scales
    [N] -> f32 [..., N]. There is no int32 matmul on CUDA, so the products
    accumulate in float64, exact while K * 127**2 < 2**53, then convert to
    int32 and to f32 as the int32 accumulator does."""
    lead, K = x_q.shape[:-1], x_q.shape[-1]
    N = w_q.shape[0]
    acc = x_q.reshape(-1, K).double() @ w_q.double().t()
    out = _rescale(acc.to(torch.int32), x_scale.reshape(-1, 1).float(),
                   w_scale.reshape(1, N).float())
    return out.reshape(*lead, N)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.q8_matmul.argtypes = [vp, vp, vp, vp, vp,   # x xs w ws out
                              ci, ci, ci,           # M N K
                              vp]                   # stream
    lib.q8_matmul.restype = ci


KERNEL = Kernel(CudaLibrary("q8_matmul.cu", _declare))


def int8_matmul_cuda(x_q: torch.Tensor, x_scale: torch.Tensor,
                     w_q: torch.Tensor, w_scale: torch.Tensor
                     ) -> torch.Tensor:
    """Launch ``csrc/q8_matmul.cu`` on CUDA tensors; same arguments and
    result as :func:`int8_matmul_plain`, bit for bit. Raises on anything the
    kernel does not take (CPU tensors, K % 4 != 0, other dtypes)."""
    if x_q.device.type != "cuda":
        raise ValueError(
            f"int8_matmul_cuda launches a CUDA kernel; got a tensor on "
            f"{x_q.device} (use int8_matmul, which routes CPU tensors to the "
            f"plain version)")
    lead, K = x_q.shape[:-1], x_q.shape[-1]
    if w_q.dim() != 2 or w_q.shape[1] != K:
        raise ValueError(f"w_q must be [N, K={K}]; got {tuple(w_q.shape)}")
    N = w_q.shape[0]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"x_q and w_q must be int8; got {x_q.dtype}, "
                         f"{w_q.dtype}")
    if K % 4:
        raise ValueError(f"K = {K} is not a multiple of 4 (the kernel moves "
                         f"4-byte words of int8 codes)")
    x2 = x_q.reshape(-1, K).contiguous()
    M = x2.shape[0]
    xs = x_scale.reshape(-1).float().contiguous()
    ws = w_scale.reshape(-1).float().contiguous()
    if xs.shape != (M,) or ws.shape != (N,):
        raise ValueError(f"scales must hold one value per row ({M}) and per "
                         f"output channel ({N}); got {tuple(xs.shape)}, "
                         f"{tuple(ws.shape)}")
    w = w_q.contiguous()
    for t in (x2, xs, w, ws):
        if t.device != x_q.device:
            raise ValueError(f"all operands must be on {x_q.device}; one is "
                             f"on {t.device}")
    for t in (x2, w):
        if t.data_ptr() % 4:
            raise ValueError("int8 operands must be 4-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0:
        return out.reshape(*lead, N)
    lib = KERNEL.library.lib()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = lib.q8_matmul(x2.data_ptr(), xs.data_ptr(), w.data_ptr(),
                            ws.data_ptr(), out.data_ptr(), M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"q8_matmul launch failed: cudaError_t {err} "
                           f"(M={M}, N={N}, K={K})")
    KERNEL.launches += 1
    return out.reshape(*lead, N)


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Quantized matmul ``[..., K] x [N, K]^T -> [..., N]`` f32: the kernel
    on a CUDA tensor (every shape), the plain version on a CPU tensor."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale)
    return int8_matmul_cuda(x_q, x_scale, w_q, w_scale)
