"""Int8 quantized matmul: the Hopper kernels' wrappers and their plain
versions.

The port of ``ml_recipe_tpu/ops/quant_matmul.py``. ``csrc/q8_matmul.cu``
replaces its TPU kernel ``_q8_matmul_kernel`` and also holds the port's
row quantize kernel (the design note heads the source). The arithmetic is
the JAX package's, bit for bit:

- activations are quantized per ROW in f32 (:func:`quantize_rowwise`):
  ``scale = max(amax, 1e-8) / 127``, codes ``round_half_even(x / scale)``
  clipped to [-127, 127] (division, not a multiply by the reciprocal);
- weights arrive quantized per OUTPUT channel (``quant/quantize.py``);
- the product accumulates exactly in int32 over all of K, then the dequant
  ``float(acc) * x_scale * w_scale`` in that order (:func:`_rescale`);
- ``QuantDense`` then adds the f32 bias and casts once to the compute dtype
  (:func:`int8_linear`, one launch on the card).

One layout differs from the JAX package's: the weight codes are ``[N, K]``
(K-contiguous, as the kernel streams both operands along K); the JAX
package's are ``[K, N]``. ``models/convert.py`` transposes between them.

Entry points, each routing a CPU tensor to its plain version and a CUDA
tensor to its kernel at every shape (ragged M and N included: the QA heads
and the pooler): :func:`quantize_rows` (the codes and row scales of an
activation), :func:`int8_matmul` (the TPU kernel's f32 function) and
:func:`int8_linear` (``QuantLinear``'s whole forward after the quantize).
The plain versions are also what ``chip_smoke.py`` holds the kernels
against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, Kernel, launch_scope, stream_of

# symmetric int8 grid: +-127 (the -128 code is unused so negation is exact)
INT8_MAX = 127.0
# activation amax floor: an all-zero row quantizes to zeros with this scale
_EPS = 1e-8
# q8_matmul's out_kind: the f32 function, f32 + bias, bf16 + bias
_OUT_F32, _OUT_F32_BIAS, _OUT_BF16_BIAS = 0, 1, 2
LINEAR_DTYPES = (torch.float32, torch.bfloat16)


def quantize_rowwise(x: torch.Tensor, *, eps: float = _EPS):
    """Dynamic symmetric per-row activation quantization: ``x`` [..., K]
    float -> ``(q, scale)``, q int8 of x's shape and scale f32 [..., 1],
    computed in f32 whatever x's dtype. Both divisions are IEEE divisions
    on every device: PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal instead, so 127 is a tensor on x's device here."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(eps) / amax.new_full((), INT8_MAX)
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


def int8_linear_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``QuantDense`` after its quantize, in plain PyTorch: the f32
    product, ``+ bias`` in f32, one cast to ``dtype``."""
    return (int8_matmul_plain(x_q, x_scale, w_q, w_scale)
            + bias.float()).to(dtype)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.q8_matmul.argtypes = [vp, vp, vp, vp, vp, vp,   # x xs w ws bias out
                              ci, ci, ci, ci,           # M N K out_kind
                              vp]                       # stream
    lib.q8_matmul.restype = ci
    lib.q8_quantize_rows.argtypes = [vp, vp, vp,        # x q scale
                                     ci, ci, ci,        # M K x_bf16
                                     vp]                # stream
    lib.q8_quantize_rows.restype = ci


# one library, two kernels, one count each: the product (both epilogues)
# and the row quantize
LIBRARY = CudaLibrary("q8_matmul.cu", _declare)
KERNEL = Kernel(LIBRARY)
QUANT_KERNEL = Kernel(LIBRARY)


def _not_cuda(what: str, t: torch.Tensor, routed: str) -> ValueError:
    return ValueError(
        f"{what} launches a CUDA kernel; got a tensor on {t.device} (use "
        f"{routed}, which routes CPU tensors to the plain version)")


def _launch_product(what: str, x_q, x_scale, w_q, w_scale, bias, dtype,
                    out_kind: int) -> torch.Tensor:
    """Check the operands of one ``q8_matmul`` launch, launch it and count
    it. The checks allocate nothing: every operand must already be as the
    kernel takes it (a contiguous int8 activation, f32 contiguous
    scales)."""
    dev = x_q.device
    if dev.type != "cuda":
        raise _not_cuda(what, x_q, what.replace("_cuda", ""))
    K = x_q.shape[-1]
    if w_q.dim() != 2 or w_q.shape[1] != K:
        raise ValueError(f"w_q must be [N, K={K}]; got {tuple(w_q.shape)}")
    N = w_q.shape[0]
    if x_q.dtype is not torch.int8 or w_q.dtype is not torch.int8:
        raise ValueError(f"x_q and w_q must be int8; got {x_q.dtype}, "
                         f"{w_q.dtype}")
    if K % 4:
        raise ValueError(f"K = {K} is not a multiple of 4 (the kernel moves "
                         f"4-byte words of int8 codes)")
    M = x_q.numel() // K if K else 0
    f32 = (x_scale, w_scale) if bias is None else (x_scale, w_scale, bias)
    for t in (x_q, w_q, *f32):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}; one is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous operands")
    for t in f32:
        if t.dtype is not torch.float32:
            raise ValueError(f"scales and bias must be f32; got {t.dtype}")
    if x_scale.numel() != M or w_scale.numel() != N or \
            (bias is not None and bias.numel() != N):
        raise ValueError(f"scales must hold one value per row ({M}) and per "
                         f"output channel ({N}), the bias one per channel; "
                         f"got {x_scale.numel()}, {w_scale.numel()}")
    if x_q.data_ptr() % 4 or w_q.data_ptr() % 4:
        raise ValueError("int8 operands must be 4-byte aligned")
    out = torch.empty((*x_q.shape[:-1], N), dtype=dtype, device=dev)
    if M == 0:
        return out
    lib = LIBRARY.lib()
    with launch_scope(dev):
        err = lib.q8_matmul(
            x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, N, K, out_kind, stream_of(dev))
    if err != 0:
        raise RuntimeError(f"q8_matmul launch failed: cudaError_t {err} "
                           f"(M={M}, N={N}, K={K}, out_kind {out_kind})")
    KERNEL.count()
    return out


def int8_matmul_cuda(x_q: torch.Tensor, x_scale: torch.Tensor,
                     w_q: torch.Tensor, w_scale: torch.Tensor
                     ) -> torch.Tensor:
    """Launch ``csrc/q8_matmul.cu`` with its f32 epilogue on CUDA tensors;
    same result as :func:`int8_matmul_plain`, bit for bit. Raises on
    anything the kernel does not take (CPU tensors, K % 4 != 0, other
    dtypes, non-contiguous operands)."""
    return _launch_product("int8_matmul_cuda", x_q, x_scale, w_q, w_scale,
                           None, torch.float32, _OUT_F32)


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Quantized matmul ``[..., K] x [N, K]^T -> [..., N]`` f32: the kernel
    on a CUDA tensor (every shape), the plain version on a CPU tensor."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale)
    return int8_matmul_cuda(x_q, x_scale, w_q, w_scale)


def int8_linear_cuda(x_q: torch.Tensor, x_scale: torch.Tensor,
                     w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/q8_matmul.cu`` with the QuantLinear epilogue (``+ bias``
    and the cast to ``dtype``, bf16 or f32, in the same launch); same result
    as :func:`int8_linear_plain`, bit for bit."""
    if dtype not in LINEAR_DTYPES:
        raise ValueError(f"int8_linear_cuda writes bfloat16 or float32; got "
                         f"{dtype}")
    kind = _OUT_BF16_BIAS if dtype is torch.bfloat16 else _OUT_F32_BIAS
    return _launch_product("int8_linear_cuda", x_q, x_scale, w_q, w_scale,
                           bias, dtype, kind)


def int8_linear(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``(int8_matmul(...) + bias).to(dtype)`` of quantized activations
    ``x_q`` [..., K] (scales [..., 1]) and weights ``w_q`` [N, K] (scales
    and bias [N]) -> [..., N] in ``dtype``: one kernel launch on a CUDA
    tensor (every shape), the plain version on a CPU tensor."""
    if x_q.device.type == "cpu":
        return int8_linear_plain(x_q, x_scale, w_q, w_scale, bias, dtype)
    return int8_linear_cuda(x_q, x_scale, w_q, w_scale, bias, dtype)


def quantize_rowwise_cuda(x: torch.Tensor):
    """Launch the row quantize of ``csrc/q8_matmul.cu`` on a contiguous
    bf16 or f32 CUDA tensor ``x`` [..., K]: ``(q, scale)`` as
    :func:`quantize_rowwise` gives them, bit for bit."""
    dev = x.device
    if dev.type != "cuda":
        raise _not_cuda("quantize_rowwise_cuda", x, "quantize_rows")
    if x.dtype not in LINEAR_DTYPES:
        raise ValueError(f"quantize_rowwise_cuda reads bfloat16 or float32; "
                         f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_rowwise_cuda takes a contiguous tensor")
    K = x.shape[-1]
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    M = x.numel() // K if K else 0
    if M == 0:
        return q, scale
    lib = LIBRARY.lib()
    with launch_scope(dev):
        err = lib.q8_quantize_rows(x.data_ptr(), q.data_ptr(),
                                   scale.data_ptr(), M, K,
                                   int(x.dtype is torch.bfloat16),
                                   stream_of(dev))
    if err != 0:
        raise RuntimeError(f"q8_quantize_rows launch failed: cudaError_t "
                           f"{err} (M={M}, K={K}, {x.dtype})")
    QUANT_KERNEL.count()
    return q, scale


def quantize_rows(x: torch.Tensor):
    """``(q, scale)`` of :func:`quantize_rowwise`: the row quantize kernel
    on a CUDA tensor (made contiguous first), the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return quantize_rowwise(x)
    return quantize_rowwise_cuda(x.contiguous())
