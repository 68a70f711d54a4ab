"""``QuantLinear``: the int8 drop-in for the port's ``Linear`` (the port of
``ml_recipe_tpu/quant/layers.py`` ``QuantDense``).

It holds buffers, not parameters (serving only; nothing trains them):
``kernel_q`` int8 ``[N, K]`` (K-contiguous: the JAX package's ``[K, N]``
transposed by ``models/convert.py``), ``kernel_scale`` f32 ``[N]`` and
``bias`` f32 ``[N]``. They are zeros until a converted tree is loaded
(``quant.quantize_model``).

Forward: the per-row activation codes of its input (:func:`row_codes`),
then ``ops.quant_matmul.int8_linear``: the int8 product, the bias added in
f32 and one cast to the compute dtype, which on a CUDA tensor is one launch
of the hand-written kernel.

Row codes are a function of the tensor alone (``quantize_rowwise``), so a
tensor that several projections read is quantized once: the codes are
kept on the tensor object (:func:`with_row_codes`), by the LayerNorm that
wrote it (whose kernel writes them in the same launch) or by the first
projection that reads it, and every later reader takes them from there.
A new tensor (a view, a dropout's output, a residual sum) carries none.
The model never writes into a tensor after its codes are taken.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.quant_matmul import int8_linear, quantize_rows

_CODES = "_q8_row_codes"


def with_row_codes(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Keep ``(q, scale)``, the row codes of ``x`` (``quantize_rowwise(x)``,
    however computed), on ``x``; returns ``x``."""
    setattr(x, _CODES, (q, scale))
    return x


def row_codes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rowwise(x)``: the codes kept on ``x``, or computed now
    (``ops.quant_matmul.quantize_rows``: one kernel launch on a CUDA
    tensor) and kept on it."""
    codes = getattr(x, _CODES, None)
    if codes is None:
        codes = quantize_rows(x)
        setattr(x, _CODES, codes)
    return codes


def _take_rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[b, index[b, s]]`` for a ``[B, L, ...]`` tensor and a ``[B, S]``
    index: ``[B, S, ...]``."""
    B, S = index.shape
    idx = index.long().view(B, S, *([1] * (t.dim() - 2)))
    return torch.gather(t, 1, idx.expand(B, S, *t.shape[2:]))


def first_token(hidden: torch.Tensor,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``hidden[:, 0]``, or with a ``[B, S]`` ``index`` (sequence packing:
    each segment's first row) ``hidden``'s rows at it, ``[B, S, H]``;
    keeping the row codes of those rows when ``hidden`` has them: per-row
    codes of a selection of rows are the selection of the codes."""
    codes = getattr(hidden, _CODES, None)
    if index is None:
        cls = hidden[:, 0]
        if codes is not None:
            with_row_codes(cls, codes[0][:, 0].contiguous(),
                           codes[1][:, 0].contiguous())
        return cls
    rows = _take_rows(hidden, index)
    if codes is not None:
        with_row_codes(rows, _take_rows(codes[0], index),
                       _take_rows(codes[1], index))
    return rows


class QuantLinear(nn.Module):
    """Int8-weight Linear: ``y = dequant(act_q8 . kernel_q^T) + bias``."""

    def __init__(self, n_in: int, n_out: int, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(
            (n_out, n_in), dtype=torch.int8, device=device))
        self.register_buffer("kernel_scale", torch.ones(
            n_out, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            n_out, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q, x_scale = row_codes(x)
        return int8_linear(x_q, x_scale, self.kernel_q, self.kernel_scale,
                           self.bias, self.compute_dtype)
