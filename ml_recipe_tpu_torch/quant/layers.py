"""``QuantLinear``: the int8 drop-in for the port's ``Linear`` (the port of
``ml_recipe_tpu/quant/layers.py`` ``QuantDense``).

It holds buffers, not parameters (serving only; nothing trains them):
``kernel_q`` int8 ``[N, K]`` (K-contiguous: the JAX package's ``[K, N]``
transposed by ``models/convert.py``), ``kernel_scale`` f32 ``[N]`` and
``bias`` f32 ``[N]``. They are zeros until a converted tree is loaded
(``quant.quantize_model``).

Forward: per-row activation quantization (``quantize_rowwise``), the int8
matmul (``int8_matmul``: the hand-written kernel on a CUDA tensor), the bias
added in f32, one cast to the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.quant_matmul import int8_matmul, quantize_rowwise


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
        x_q, x_scale = quantize_rowwise(x)
        y = int8_matmul(x_q, x_scale, self.kernel_q, self.kernel_scale)
        return (y + self.bias).to(self.compute_dtype)
