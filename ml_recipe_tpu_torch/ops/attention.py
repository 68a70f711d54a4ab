"""Attention dispatcher (the port of ``ml_recipe_tpu/ops/attention.py``).

Layout at the public function is the JAX package's: q, k, v are
``[B, L, H, D]`` and the key mask ``[B, L]``.

- ``auto`` / ``pallas``: the fused regime (L <= 512). A CUDA tensor runs the
  Hopper kernel, a CPU tensor its plain version, as the JAX package picks
  XLA off the TPU. Longer rows need the blocked and streaming kernels,
  which are not ported yet.
- ``xla``: the plain version at any length, on any device.
- ``ring``: sequence-parallel ring attention, not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (
    FUSED_MAX_LEN,
    SeedLike,
    fused_attention,
    fused_attention_plain,
    row_seeds,
)

IMPLS = ("auto", "pallas", "xla", "ring")


def dropout_seed(generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A (1,) int32 seed for the dropout hash, drawn from ``generator``
    (the port's counterpart of ``_dropout_seed``'s ``jax.random.randint``)."""
    return torch.randint(-(1 << 31), (1 << 31) - 1, (1,), dtype=torch.int64,
                         generator=generator).to(torch.int32)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    dropout_rate: float = 0.0,
    seed: SeedLike = None,
    impl: str = "auto",
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over [B, L, H, D] with a [B, L] key mask.

    ``segment_ids`` ([B, L], 0 = pad, 1..S = packed segment) switches to the
    block-diagonal mask of sequence packing and replaces ``mask``.
    ``seed`` keys the dropout hash when ``dropout_rate > 0``."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}; got {impl!r}")
    if impl == "ring":
        raise NotImplementedError(
            "impl='ring' (sequence-parallel ring attention) is not ported "
            "yet: ROADMAP.md queue 1, 'Parallelism beyond data parallelism'")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed (dropout_seed())")
    segmented = segment_ids is not None
    kernel_mask = segment_ids if segmented else mask
    L = q.shape[1]
    if impl == "xla":
        B, _, H, _ = q.shape
        if kernel_mask is None:
            kernel_mask = torch.ones((B, L), dtype=torch.int32, device=q.device)
        seeds = (row_seeds(seed, B, H, q.device) if dropout_rate > 0.0
                 else None)
        return fused_attention_plain(q, k, v, kernel_mask.to(torch.int32),
                                     seeds, dropout_rate, segmented)
    if L > FUSED_MAX_LEN:
        raise NotImplementedError(
            f"attention at L={L} > {FUSED_MAX_LEN} needs the blocked and "
            f"streaming attention kernels, not ported yet: ROADMAP.md "
            f"queue 2 (_blocked_fwd_kernel, _stream_fwd_kernel); "
            f"impl='xla' runs the plain version at any length")
    return fused_attention(q, k, v, kernel_mask, seed=seed,
                           rate=dropout_rate, segmented=segmented)
