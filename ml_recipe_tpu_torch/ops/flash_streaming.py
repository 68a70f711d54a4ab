"""Streaming attention (the port of ``ml_recipe_tpu/ops/flash_streaming.py``).

On the TPU the streaming kernels (``_stream_fwd_kernel``,
``_stream_dq_kernel``, ``_stream_dkv_kernel``) take the lengths whose K/V no
longer fits VMEM whole, and add a contract that the composed ring attention
needs, where one call sees one block of a longer sequence:

- ``base``: the absolute ``(row_base, col_base)`` of the call's q rows and
  k columns in that sequence (``base_ref``; ``(0, 0)`` single-chip);
- ``L_hash``: the length the dropout hash flattens (row, col) against
  (the global length; ``L`` single-chip);
- ``seg_split``: segment ids as one ``[B, 2L]`` plane, the q-side ids first,
  then the visiting K/V block's.

The Hopper kernel pair (``csrc/fused_attention_fwd.cu``,
``csrc/fused_attention_bwd.cu``) already streams K/V tiles with an online
softmax and splits the backward into a dk/dv kernel and a dq kernel, so it
computes this regime too: :func:`streaming_attention` is
:func:`~.flash_attention.fused_attention` with the contract, and its
gradient is :class:`~.flash_attention.FusedAttention`'s. The plain versions
are the same generalised functions. The dispatcher (``ops/attention.py``)
calls the kernel pair with the single-chip defaults at every length; this
entry point is for callers that pass the contract: ring attention
(``ops/ring_attention.py``), whose every hop is one call.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import BaseLike, SeedLike, fused_attention


def streaming_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None, seed: SeedLike = None,
    rate: float = 0.0, segmented: bool = False, base: BaseLike = None,
    L_hash: Optional[int] = None, seg_split: bool = False,
    want_lse: bool = False,
):
    """Streaming-KV attention over [B, L, H, D] with a [B, L] key mask, or
    segment ids when ``segmented`` ([B, 2L] q-side then k-side ids when
    ``seg_split``). ``seed``, ``rate``: as ``fused_attention`` takes them;
    ``base``, ``L_hash``: the block's place for the dropout hash (see the
    module docstring); ``want_lse``: also the ``[B, H, L]`` f32 logsumexp
    (calls without autograd). Differentiable when q, k or v requires
    grad."""
    return fused_attention(q, k, v, mask, seed=seed, rate=rate,
                           segmented=segmented, base=base, L_hash=L_hash,
                           seg_split=seg_split, want_lse=want_lse)
