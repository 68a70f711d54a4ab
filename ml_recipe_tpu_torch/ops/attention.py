"""Attention dispatcher (the port of ``ml_recipe_tpu/ops/attention.py``).

Layout at the public function is the JAX package's: q, k, v are
``[B, L, H, D]`` and the key mask ``[B, L]``.

- ``auto`` / ``pallas``: the Hopper kernel pair at every length. A CUDA
  tensor runs the kernels, a CPU tensor their plain versions, as the JAX
  package picks XLA off the TPU. On a TPU the JAX package picks one of
  three kernel regimes by a VMEM budget that says nothing about the H100;
  the port's one tiled pair computes the same function in all of them. At
  bert-base widths (12 heads of 64, bf16) the length ranges stand for:

  ========================  =============================================
  L <= 512                  ``_fused_fwd_kernel`` / ``_fused_bwd_kernel``
  512 < L <= 2048           ``_blocked_fwd_kernel`` / ``_blocked_bwd_kernel``
                            (config/long_context.cfg: 768, 1024)
  L > 2048                  ``_stream_fwd_kernel`` / ``_stream_dq_kernel``
                            / ``_stream_dkv_kernel`` (its 4096 variant)
  ========================  =============================================

  One divergence no port can close: at any length that is not a multiple
  of 128, at L <= 512 as well as past it, the TPU has no kernel geometry
  (``supports_fused_bwd`` gates the fused regime on ``L % 128 == 0`` on
  hardware; ``_pick_q_block`` and ``_pick_stream_block`` find no block for,
  say, L = 200 or 1000), so the JAX package runs XLA attention there, whose
  dropout comes from ``jax.random.bernoulli``. The port runs its kernel
  with the hash dropout: the same function, another dropout stream. At
  rate 0 the two are equal.
- ``xla``: the plain version at any length, on any device.
- ``ring``: sequence-parallel ring attention over the ``seq`` axis of
  ``mesh`` (``ops/ring_attention.py``): q, k, v, the mask and the segment
  ids are this rank's blocks of the sequence, and every hop runs the
  kernel pair (or, on the CPU, its plain versions) with the streaming
  contract.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import (
    _PRIME,
    SeedLike,
    _as_int32,
    fused_attention,
    fused_attention_plain,
    row_seeds,
)

IMPLS = ("auto", "pallas", "xla", "ring")


def dropout_seed(generator: torch.Generator) -> torch.Tensor:
    """A (1,) int32 seed for the dropout hash, drawn from ``generator`` on
    the generator's device (the port's counterpart of ``_dropout_seed``'s
    ``jax.random.randint``). There is no global-RNG default: a training
    step is reproducible from the generators it is given."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"dropout_seed needs a torch.Generator; got "
                        f"{type(generator).__name__}")
    return torch.randint(-(1 << 31), (1 << 31) - 1, (1,), dtype=torch.int64,
                         generator=generator,
                         device=generator.device).to(torch.int32)


def global_row_seeds(seed: torch.Tensor, first: int, rows: int, total: int,
                     heads: int) -> torch.Tensor:
    """The ``[rows]`` int32 dropout row seeds of rows ``first .. first +
    rows`` of a ``total``-row call keyed by ``seed``: a process holding
    those rows of a global micro-batch (data parallelism) passes them and
    draws the attention dropout the one-process call would
    (``row_seeds(seed, total, heads)[first:first + rows]``)."""
    return row_seeds(seed, total, heads, seed.device)[first:first + rows]


def model_row_seeds(seed: torch.Tensor, rows: int, heads: int, index: int,
                    size: int) -> torch.Tensor:
    """The ``[rows]`` int32 dropout row seeds that make rank ``index`` of a
    ``model`` group of ``size`` (tensor parallelism, ``heads / size``
    heads a rank) draw, for its local head ``j``, the keep mask of global
    head ``index * heads / size + j``: ``seed`` (a ``(1,)`` seed or the
    ``[rows]`` seeds of :func:`global_row_seeds`) expanded for the global
    ``heads`` (``row_seeds``), plus ``index * (heads / size) *
    -1640531527`` with int32 wraparound, since the hash keys head ``h`` of
    row ``b`` as ``seed[b] + h * -1640531527``. The kernel and the plain
    version take these seeds as given (a ``[rows]`` vector at rows > 1;
    row 0 of one row has no row offset either way)."""
    seeds = row_seeds(seed, rows, heads, seed.device).to(torch.int64)
    return _as_int32(seeds + int(index) * (int(heads) // int(size)) * _PRIME)


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
    mesh=None,
) -> torch.Tensor:
    """Multi-head attention over [B, L, H, D] with a [B, L] key mask.

    ``segment_ids`` ([B, L], 0 = pad, 1..S = packed segment) switches to the
    block-diagonal mask of sequence packing and replaces ``mask``.
    ``seed`` keys the dropout hash when ``dropout_rate > 0``: the caller
    draws it (:func:`dropout_seed` from its generator). ``auto`` and
    ``pallas`` are differentiable through the kernel pair
    (``FusedAttention``), ``xla`` through autograd of the plain version,
    ``ring`` through ``RingAttention`` over ``mesh``'s ``seq`` ring (the
    arrays are this rank's sequence blocks)."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}; got {impl!r}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed "
                         "(dropout_seed(generator))")
    if impl == "ring":
        from .ring_attention import ring_attention

        return ring_attention(q, k, v, mask, mesh=mesh, rate=dropout_rate,
                              seed=seed, segment_ids=segment_ids)
    segmented = segment_ids is not None
    kernel_mask = segment_ids if segmented else mask
    if impl == "xla":
        B, L, H, _ = q.shape
        if kernel_mask is None:
            kernel_mask = torch.ones((B, L), dtype=torch.int32, device=q.device)
        seeds = (row_seeds(seed, B, H, q.device) if dropout_rate > 0.0
                 else None)
        return fused_attention_plain(q, k, v, kernel_mask.to(torch.int32),
                                     seeds, dropout_rate, segmented)
    return fused_attention(q, k, v, kernel_mask, seed=seed,
                           rate=dropout_rate, segmented=segmented)
