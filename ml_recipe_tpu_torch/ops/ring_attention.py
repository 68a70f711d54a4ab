"""Ring attention over the mesh's ``seq`` axis (the port of
``ml_recipe_tpu/ops/ring_attention.py``, its composed streaming x ring
inner).

Each rank of a ``seq`` ring of S ranks holds one block of ``L_loc = L / S``
tokens of every row: its q, k, v ``[B, L_loc, H, D]`` and key mask (or
segment ids). The K/V block rotates around the ring, one hop to the next
rank per step, and each hop runs the port's attention kernel pair on the
visiting block through ``ops.flash_streaming.streaming_attention``'s
contract (the TPU package's ``_stream_forward``/``_stream_backward``):

- ``base = (row_base, col_base)``: the absolute places of this rank's rows
  (``seq_index * L_loc``) and of the visiting block's columns (the block
  that left rank ``(seq_index - step) % S`` at hop ``step``, so its base
  moves with it as it does in the JAX package);
- ``L_hash = S * L_loc``: the dropout hash keys every (row, col) by its
  place in the whole sequence, so the keep-mask is the one-call mask at
  any S;
- segment ids (sequence packing): the q-side ids stay resident and the
  k-side ids rotate with the block; each hop gets them as one ``[B, 2 *
  L_loc]`` plane (``seg_split``).

Forward: each hop returns its block's normalised output and logsumexp,
merged into the running output by :func:`_merge_hop` (an online softmax
across hops), in f32. The hop kernels write q's dtype, so on the card a
bf16 hop output is rounded to bf16 before its merge, where the JAX
package's hop writes f32: against JAX and against one call over the whole
sequence that costs at most one bf16 rounding per hop on top of the
output's own, in the relative error of the merged output.

Backward (:class:`RingAttention`, the JAX package's custom VJP): the
forward keeps the merged ``out`` and the global ``lse``, from which every
hop's backward recomputes its block's exact probabilities; dq sums over
hops here, in f32, and (k, v, dk, dv) rotate together so that each
block's dk/dv partial arrives home after a full loop: the last hop is
peeled and followed by one homeward hop of dk/dv alone. The hop backward
writes q's dtype too (one bf16 rounding per hop of each gradient on the
card, summed in f32).

Dropout seeds (:func:`_stream_row_seeds`): row ``b`` of data-parallel group
``r`` uses ``seed + r*P + b*H*P`` (the kernel adds ``h*P``), as in the JAX
package's ring. On the CPU each hop runs the kernels' plain versions; the
port's kernels take any ``L_loc``, so the JAX package's dense inner (for
local lengths without a streaming geometry) needs no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import RingTransport
from .flash_attention import (
    NEG_INF,
    _as_int32,
    _PRIME,
    fused_attention_bwd_cuda,
    fused_attention_bwd_plain,
)
from .flash_streaming import streaming_attention


def _stream_row_seeds(seed: torch.Tensor, *, B: int, H: int,
                      data_index: int) -> torch.Tensor:
    """The ``[B]`` int32 row seeds of this rank's rows: ``seed[0] +
    data_index*P + b*H*P`` with int32 wraparound (``P = -1640531527``)."""
    seed = torch.as_tensor(seed).reshape(-1).to(torch.int64)
    rows = torch.arange(B, dtype=torch.int64, device=seed.device)
    return _as_int32(seed[0] + int(data_index) * _PRIME + rows * (H * _PRIME))


def _merge_hop(o_acc: torch.Tensor, lse_acc: torch.Tensor,
               out_hop: torch.Tensor, lse_hop: torch.Tensor):
    """Fold one hop's normalised output into the running f32 output:
    ``out = sum_hop out_hop * exp(lse_hop - lse)`` with ``lse`` the
    logaddexp over hops. An all-masked hop arrives with ``lse_hop`` near
    -1e30 and merges with weight zero; a row masked in every hop keeps
    finite values (logaddexp of -1e30s is -1e30, both weights 1), as in
    the JAX package."""
    lse_new = torch.logaddexp(lse_acc, lse_hop)                  # [B,H,Lq]
    w_acc = torch.exp(lse_acc - lse_new).permute(0, 2, 1)[..., None]
    w_hop = torch.exp(lse_hop - lse_new).permute(0, 2, 1)[..., None]
    return o_acc * w_acc + out_hop.float() * w_hop, lse_new


def _hop_mask(mask: torch.Tensor, visiting: torch.Tensor,
              seg: bool) -> torch.Tensor:
    return torch.cat([mask, visiting], dim=1).contiguous() if seg else visiting


def _stream_fwd_local(q, k, v, mask, seeds, *, transport: RingTransport,
                      seq_index: int, seq_size: int, rate: float, seg: bool):
    """This rank's ``(out in q's dtype, lse [B, H, L_loc] f32)`` against the
    whole sequence's K/V, the visiting blocks arriving over ``transport``."""
    B, L_loc, H, D = q.shape
    row_base, L_hash = seq_index * L_loc, seq_size * L_loc
    o = torch.zeros((B, L_loc, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, L_loc), NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur, m_cur = k, v, mask
    for step in range(seq_size):
        col_base = ((seq_index - step) % seq_size) * L_loc
        out_hop, lse_hop = streaming_attention(
            q, k_cur, v_cur, _hop_mask(mask, m_cur, seg), seed=seeds,
            rate=rate, segmented=seg, base=(row_base, col_base),
            L_hash=L_hash, seg_split=seg, want_lse=True)
        o, lse = _merge_hop(o, lse, out_hop, lse_hop)
        if step < seq_size - 1:
            k_cur, v_cur, m_cur = transport.hop([k_cur, v_cur, m_cur])
    return o.to(q.dtype), lse


def _stream_bwd_local(q, k, v, mask, seeds, out, lse, g, *,
                      transport: RingTransport, seq_index: int,
                      seq_size: int, rate: float, seg: bool):
    """``(dq, dk, dv)`` of this rank's blocks: dq summed over hops in f32,
    dk/dv partials rotating home with their blocks."""
    B, L_loc, H, D = q.shape
    row_base, L_hash = seq_index * L_loc, seq_size * L_loc
    bwd = (fused_attention_bwd_plain if q.device.type == "cpu"
           else fused_attention_bwd_cuda)
    g = g.to(q.dtype).contiguous()

    def zeros():
        return torch.zeros((B, L_loc, H, D), dtype=torch.float32,
                           device=q.device)

    dq, dk, dv = zeros(), zeros(), zeros()
    k_cur, v_cur, m_cur = k, v, mask
    for step in range(seq_size):
        col_base = ((seq_index - step) % seq_size) * L_loc
        dq_h, dk_h, dv_h = bwd(
            q, k_cur, v_cur, g, out, lse, _hop_mask(mask, m_cur, seg), seeds,
            rate, seg, base=(row_base, col_base), L_hash=L_hash,
            seg_split=seg)
        dq += dq_h.float()
        dk += dk_h.float()
        dv += dv_h.float()
        if step < seq_size - 1:
            k_cur, v_cur, m_cur, dk, dv = transport.hop(
                [k_cur, v_cur, m_cur, dk, dv])
    # the homeward hop: every partial has visited every rank
    dk, dv = transport.hop([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The ring under autograd: the forward keeps q, k, v, the mask, the
    seeds, the merged output and the global lse; the backward runs
    :func:`_stream_bwd_local` on them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seeds, ring: dict):
        out, lse = _stream_fwd_local(q, k, v, mask, seeds, **ring)
        ctx.save_for_backward(q, k, v, mask, seeds, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, seeds, out, lse = ctx.saved_tensors
        dq, dk, dv = _stream_bwd_local(q, k, v, mask, seeds, out, lse, g,
                                       **ctx.ring)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *, mesh,
                   rate: float = 0.0, seed=None,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Exact attention of this rank's ``[B, L_loc, H, D]`` q block against
    the whole sequence, whose K/V blocks the ``seq`` ring of ``mesh``
    (``parallel.mesh.Mesh``) holds. ``mask``: this rank's ``[B, L_loc]``
    key mask; ``segment_ids``: its ``[B, L_loc]`` packed-segment ids (0 =
    pad), which replace the mask; ``seed``: the (1,) int32 dropout seed
    (``ops.attention.dropout_seed``), folded with the mesh's data index.
    Differentiable in q, k and v (:class:`RingAttention`)."""
    B, L_loc, H, _ = q.shape
    if mesh is None or mesh.seq_size < 2:
        raise ValueError("ring attention needs a mesh with a 'seq' axis > 1 "
                         "(--mesh 'data:N,seq:M')")
    seg = segment_ids is not None
    if seg:
        ids = segment_ids
        if mask is not None:
            ids = torch.where(mask > 0, segment_ids, 0)
    elif mask is None:
        ids = torch.ones((B, L_loc), dtype=torch.int32, device=q.device)
    else:
        ids = mask
    ids = ids.to(torch.int32).contiguous()
    if rate > 0.0:
        if seed is None:
            raise ValueError("dropout_rate > 0 needs a seed")
        seeds = _stream_row_seeds(seed, B=B, H=H,
                                  data_index=mesh.data_index).to(q.device)
    else:
        seeds = torch.zeros((B,), dtype=torch.int32, device=q.device)
    ring = dict(transport=mesh.ring, seq_index=mesh.seq_index,
                seq_size=mesh.seq_size, rate=float(rate), seg=seg)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return RingAttention.apply(q, k, v, ids, seeds, ring)
    return _stream_fwd_local(q, k, v, ids, seeds, **ring)[0]
