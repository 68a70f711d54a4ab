"""The QA scoring forward shared by online serving and the batch predictor
(``infer/predictor.py``): the port of ``ml_recipe_tpu/infer/score.py``
``build_score_fn``.

Model forward + the arXiv 1901.08634 answerability score (``s = max(start)
+ max(end) - (start[0] + end[0])``) + per-row argmax/softmax reductions on
the device, so ONE packed ``[6, B]`` f32 tensor crosses to the host per
batch, in ``OUT_KEYS`` row order.

Two wire formats; :func:`score_wire` picks one from the tokenizer, for the
serving engine and the predictor alike, and :func:`pack_wire` packs a host
batch in it:

- ids-only (``wire_ids_only=True``): one ``[B, L]`` plane of 16-bit ids
  (sent as int16 bit patterns: torch's uint16 support is partial); the
  attention mask (``ids != pad_id``) and BERT token types (1 strictly after
  the first [SEP]) are derived on the device exactly as the JAX function
  does. Needs vocab < 2**16;
- 3-plane (``wire_ids_only=False``): ``[3, B, L]`` int32 (input_ids /
  attention_mask / token_type_ids).

Sequence packing (:func:`build_packed_score_fn`): one forward scores every
chunk packed into a batch's rows, per segment, and ``[8, R, S]`` crosses to
the host in ``PACKED_OUT_KEYS`` order; :class:`FragmentMerger` re-merges
the segments of a split chunk on the host.

``torch.argmax`` returns the first maximal index, the tie rule of
``jnp.argmax``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

OUT_KEYS = ("scores", "start_ids", "end_ids", "start_regs", "end_regs",
            "labels")

# row order of the packed [8, R, S] output: OUT_KEYS and each segment's
# span-logit maxima, which the fragment re-merge combines (a split chunk's
# argmax is that of its fragments' (max, argmax) pairs, and the score's
# [CLS] anchor is the head fragment's start_max + end_max - score)
PACKED_OUT_KEYS = OUT_KEYS + ("start_max", "end_max")


def build_score_fn(
    model,
    *,
    wire_ids_only: bool,
    pad_id: int = 0,
    sep_id: int = 0,
    is_bert: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``f(packed_inputs) -> [6, B]`` f32 on the model's device.

    ``packed_inputs`` is ``[B, L]`` int16 (16-bit id patterns) when
    ``wire_ids_only`` else ``[3, B, L]`` int32. Call it under
    ``torch.inference_mode()``."""

    def score_fn(packed_inputs: torch.Tensor) -> torch.Tensor:
        if wire_ids_only:
            ids = packed_inputs.to(torch.int64) & 0xFFFF
            mask = (ids != pad_id).to(torch.int32)
            if is_bert:
                seps = (ids == sep_id).to(torch.int32)
                tt = torch.clamp(torch.cumsum(seps, dim=-1) - seps, 0, 1)
            else:
                tt = torch.zeros_like(ids)
        else:
            ids = packed_inputs[0].to(torch.int64)
            mask = packed_inputs[1]
            tt = packed_inputs[2].to(torch.int64)
        preds = model(input_ids=ids, attention_mask=mask, token_type_ids=tt)

        start = preds["start_class"]  # [B, L], pad positions already -1e9
        end = preds["end_class"]
        start_logits, start_ids = start.max(dim=-1).values, start.argmax(dim=-1)
        end_logits, end_ids = end.max(dim=-1).values, end.argmax(dim=-1)
        cls_ids = torch.softmax(preds["cls"], dim=-1).argmax(dim=-1)
        scores = start_logits + end_logits - (start[:, 0] + end[:, 0])

        fields = {
            "scores": scores,
            "start_ids": start_ids,
            "end_ids": end_ids,
            "start_regs": preds["start_reg"],
            "end_regs": preds["end_reg"],
            "labels": cls_ids,
        }
        return torch.stack([fields[k].to(torch.float32) for k in OUT_KEYS])

    return score_fn


def build_packed_score_fn(model) -> Callable[[torch.Tensor, torch.Tensor],
                                              torch.Tensor]:
    """The packed twin of :func:`build_score_fn`: ``f(planes,
    segment_starts) -> [8, R, S]`` f32, ``planes`` ``[4, R, L]`` int32
    (input_ids / token_type_ids / segment_ids / position_ids; the attention
    mask is ``segment_ids > 0``), ``segment_starts`` ``[R, S]``. Per
    segment:

    - span ids are segment-relative (the row argmax minus the segment's
      start): chunk-relative for whole chunks, so the validity rules apply
      unchanged; a fragment's are rebased by :class:`FragmentMerger`;
    - the answerability score's [CLS] anchor is the segment's own first row
      (for one full-length segment, the unpacked ``start[:, 0]``);
    - ``start_max``/``end_max``: the segment's span-logit maxima.

    Absent segments give entries the caller drops through the host-side
    ``segment_mask``. Call it under ``torch.inference_mode()``."""

    def score_fn(planes: torch.Tensor,
                 segment_starts: torch.Tensor) -> torch.Tensor:
        ids, tt, seg, pos = (planes[i].to(torch.int64) for i in range(4))
        starts = segment_starts.to(torch.int64)
        preds = model(input_ids=ids, attention_mask=(seg > 0).to(torch.int32),
                      token_type_ids=tt, position_ids=pos, segment_ids=seg,
                      segment_starts=starts)
        start = preds["start_class"]   # [R, S, L], off-segment tokens -1e9
        end = preds["end_class"]
        start_logits, end_logits = start.max(dim=-1).values, end.max(dim=-1).values
        cls_ids = torch.softmax(preds["cls"], dim=-1).argmax(dim=-1)
        cls_start = torch.gather(start, -1, starts[..., None])[..., 0]
        cls_end = torch.gather(end, -1, starts[..., None])[..., 0]
        fields = {
            "scores": start_logits + end_logits - (cls_start + cls_end),
            "start_ids": start.argmax(dim=-1) - starts,
            "end_ids": end.argmax(dim=-1) - starts,
            "start_regs": preds["start_reg"],
            "end_regs": preds["end_reg"],
            "labels": cls_ids,
            "start_max": start_logits,
            "end_max": end_logits,
        }
        return torch.stack([fields[k].to(torch.float32)
                            for k in PACKED_OUT_KEYS])

    return score_fn


class FragmentMerger:
    """The host-side re-merge of split chunks' outputs (``--pack_splitting
    fill``).

    Takes ``(entry, fields)`` pairs in any order: ``entry`` a whole item
    (passed through) or a ``data.packing.ChunkFragment``, ``fields`` its
    segment's ``PACKED_OUT_KEYS`` values. Fragments wait per ``chunk_id``
    until the whole chunk has reported (its fragments often land in other
    batches), then merge into one chunk's fields:

    - span ids: the argmax over the joined fragments, that is the winning
      fragment's (the larger span-logit max) shifted by its offset;
    - score: the best ``start_max`` + the best ``end_max`` minus the [CLS]
      anchor of the head fragment (``head.start_max + head.end_max -
      head.score``: the head starts at the chunk's position 0);
    - ``start_regs``/``end_regs``/``labels``: the head's (its pooled row is
      the chunk's [CLS])."""

    def __init__(self):
        self._pending: dict = {}   # chunk_id -> {fragment index: (frag, fields)}

    def add(self, entry, fields: dict) -> list:
        """One segment's outputs; returns the ``(chunk item, fields)``
        pairs this completes (possibly none)."""
        from ..data.packing import ChunkFragment

        if not isinstance(entry, ChunkFragment):
            return [(entry, fields)]
        parts = self._pending.setdefault(entry.chunk_id, {})
        parts[entry.index] = (entry, fields)
        count = entry.count
        if count and len(parts) == count:
            del self._pending[entry.chunk_id]
            return [self._merge([parts[i] for i in range(count)])]
        return []

    @property
    def pending(self) -> int:
        """Chunks still waiting for fragments (0 after a whole stream)."""
        return len(self._pending)

    @staticmethod
    def _merge(parts):
        head, head_fields = parts[0]
        assert head.index == 0 and head.offset == 0, (
            "head fragment missing from re-merge")

        def best(key_max, key_id):
            frag, fields = max(parts, key=lambda p: p[1][key_max])
            return fields[key_max], frag.offset + int(fields[key_id])

        start_max, start_id = best("start_max", "start_ids")
        end_max, end_id = best("end_max", "end_ids")
        anchor = (head_fields["start_max"] + head_fields["end_max"]
                  - head_fields["scores"])
        merged = {
            "scores": start_max + end_max - anchor,
            "start_ids": start_id,
            "end_ids": end_id,
            "start_regs": head_fields["start_regs"],
            "end_regs": head_fields["end_regs"],
            "labels": head_fields["labels"],
            "start_max": start_max,
            "end_max": end_max,
        }
        return head.item, merged


def score_wire(model, tokenizer: Optional[object]
               ) -> Tuple[bool, Callable[[torch.Tensor], torch.Tensor]]:
    """``(ids_only, score_fn)``: the ids-only wire when ``tokenizer`` is
    given and its vocab fits 16 bits (the device derives the mask from its
    pad id and BERT token types from its [SEP] id), else the 3-plane wire;
    and the scoring forward that reads it."""
    vocab = None
    if tokenizer is not None:
        try:
            vocab = len(tokenizer)
        except TypeError:
            vocab = getattr(tokenizer, "vocab_size", None)
    if vocab is None or vocab >= 2 ** 16:
        return False, build_score_fn(model, wire_ids_only=False)
    return True, build_score_fn(
        model, wire_ids_only=True, pad_id=int(tokenizer.pad_token_id),
        sep_id=int(tokenizer.sep_token_id),
        is_bert=getattr(tokenizer, "model_name", "bert") == "bert")


def pack_wire(inputs: dict, ids_only: bool) -> torch.Tensor:
    """A collate-shaped host batch as a CPU tensor in the wire format: the
    ``[B, L]`` int16 id patterns (only ``input_ids`` is read), or the
    ``[3, B, L]`` int32 planes."""
    if ids_only:
        ids = np.asarray(inputs["input_ids"]).astype(np.uint16)
        return torch.from_numpy(np.ascontiguousarray(ids.view(np.int16)))
    return torch.from_numpy(np.stack([
        np.asarray(inputs[k], np.int32)
        for k in ("input_ids", "attention_mask", "token_type_ids")]))
