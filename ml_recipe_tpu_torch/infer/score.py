"""The QA scoring forward shared by online serving (and, later, the batch
predictor): the port of ``ml_recipe_tpu/infer/score.py`` ``build_score_fn``.

Model forward + the arXiv 1901.08634 answerability score (``s = max(start)
+ max(end) - (start[0] + end[0])``) + per-row argmax/softmax reductions on
the device, so ONE packed ``[6, B]`` f32 tensor crosses to the host per
batch, in ``OUT_KEYS`` row order.

Two wire formats, selected by the caller:

- ids-only (``wire_ids_only=True``): one ``[B, L]`` plane of 16-bit ids
  (sent as int16 bit patterns: torch's uint16 support is partial); the
  attention mask (``ids != pad_id``) and BERT token types (1 strictly after
  the first [SEP]) are derived on the device exactly as the JAX function
  does. Needs vocab < 2**16;
- 3-plane (``wire_ids_only=False``): ``[3, B, L]`` int32 (input_ids /
  attention_mask / token_type_ids).

``torch.argmax`` returns the first maximal index, the tie rule of
``jnp.argmax``.
"""

from __future__ import annotations

from typing import Callable

import torch

OUT_KEYS = ("scores", "start_ids", "end_ids", "start_regs", "end_regs",
            "labels")


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
