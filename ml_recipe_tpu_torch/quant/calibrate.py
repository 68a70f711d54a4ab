"""Parity harness: does the int8 path answer like the float one?

The port of ``ml_recipe_tpu/quant/calibrate.py``: the same scoring forward
(``infer/score.build_score_fn``, the one serving runs) through the float
model and its int8 twin on identical inputs, and how often they pick the
same span and label, and how far the answerability scores move.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..infer.score import OUT_KEYS, build_score_fn

__all__ = ["make_parity_batches", "score_chunks", "span_parity"]


def make_parity_batches(
    tokenizer,
    lines: Sequence[dict],
    *,
    max_seq_len: int,
    max_question_len: int = 16,
    doc_stride: int = 128,
    batch_size: int = 8,
    limit: int = 64,
) -> List[Dict[str, np.ndarray]]:
    """Chunk NQ-style lines (``question_text``, ``document_text``) into
    serving-shaped host batches with the engine's own request machinery
    (``data/chunking.py``). Returns 3-plane dicts of ``[batch_size,
    max_seq_len]`` int32; the trailing partial batch repeats its last row."""
    from ..data.chunking import assemble_input_ids, encode_document, window_chunks

    cls_id = int(tokenizer.cls_token_id)
    sep_id = int(tokenizer.sep_token_id)
    pad_id = int(tokenizer.pad_token_id)

    rows: List[List[int]] = []
    for line in lines:
        enc_q = tokenizer.encode(line["question_text"])[:max_question_len]
        tokens, _, _ = encode_document(tokenizer, line["document_text"])
        for rec in window_chunks(
            tokens, ("unknown", -1, -1), question_len=len(enc_q),
            max_seq_len=max_seq_len, doc_stride=doc_stride,
        ):
            rows.append(assemble_input_ids(cls_id, sep_id, enc_q, rec))
            if len(rows) >= limit:
                break
        if len(rows) >= limit:
            break

    batches = []
    for at in range(0, len(rows), batch_size):
        group = rows[at: at + batch_size]
        group = group + [group[-1]] * (batch_size - len(group))
        ids = np.full((batch_size, max_seq_len), pad_id, np.int32)
        mask = np.zeros_like(ids)
        tt = np.zeros_like(ids)
        for i, row in enumerate(group):
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
            seps = [j for j, t in enumerate(row) if t == sep_id]
            if seps:
                tt[i, seps[0] + 1: len(row)] = 1
        batches.append({
            "input_ids": ids, "attention_mask": mask, "token_type_ids": tt,
        })
    return batches


def score_chunks(model, batches: Sequence[Dict[str, np.ndarray]]
                 ) -> np.ndarray:
    """The scoring forward over host batches on the model's device: the
    concatenated packed output ``[6, n_rows]`` in ``OUT_KEYS`` order."""
    fwd = build_score_fn(model, wire_ids_only=False)
    device = model.device
    outs = []
    with torch.inference_mode():
        for b in batches:
            planes = torch.from_numpy(np.stack([
                np.asarray(b["input_ids"], np.int32),
                np.asarray(b["attention_mask"], np.int32),
                np.asarray(b["token_type_ids"], np.int32),
            ])).to(device)
            outs.append(fwd(planes).cpu().numpy())
    return np.concatenate(outs, axis=1) if outs else np.zeros((6, 0))


def span_parity(model, qmodel, batches: Sequence[Dict[str, np.ndarray]]
                ) -> dict:
    """Agreement of the quantized scoring path with the float one on
    identical inputs: span (start AND end) and label agreement fractions,
    and the answerability-score drift."""
    ref = score_chunks(model, batches)
    q = score_chunks(qmodel, batches)
    keys = {k: i for i, k in enumerate(OUT_KEYS)}
    n = ref.shape[1]
    if n == 0:
        return {"n_chunks": 0, "span_agreement": None,
                "label_agreement": None, "score_max_abs_delta": None,
                "score_mean_abs_delta": None}
    span_ok = np.logical_and(
        ref[keys["start_ids"]] == q[keys["start_ids"]],
        ref[keys["end_ids"]] == q[keys["end_ids"]],
    )
    label_ok = ref[keys["labels"]] == q[keys["labels"]]
    sdelta = np.abs(ref[keys["scores"]] - q[keys["scores"]])
    return {
        "n_chunks": int(n),
        "span_agreement": float(np.mean(span_ok)),
        "label_agreement": float(np.mean(label_ok)),
        "score_max_abs_delta": float(np.max(sdelta)),
        "score_mean_abs_delta": float(np.mean(sdelta)),
    }
