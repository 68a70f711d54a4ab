"""Long-document chunking: the serving subset of ``ml_recipe_tpu/data/chunking.py``.

- HTML-tag dropping + word<->token offset maps (``drop_tags_and_encode``,
  ``encode_document``);
- fixed-stride sliding windows of ``max_seq_len - len(q) - 3`` tokens
  stepping ``doc_stride`` (``window_chunks``);
- ``[CLS] question [SEP] chunk [SEP]`` assembly (``assemble_input_ids``).

The sentence packer, truncation and the packing helpers come with the
training slice. This is host-side Python by design: chunk geometry is
data-dependent and belongs on the host; the device sees only fixed-shape
padded batches.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence, Tuple

_TAG_RE = re.compile(r"<.+>")


@dataclass
class ChunkRecord:
    """One candidate chunk of a document, with provenance."""

    token_ids: List[int]  # document-side tokens only (no [CLS]/question/[SEP])
    start: int  # answer start index in the FINAL input (question offset applied), or -1
    end: int
    label: str
    doc_start: int  # chunk bounds in document-token coordinates
    doc_end: int
    n_sents: int = 0


def drop_tags_and_encode(
    tokenizer, text: str, *, history_len: int = 0, start: int = -1
) -> Tuple[List[int], List[int], List[int], int, int]:
    """Tokenize whitespace-split words, skipping ``<...>`` HTML-tag words.

    Returns ``(token_ids, o2t, t2o, new_history_len, last_word_i)`` where
    ``o2t[word_i]`` is the token index at which word ``word_i`` begins (tag
    words map to the next real token) and ``t2o[tok_i]`` is the word index a
    token came from. ``history_len``/``start`` continue the numbering across
    sentence-by-sentence calls.
    """
    words = text.split()

    o2t: List[int] = []
    t2o: List[int] = []

    token_ids: List[int] = []
    word_i = start
    for word_i, word in enumerate(words, start=start + 1):
        o2t.append(len(token_ids) + history_len)
        if _TAG_RE.match(word):
            continue

        for token in tokenizer.encode(word):
            t2o.append(word_i)
            token_ids.append(token)

    return token_ids, o2t, t2o, history_len + len(token_ids), word_i


def encode_document(tokenizer, text: str):
    """Whole-document encoding with offset maps.

    ``o2t`` gets a trailing SENTINEL entry ``o2t[n_words] == n_tokens``:
    answer spans use exclusive word ends, so a span ending at the document's
    last word maps through ``o2t[len(words)]``. (The reference indexes o2t
    unguarded, split_dataset.py:274-275 — it crashes on a corpus line whose
    annotated long answer is the final candidate; found by the real-schema
    fixtures, tests/test_nq_fixtures.py.)"""
    token_ids, o2t, t2o, _, _ = drop_tags_and_encode(tokenizer, text)
    o2t.append(len(token_ids))
    return token_ids, o2t, t2o


def _label_for_window(
    doc_start: int,
    doc_end: int,
    start_position: int,
    end_position: int,
    class_label: str,
    question_offset: int,
) -> Tuple[int, int, str]:
    """Answer indices within one chunk window, 'unknown' if not contained."""
    if not (doc_start <= start_position and end_position <= doc_end):
        return -1, -1, "unknown"
    return (
        start_position - doc_start + question_offset,
        end_position - doc_start + question_offset,
        class_label,
    )


def window_chunks(
    encoded_text: Sequence[int],
    target: Tuple[str, int, int],
    *,
    question_len: int,
    max_seq_len: int,
    doc_stride: int,
    first_only: bool = False,
) -> List[ChunkRecord]:
    """Fixed-stride sliding windows (split_dataset.py:287-306 semantics)."""
    class_label, start_position, end_position = target
    document_len = max_seq_len - question_len - 3  # [CLS], [SEP], [SEP]
    question_offset = question_len + 2

    records: List[ChunkRecord] = []
    for doc_start in range(0, max(len(encoded_text), 1), doc_stride):
        doc_end = doc_start + document_len
        start, end, label = _label_for_window(
            doc_start, doc_end, start_position, end_position, class_label, question_offset
        )
        records.append(
            ChunkRecord(
                token_ids=list(encoded_text[doc_start:doc_end]),
                start=start,
                end=end,
                label=label,
                doc_start=doc_start,
                doc_end=doc_end,
            )
        )
        if first_only:
            break

    return records


def assemble_input_ids(
    cls_id: int, sep_id: int, encoded_question: Sequence[int], rec: ChunkRecord
) -> List[int]:
    """``[CLS] question [SEP] chunk [SEP]`` (split_dataset.py:309-311)."""
    return [cls_id, *encoded_question, sep_id, *rec.token_ids, sep_id]
