"""Long-document chunking (a copy of ``ml_recipe_tpu/data/chunking.py``).

- HTML-tag dropping + word<->token offset maps (``drop_tags_and_encode``,
  ``encode_document``, and per sentence ``encode_document_by_sentences``);
- fixed-stride sliding windows of ``max_seq_len - len(q) - 3`` tokens
  stepping ``doc_stride`` (``window_chunks``);
- sentence-packed rolling windows (``sentence_chunks``) and the cut of an
  over-long sentence chunk (``truncate_record``);
- ``[CLS] question [SEP] chunk [SEP]`` assembly (``assemble_input_ids``);
- the training dataset's chunk pick: ``chunk_sampling_weights`` (answer
  chunks 1, answerless 1e-3) and ``pick_eval_chunk``; ``label_safe_cut``,
  the splitting packer's cut rule.

Each chunker returns every chunk of the document as :class:`ChunkRecord`.
This is host-side Python by design: chunk geometry is data-dependent and
belongs on the host; the device sees only fixed-shape padded batches.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence, Tuple

_TAG_RE = re.compile(r"<.+>")

# Answer-bearing chunks weighted 1, answerless 1e-3 (split_dataset.py:221).
LABEL2WEIGHT = {"yes": 1.0, "no": 1.0, "short": 1.0, "long": 1.0, "unknown": 1e-3}


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


def encode_document_by_sentences(
    tokenizer, text: str, sentence_splitter: Callable[[str], List[str]]
):
    """Per-sentence encoding with document-global offset maps."""
    sentences = sentence_splitter(text)

    t_sens: List[List[int]] = []
    o2t: List[int] = []
    t2o: List[int] = []

    start = -1
    history = 0
    for sen in sentences:
        sen_ids, o2t_, t2o_, history, start = drop_tags_and_encode(
            tokenizer, sen, history_len=history, start=start
        )
        t_sens.append(sen_ids)
        o2t.extend(o2t_)
        t2o.extend(t2o_)

    # same end-of-document sentinel as encode_document: exclusive span ends
    # at the last word map to one past the last token
    o2t.append(history)
    return t_sens, o2t, t2o


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


def sentence_chunks(
    t_sens: Sequence[Sequence[int]],
    target: Tuple[str, int, int],
    *,
    question_len: int,
    max_seq_len: int,
) -> List[ChunkRecord]:
    """Sentence-packed rolling-window chunks (split_dataset.py:374-412).

    A chunk is emitted every time appending the next sentence would overflow
    the window; the window then drops sentences from the front until the new
    sentence fits. A final tail chunk always closes the document.
    """
    class_label, start_position, end_position = target
    document_len = max_seq_len - question_len - 3
    question_offset = question_len + 2

    records: List[ChunkRecord] = []

    doc_start = 0
    doc_end = 0
    window: List[Sequence[int]] = []

    def emit(n_sents: int) -> None:
        start, end, label = _label_for_window(
            doc_start, doc_end, start_position, end_position, class_label, question_offset
        )
        records.append(
            ChunkRecord(
                token_ids=[t for sen in window for t in sen],
                start=start,
                end=end,
                label=label,
                doc_start=doc_start,
                doc_end=doc_end,
                n_sents=n_sents,
            )
        )

    for sen_ids in t_sens:
        assert doc_end - doc_start >= 0

        if doc_end - doc_start + len(sen_ids) > document_len:
            while window and (doc_end - doc_start + len(sen_ids) > document_len):
                emit(len(window))
                dropped = window.pop(0)
                doc_start += len(dropped)

        doc_end += len(sen_ids)
        window.append(sen_ids)

    emit(len(window))  # tail

    return records


def truncate_record(rec: ChunkRecord, *, question_len: int, max_seq_len: int) -> ChunkRecord:
    """Cut an over-long sentence chunk down to the window (split_dataset.py:430-442).

    If the answer lies inside the first ``document_len`` tokens the chunk is
    simply cut; otherwise the cut window is re-anchored at the answer start
    and the span re-indexed relative to the slice.
    """
    document_len = max_seq_len - question_len - 3
    question_offset = question_len + 2

    if len(rec.token_ids) <= document_len:
        return rec

    start_ = rec.start - question_offset
    end_ = rec.end - question_offset

    if start_ < document_len and end_ < document_len:
        return replace(rec, token_ids=rec.token_ids[:document_len])

    token_ids = rec.token_ids[start_:start_ + document_len]
    new_end = min(end_ - start_, len(token_ids))
    return replace(
        rec,
        token_ids=token_ids,
        start=question_offset,
        end=new_end + question_offset,
    )


def assemble_input_ids(
    cls_id: int, sep_id: int, encoded_question: Sequence[int], rec: ChunkRecord
) -> List[int]:
    """``[CLS] question [SEP] chunk [SEP]`` (split_dataset.py:309-311)."""
    return [cls_id, *encoded_question, sep_id, *rec.token_ids, sep_id]


def label_safe_cut(
    length: int,
    span: Optional[Tuple[int, int]],
    hole: int,
    min_fragment: int,
) -> Optional[int]:
    """Token-boundary cut point for splitting a ``length``-token chunk so
    its head fragment fills a ``hole``-token residual gap of an open pack
    row (data/packing.py's splitting packer), or ``None`` when no legal cut
    exists.

    A cut at ``c`` makes fragments ``[0, c)`` and ``[c, length)``. Legal
    means: both fragments are at least ``min_fragment`` tokens (no
    degenerate one-token segments), the head fits the hole (``c <= hole``),
    and the cut NEVER lands strictly inside the gold answer span ``span``
    (inclusive ``(start, end)`` token indices into the chunk) — a bisected
    span would leave NO fragment containing the whole answer, so neither
    could carry the labels. The nominal cut is the hole-filling maximum
    ``min(hole, length - min_fragment)``; when that would bisect the span,
    the cut retreats to the span start (the span moves wholly into the
    tail — the nominal cut is already the LARGEST legal cut, so past the
    span end is never an option), and when even that violates the
    min_fragment floor there is no legal cut. Pure arithmetic over
    ``(length, span, hole)`` — the property that lets every host derive
    identical split plans from the shared length oracle.
    """
    min_fragment = max(1, int(min_fragment))
    cut = min(int(hole), int(length) - min_fragment)
    if cut < min_fragment:
        return None
    if span is not None:
        start, end = int(span[0]), int(span[1])
        if 0 <= start <= end < length and start < cut <= end:
            # nominal cut bisects the span: retreat to its start so the
            # whole span lands in the tail fragment
            if start < min_fragment:
                return None
            cut = start
    return cut


def chunk_sampling_weights(records: Sequence[ChunkRecord]):
    import numpy as np

    weights = np.asarray([LABEL2WEIGHT[r.label] for r in records], dtype=np.float64)
    return weights / weights.sum()


def pick_eval_chunk(records: Sequence[ChunkRecord], class_label: str) -> int:
    """Deterministic pick for test mode: first chunk carrying the true label
    (split_dataset.py:417-421); falls back to the last chunk."""
    idx = len(records) - 1
    for i, rec in enumerate(records):
        if rec.label == class_label:
            return i
    return idx
