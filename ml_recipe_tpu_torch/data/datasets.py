"""Dataset classes (a copy of ``ml_recipe_tpu/data/datasets.py``).

- ``SplitDataset``: training over the preprocessed NQ corpus, one chunk per
  document per read: the sliding-window or sentence-packed chunks of the
  document, weighted-sampled (answer chunks 1, answerless 1e-3) from the
  dataset's ``rng``, or in test mode the first chunk carrying the true label;
  optional truncation of over-long sentence chunks;
- ``ChunkDataset``: validation, ALL chunks of each document as
  :class:`ChunkItem` with the provenance the predictor renders from;
- ``DummyDataset``: fixed-shape random-token QA items whose content is a
  pure function of ``(base_seed, index)`` through numpy's ``SeedSequence``.

Both corpus datasets keep an LRU cache of tokenized documents keyed by the
example index. ``SplitDataset.__getitem__`` draws from one shared
``np.random.Generator``: read through a thread pool with more than one
worker, the draw order follows thread scheduling (in both packages), so
sampled batches equal the JAX package's only with one worker.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from .chunking import (
    ChunkRecord,
    assemble_input_ids,
    chunk_sampling_weights,
    encode_document,
    encode_document_by_sentences,
    pick_eval_chunk,
    sentence_chunks,
    truncate_record,
    window_chunks,
)
from .labels import id2labels, labels2id
from .preprocessor import RawPreprocessor
from .sentence import split_sentences

logger = logging.getLogger(__name__)


@dataclass
class DatasetItem:
    example_id: str
    input_ids: List[int]
    start_id: int
    end_id: int
    label_id: int
    start_position: float
    end_position: float


@dataclass
class ChunkItem:
    """Chunk + provenance for inference (validation_dataset.py:15-39)."""

    item_id: str
    input_ids: List[int]
    start_id: int
    end_id: int
    label_id: int

    true_text: str
    true_question: str
    true_label: int
    true_start: int
    true_end: int

    question_len: int

    t2o: List[int]

    chunk_start: int
    chunk_end: int

    start_position: float
    end_position: float


class _ChunkingDatasetBase:
    """Shared document-loading + chunk-enumeration machinery."""

    def __init__(
        self,
        data_dir,
        tokenizer,
        indexes,
        *,
        max_seq_len: int = 384,
        max_question_len: int = 64,
        doc_stride: int = 128,
        test: bool = False,
        split_by_sentence: bool = False,
        truncate: bool = False,
        cache_size: int = 1024,
        rng: Optional[np.random.Generator] = None,
    ):
        self.data_dir = Path(data_dir)
        self.tokenizer = tokenizer
        self.indexes = indexes

        self.max_seq_len = max_seq_len
        self.max_question_len = max_question_len
        self.doc_stride = doc_stride

        self.labels2id = labels2id
        self.id2labels = id2labels

        self.test = test
        self.truncate = truncate
        self.split_by_sentence = split_by_sentence

        self.rng = rng if rng is not None else np.random.default_rng()

        bpe_dropout_active = getattr(
            getattr(tokenizer, "tokenizer", None), "dropout", None
        )
        self.cache_size = 0 if bpe_dropout_active else cache_size
        self._cache: OrderedDict = OrderedDict()
        # loader threads share the cache: a hit's move_to_end must not race
        # another thread's eviction of the same key
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.indexes)

    def _load_line(self, idx: int) -> dict:
        with open(self.data_dir / f"{idx}.json", "r") as in_file:
            return json.load(in_file)

    def _encoded(self, idx: int, line: dict):
        """Tokenize document+question (cached); returns
        ``(encoded_question, per_sentence_or_flat_tokens, o2t, t2o)``."""
        with self._cache_lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]

        encoded_question = self.tokenizer.encode(line["question_text"])[: self.max_question_len]

        if self.split_by_sentence:
            tokens, o2t, t2o = encode_document_by_sentences(
                self.tokenizer, line["document_text"], split_sentences
            )
        else:
            tokens, o2t, t2o = encode_document(self.tokenizer, line["document_text"])

        value = (encoded_question, tokens, o2t, t2o)
        if self.cache_size > 0:
            with self._cache_lock:
                self._cache[idx] = value
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
        return value

    def _enumerate_chunks(self, idx: int, line: dict):
        """All chunks of one document + its mapped target."""
        encoded_question, tokens, o2t, t2o = self._encoded(idx, line)

        class_label, start_position, end_position = RawPreprocessor._get_target(line)

        assert start_position <= end_position, "Before mapping."
        if start_position < 0:
            # 'unknown': there is no answer span. The reference maps -1
            # through o2t[-1] (split_dataset.py:274-275), silently training
            # the span heads toward the document's last token on whichever
            # chunk contains it; keep the spanless (-1, -1) sentinel instead
            # (the losses/metrics mask -1).
            start_position = end_position = -1
        else:
            start_position = o2t[start_position]
            end_position = o2t[end_position]
        assert start_position <= end_position, "After mapping."

        target = (class_label, start_position, end_position)

        if self.split_by_sentence:
            records = sentence_chunks(
                tokens,
                target,
                question_len=len(encoded_question),
                max_seq_len=self.max_seq_len,
            )
        else:
            records = window_chunks(
                tokens,
                target,
                question_len=len(encoded_question),
                max_seq_len=self.max_seq_len,
                doc_stride=self.doc_stride,
                first_only=self.test,
            )

        return records, encoded_question, target, t2o

    def _finalize(self, rec: ChunkRecord, encoded_question) -> List[int]:
        if self.truncate:
            rec = truncate_record(
                rec, question_len=len(encoded_question), max_seq_len=self.max_seq_len
            )

        input_ids = assemble_input_ids(
            self.tokenizer.cls_token_id, self.tokenizer.sep_token_id, encoded_question, rec
        )

        assert len(input_ids) <= self.max_seq_len or not (
            self.truncate or not self.split_by_sentence
        ), (
            f"Chunk length {len(input_ids)} exceeds limit {self.max_seq_len} "
            f"(label {rec.label}, span [{rec.start}, {rec.end}], "
            f"doc window [{rec.doc_start}, {rec.doc_end}], #sents {rec.n_sents})."
        )
        assert -1 <= rec.start <= self.max_seq_len, f"Incorrect start index: {rec.start}."
        assert -1 <= rec.end <= self.max_seq_len, f"Incorrect end index: {rec.end}."

        return input_ids, rec


class SplitDataset(_ChunkingDatasetBase):
    """Training dataset: one weighted-sampled chunk per document per epoch."""

    def __getitem__(self, idx: int) -> DatasetItem:
        idx = int(self.indexes[idx])
        line = self._load_line(idx)

        records, encoded_question, target, _ = self._enumerate_chunks(idx, line)
        class_label = target[0]

        if self.test:
            pick = pick_eval_chunk(records, class_label)
        else:
            weights = chunk_sampling_weights(records)
            pick = int(self.rng.choice(np.arange(len(records)), p=weights))

        input_ids, rec = self._finalize(records[pick], encoded_question)

        return DatasetItem(
            example_id=line["example_id"],
            input_ids=input_ids,
            start_id=rec.start,
            end_id=rec.end,
            label_id=self.labels2id[rec.label],
            start_position=rec.start / self.max_seq_len,
            end_position=rec.end / self.max_seq_len,
        )


class ChunkDataset(_ChunkingDatasetBase):
    """Validation dataset: ALL chunks per document, with provenance."""

    def __getitem__(self, idx: int) -> List[ChunkItem]:
        idx = int(self.indexes[idx])
        line = self._load_line(idx)

        records, encoded_question, target, t2o = self._enumerate_chunks(idx, line)
        class_label, start_position, end_position = target

        chunks: List[ChunkItem] = []
        for rec in records:
            input_ids, rec = self._finalize(rec, encoded_question)
            chunks.append(
                ChunkItem(
                    item_id=line["example_id"],
                    input_ids=input_ids,
                    start_id=rec.start,
                    end_id=rec.end,
                    label_id=self.labels2id[rec.label],
                    true_text=line["document_text"],
                    true_question=line["question_text"],
                    question_len=len(encoded_question),
                    t2o=t2o,
                    chunk_start=rec.doc_start,
                    chunk_end=rec.doc_end,
                    true_label=self.labels2id[class_label],
                    true_start=start_position,
                    true_end=end_position,
                    start_position=rec.start / self.max_seq_len,
                    end_position=rec.end / self.max_seq_len,
                )
            )

        return chunks


class DummyDataset:
    """Synthetic random-token QA items at fixed shape (dummy_dataset.py:6-51)."""

    def __init__(
        self,
        data_dir=None,
        tokenizer=None,
        indexes=None,
        *,
        max_seq_len: int = 384,
        max_question_len: int = 64,
        dataset_len: int = 10000,
        rng: Optional[np.random.Generator] = None,
        **kwargs,
    ):
        self.tokenizer = tokenizer
        self.dataset_len = dataset_len
        self.max_seq_len = max_seq_len
        self.max_question_len = max_question_len
        seed_rng = rng if rng is not None else np.random.default_rng()
        self.base_seed = int(seed_rng.integers(2 ** 31))
        self.w_ids = (
            [tokenizer.pad_token_id, tokenizer.sep_token_id,
             tokenizer.cls_token_id]
            if tokenizer is not None else None
        )

    def __len__(self) -> int:
        return self.dataset_len

    def _delete_special(self, ids: np.ndarray) -> np.ndarray:
        if self.w_ids is None:
            raise ValueError(f"Dataset {type(self).__name__} was initialized "
                             f"with None tokenizer.")
        for w_id in self.w_ids:
            ids[ids == w_id] = self.tokenizer.unk_token_id
        return ids

    def __getitem__(self, index: int = 0) -> DatasetItem:
        document_len = self.max_seq_len - self.max_question_len - 3
        rng = np.random.default_rng(
            np.random.SeedSequence([self.base_seed, int(index)]))
        question_ids = self._delete_special(
            rng.integers(1, len(self.tokenizer), self.max_question_len)
        ).tolist()
        document_ids = self._delete_special(
            rng.integers(1, len(self.tokenizer), document_len)
        ).tolist()
        input_ids = (
            [self.tokenizer.cls_token_id] + question_ids
            + [self.tokenizer.sep_token_id] + document_ids
            + [self.tokenizer.sep_token_id]
        )
        return DatasetItem(
            example_id="None",
            input_ids=input_ids,
            start_id=0,
            end_id=self.max_seq_len - 1,
            label_id=0,
            start_position=0.0,
            end_position=1.0,
        )
