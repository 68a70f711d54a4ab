"""Training datasets: the synthetic ``DummyDataset`` (a copy of the one in
``ml_recipe_tpu/data/datasets.py``).

Items are fixed-shape random-token QA examples whose content is a pure
function of ``(base_seed, index)`` through numpy's ``SeedSequence``, so the
port and the JAX package give the same items from the same seed. The NQ
corpus datasets (``SplitDataset``, ``ChunkDataset``) are not ported yet
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class DatasetItem:
    example_id: str
    input_ids: List[int]
    start_id: int
    end_id: int
    label_id: int
    start_position: float
    end_position: float


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
