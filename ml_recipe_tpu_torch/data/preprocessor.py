"""One-time corpus preparation for the TF2.0-QA (Natural Questions) JSONL (a
copy of ``ml_recipe_tpu/data/preprocessor.py``, writing the same files, so a
directory processed by either package is read by the other).

Parity target: reference ``modules/model/dataset/split_dataset.py:22-188``:
- ``LineDataExtractor``: random-access JSONL reader (split_dataset.py:22-47).
- ``RawPreprocessor``: per-line target extraction into the 5-class label space
  {yes,no,short,long,unknown} + answer span (split_dataset.py:74-122), one
  ``{i}.json`` record per example + pickled ``label.info``
  (split_dataset.py:124-154), and a stratified-per-class 95/5 train/test split
  pickled to ``split.info`` (split_dataset.py:156-188).

Deltas from the reference:
- line offsets are indexed once instead of ``linecache`` + ``wc -l`` shell-out;
- the stratified split is first-party numpy (no sklearn), deterministic via a
  fixed-seed Generator (reference used ``train_test_split(random_state=0)``).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import defaultdict
from pathlib import Path
from typing import Tuple

import numpy as np

from .labels import id2labels, labels2id

logger = logging.getLogger(__name__)


class LineDataExtractor:
    """Random access to a JSONL corpus by line number."""

    def __init__(self, data_path):
        self.data_path = str(data_path)

        logger.info(f"Indexing lines of file {self.data_path}...")
        self._offsets = [0]
        with open(self.data_path, "rb") as fh:
            for line in fh:
                self._offsets.append(self._offsets[-1] + len(line))
        self._offsets.pop()
        logger.info(f"Line number is {len(self._offsets)}.")

    def __len__(self) -> int:
        return len(self._offsets)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx: int) -> dict:
        with open(self.data_path, "rb") as fh:
            fh.seek(self._offsets[idx])
            return json.loads(fh.readline())


class RawPreprocessor:
    # the one label table of the port (data/labels.py)
    labels2id = labels2id
    id2labels = id2labels

    def __init__(self, raw_json, out_dir, *, clear: bool = False, test_size: float = 0.05):
        self.raw_json = raw_json
        self.out_dir = Path(out_dir)
        self.test_size = test_size

        os.makedirs(self.out_dir, exist_ok=True)

        self.label_info_path = self.out_dir / "label.info"
        self.split_info_path = self.out_dir / "split.info"

        if clear:
            for rm_file in self.out_dir.glob("*"):
                os.remove(rm_file)

        self._extractor = None

    @property
    def data_extractor(self) -> LineDataExtractor:
        if self._extractor is None:
            self._extractor = LineDataExtractor(self.raw_json)
        return self._extractor

    # -- record extraction ----------------------------------------------------

    @staticmethod
    def _process_line(raw_line: dict) -> dict:
        """Flatten one NQ example (split_dataset.py:74-99 field contract)."""
        line = {}

        document_text = raw_line["document_text"].split()

        line["document_text"] = raw_line["document_text"]
        line["question_text"] = raw_line["question_text"]
        line["example_id"] = raw_line["example_id"]

        annotations = raw_line["annotations"][0]

        line["yes_no_answer"] = annotations["yes_no_answer"]

        start = annotations["long_answer"]["start_token"]
        end = annotations["long_answer"]["end_token"]
        line["long_answer"] = "NONE" if start == end else document_text[start:end]
        line["long_answer_start"] = start
        line["long_answer_end"] = end
        line["long_answer_index"] = annotations["long_answer"]["candidate_index"]

        line["short_answers"] = annotations["short_answers"]

        line["long_answer_candidates"] = raw_line["long_answer_candidates"]

        return line

    @staticmethod
    def _get_target(line: dict) -> Tuple[str, int, int]:
        """5-class label + span (split_dataset.py:101-122 priority order)."""
        if line["yes_no_answer"] in ["YES", "NO"]:
            class_label = line["yes_no_answer"].lower()
            start_position = line["long_answer_start"]
            end_position = line["long_answer_end"]
        elif line["short_answers"]:
            class_label = "short"
            short_answers = line["short_answers"]
            start_position = short_answers[0]["start_token"]
            end_position = short_answers[0]["end_token"]
        elif line["long_answer_index"] != -1:
            class_label = "long"
            start_position = line["long_answer_start"]
            end_position = line["long_answer_end"]
        else:
            class_label = "unknown"
            start_position = -1
            end_position = -1

        return class_label, start_position, end_position

    # -- main entry -----------------------------------------------------------

    def __call__(self):
        if self.label_info_path.exists():
            with open(self.label_info_path, "rb") as in_file:
                labels_counter, labels = pickle.load(in_file)
            logger.info(f"Labels info was loaded from {self.label_info_path}.")
        else:
            labels_counter: dict = defaultdict(int)
            labels = np.zeros((len(self.data_extractor),))

            for line_i, raw in enumerate(self.data_extractor):
                line = RawPreprocessor._process_line(raw)

                label = self.labels2id[RawPreprocessor._get_target(line)[0]]

                labels[line_i] = label
                labels_counter[label] += 1

                with open(self.out_dir / f"{line_i}.json", "w") as out_file:
                    json.dump(line, out_file)

            with open(self.label_info_path, "wb") as out_file:
                pickle.dump((labels_counter, labels), out_file)
            logger.info(f"Label information was dumped to {self.label_info_path}.")

        split_info = self._split_train_test(labels)

        return labels_counter, labels, split_info

    def _split_train_test(self, labels: np.ndarray):
        """Deterministic per-class stratified split (split_dataset.py:156-188)."""
        if self.split_info_path.exists():
            with open(self.split_info_path, "rb") as in_file:
                (train_indexes, train_labels, test_indexes, test_labels) = pickle.load(in_file)
            logger.info(f"Split information was loaded from {self.split_info_path}.")
        else:
            indexes = np.arange(len(labels))
            rng = np.random.default_rng(0)

            train_indexes, train_labels, test_indexes, test_labels = [], [], [], []
            for label_i in range(len(self.labels2id)):
                class_ids = indexes[labels == label_i]
                if len(class_ids) == 0:
                    continue
                perm = rng.permutation(class_ids)
                n_test = max(1, int(round(len(perm) * self.test_size))) if len(perm) > 1 else 0

                test_ids = perm[:n_test]
                train_ids = perm[n_test:]

                train_indexes.append(train_ids)
                train_labels.append(np.full(len(train_ids), label_i, dtype=labels.dtype))
                test_indexes.append(test_ids)
                test_labels.append(np.full(len(test_ids), label_i, dtype=labels.dtype))

            train_indexes = np.concatenate(train_indexes, axis=0)
            train_labels = np.concatenate(train_labels, axis=0)
            test_indexes = np.concatenate(test_indexes, axis=0)
            test_labels = np.concatenate(test_labels, axis=0)

            with open(self.split_info_path, "wb") as out_file:
                pickle.dump((train_indexes, train_labels, test_indexes, test_labels), out_file)
            logger.info(f"Split information was dumped to {self.split_info_path}.")

        assert len(train_indexes) == len(train_labels)
        assert len(test_indexes) == len(test_labels)

        return train_indexes, train_labels, test_indexes, test_labels
