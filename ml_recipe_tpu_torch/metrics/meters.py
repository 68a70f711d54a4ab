"""Metric meters (a copy of ``ml_recipe_tpu/metrics/meters.py``).

Parity target: reference ``modules/model/trainer/meters.py`` —
``AverageMeter`` running mean (meters.py:10-20), ``APMeter`` wrapping
``sklearn.metrics.average_precision_score`` (meters.py:23-37), ``MAPMeter``
dict-of-APMeters + mean (meters.py:40-56) — plus
``sklearn.metrics.accuracy_score`` used by the callbacks (callback.py:47-51).

sklearn is a Cython dependency (SURVEY.md §2.2); here AP and accuracy are
first-party numpy, matching sklearn's step-interpolated AP definition.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class AverageMeter:
    def __init__(self):
        self._counter = 0
        self._avg_value = 0.0

    def __call__(self) -> float:
        return self._avg_value

    def update(self, value: float, n: int = 1) -> None:
        """Fold in a mean computed over ``n`` samples. ``n=1`` is the
        historical single-sample running mean (bit-identical arithmetic);
        variable ``n`` makes the meter per-SAMPLE-correct when batches have
        unequal sizes (length-bucketed batching, trimmed eval tails)."""
        n = int(n)
        if n <= 0:
            return
        self._counter += n
        self._avg_value = (
            self._avg_value * (self._counter - n) + float(value) * n
        ) / self._counter


def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.size == 0:
        return 0.0
    return float(np.mean(y_true == y_pred))


def average_precision(y_true, y_score) -> float:
    """AP = sum_n (R_n - R_{n-1}) * P_n over the ranked list.

    Matches ``sklearn.metrics.average_precision_score`` for binary labels
    (NaN when no positive labels, mirroring sklearn's undefined case).
    """
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)

    n_pos = int(y_true.sum())
    if n_pos == 0:
        return float("nan")

    # sort by score descending; group ties by unique threshold
    order = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[order]
    y_score = y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs].astype(np.float64)
    fps = (threshold_idxs + 1) - tps

    precision = tps / (tps + fps)
    recall = tps / n_pos

    # prepend (recall=0); AP = sum over thresholds of dRecall * precision
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


class APMeter:
    def __init__(self):
        self.reset()

    def __call__(self) -> float:
        return average_precision(self.true_labels, self.pred_probas)

    def update(self, pred_probas, true_labels) -> None:
        self.pred_probas.extend(np.asarray(pred_probas).tolist())
        self.true_labels.extend(np.asarray(true_labels).tolist())

    def reset(self) -> None:
        self.pred_probas = []
        self.true_labels = []


class MAPMeter:
    def __init__(self):
        self.reset()

    def __call__(self) -> dict:
        metrics = {k: v() for k, v in self.aps_dict.items()}
        metrics["map"] = float(np.mean(list(metrics.values()))) if metrics else float("nan")
        return metrics

    def update(self, keys, pred_probas, true_labels) -> None:
        pred_probas = np.asarray(pred_probas)
        true_labels = np.asarray(true_labels)
        assert len(keys) == pred_probas.shape[-1]

        for i, key in enumerate(keys):
            self.aps_dict[key].update(pred_probas[:, i], true_labels == i)

    def reset(self) -> None:
        self.aps_dict = defaultdict(APMeter)
