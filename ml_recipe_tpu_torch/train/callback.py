"""Test-time callbacks (a copy of ``ml_recipe_tpu/train/callback.py``).

Parity target: reference ``trainer/callback.py:12-108`` — a ``TestCallback``
base with ``at_iteration_end``/``at_epoch_end`` hooks, accuracy and mAP
aggregation, and best-checkpoint saving.

Deltas:
- predictions arrive as host numpy dicts (the trainer gathers device output
  once per eval step);
- ``SaveBestCallback`` compares with a real comparison instead of the
  reference's ``eval(f'{a}{order}{b}')`` string hack (callback.py:98).
"""

from __future__ import annotations

import logging
import math

import numpy as np

from ..metrics.meters import AverageMeter, MAPMeter, accuracy_score

logger = logging.getLogger(__name__)


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


class TestCallback:
    """Hook base (reference callback.py:12-27)."""

    def at_iteration_end(self, preds, labels, avg_meters):
        self._at_iteration_end(preds, labels, avg_meters)

    def _at_iteration_end(self, *args):
        raise NotImplementedError

    def at_epoch_end(self, avg_meters, trainer):
        self._at_epoch_end(avg_meters, trainer)
        self._reset()

    def _at_epoch_end(self, *args):
        raise NotImplementedError

    def _reset(self):
        pass


class AccuracyCallback(TestCallback):
    """Start/end/cls accuracy with -1 masking (reference callback.py:30-53)."""

    keys = ["start_class", "end_class", "cls"]

    def _at_iteration_end(self, preds, labels, avg_meters):
        start_logits, end_logits, cls_logits = (np.asarray(preds[k]) for k in self.keys)
        start_true, end_true, cls_true = (np.asarray(labels[k]) for k in self.keys)

        start_pred = start_logits.argmax(axis=-1)
        end_pred = end_logits.argmax(axis=-1)
        cls_pred = cls_logits.argmax(axis=-1)

        start_idxs = start_true != -1
        end_idxs = end_true != -1

        # weight each batch-mean by its row count: eval batches are NOT
        # equal-sized (bucketed batches vary by bucket, the trimmed final
        # batch is short), and an unweighted mean-of-means would bias the
        # epoch accuracy toward whichever bucket had more batches
        if start_idxs.any():
            avg_meters["s_acc"].update(
                accuracy_score(start_true[start_idxs], start_pred[start_idxs]),
                int(start_idxs.sum()),
            )
        if end_idxs.any():
            avg_meters["e_acc"].update(
                accuracy_score(end_true[end_idxs], end_pred[end_idxs]),
                int(end_idxs.sum()),
            )
        avg_meters["c_acc"].update(
            accuracy_score(cls_true, cls_pred), int(cls_true.shape[0])
        )

    def _at_epoch_end(self, *args):
        pass


class MAPCallback(TestCallback):
    """Per-class AP -> mAP over cls logits (reference callback.py:56-76)."""

    key = "cls"

    def __init__(self, metric_keys):
        self._metric_keys = list(metric_keys)
        self._reset()

    def _at_iteration_end(self, preds, labels, *args):
        cls_logits = np.asarray(preds[self.key])
        cls_true = np.asarray(labels[self.key])
        self.map_meter.update(
            keys=self._metric_keys,
            pred_probas=_softmax(cls_logits, axis=-1),
            true_labels=cls_true,
        )

    def _at_epoch_end(self, avg_meters, *args):
        avg_meters.update(self.map_meter())

    def _reset(self):
        self.map_meter = MAPMeter()


class SaveBestCallback(TestCallback):
    """Metric-compare-and-save ``best.ch`` (reference callback.py:79-108)."""

    def __init__(self, params):
        self.params = params
        self.metric = params.best_metric
        self.best_order = params.best_order
        self.value = 1e10 * (-1 if self.best_order == ">" else 1)

    def _at_iteration_end(self, *args):
        pass

    def _at_epoch_end(self, avg_meters, trainer):
        metrics = {
            k: v() if isinstance(v, AverageMeter) else v for k, v in avg_meters.items()
        }

        if self.metric not in metrics:
            logger.warning(f"Trainer metrics do not contain metric {self.metric}.")
            return
        value = metrics[self.metric]
        if isinstance(value, float) and math.isnan(value):
            return

        better = value > self.value if self.best_order == ">" else value < self.value
        if better:
            self.value = value
            trainer.save_state_dict(
                self.params.dump_dir / self.params.experiment_name / "best.ch"
            )
            logger.info(
                f"New best {self.metric}={self.value:.3f} at global step "
                f"{trainer.global_step}; wrote best.ch"
            )
        else:
            logger.info(
                f"{self.metric}={value:.3f} did not beat the current best "
                f"{self.value:.3f}; best.ch unchanged"
            )
