"""Slow-step anomaly detection: rolling median + MAD over step times (the
port of ``ml_recipe_tpu/metrics/anomaly.py``).

At pod scale an unattributed step-time regression on one host — a stalled
loader, a preemption neighbor stealing host CPU, thermal throttle — is
invisible in epoch means until the run is wasted, and far below the
watchdog's hang threshold. The detector keeps a rolling window of
steady-state step totals; a step exceeding ``factor ×`` the rolling median
(with a median-absolute-deviation guard so benign jitter around a tiny
median never fires) emits ONE structured WARNING carrying the breakdown
attribution — which component (data wait / host / device) moved — and
increments a counter on the /metrics surface.

Anomalous steps still enter the window: a persistent regression re-baselines
after ~window/2 steps, so the detector flags the onset loudly instead of
warning forever about the new normal.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def _median(values) -> float:
    data = sorted(values)
    n = len(data)
    mid = n // 2
    if n % 2:
        return float(data[mid])
    return float(data[mid - 1] + data[mid]) / 2.0


@dataclasses.dataclass
class AnomalyReport:
    """One detected slow step, with its attribution."""

    step: int
    total_s: float
    median_s: float
    mad_s: float
    threshold_s: float
    # component that grew most over its own rolling median, e.g. 'data_wait'
    attribution: str
    component_s: float
    component_median_s: float
    breakdown: Dict[str, float]

    def message(self) -> str:
        parts = ", ".join(
            f"{k}={1e3 * v:.1f}ms" for k, v in self.breakdown.items()
        )
        return (
            f"SLOW STEP {self.step}: {1e3 * self.total_s:.1f}ms vs rolling "
            f"median {1e3 * self.median_s:.1f}ms (threshold "
            f"{1e3 * self.threshold_s:.1f}ms); attribution: "
            f"{self.attribution} {1e3 * self.component_s:.1f}ms vs its "
            f"median {1e3 * self.component_median_s:.1f}ms ({parts})."
        )


class SlowStepDetector:
    """Rolling median + MAD detector over per-step wall times.

    ``factor`` is the headline knob (a step slower than ``factor × median``
    is anomalous); the MAD guard additionally requires the step to sit
    ``mad_gate`` scaled-MADs above the median, which keeps a near-zero
    median (fast CPU smoke runs) from flagging microsecond jitter. The
    first ``warmup`` steps (compilation) and windows smaller than
    ``min_steps`` never fire.
    """

    def __init__(
        self,
        *,
        factor: float = 3.0,
        window: int = 64,
        warmup: int = 1,
        min_steps: int = 8,
        mad_gate: float = 4.0,
    ):
        if factor <= 1.0:
            raise ValueError(f"anomaly factor must be > 1, got {factor}")
        self.factor = float(factor)
        self.warmup = max(0, int(warmup))
        self.min_steps = max(2, int(min_steps))
        self.mad_gate = float(mad_gate)
        self._totals: deque = deque(maxlen=max(self.min_steps, int(window)))
        self._components: Dict[str, deque] = {}
        self._seen = 0
        self.anomalies = 0

    def update(
        self,
        step: int,
        total_s: float,
        breakdown: Optional[Dict[str, float]] = None,
    ) -> Optional[AnomalyReport]:
        """Feed one completed step; returns a report when it is anomalous
        (the caller logs/counts it)."""
        breakdown = breakdown or {}
        self._seen += 1
        if self._seen <= self.warmup:
            return None

        report = None
        if len(self._totals) >= self.min_steps:
            med = _median(self._totals)
            mad = _median(abs(t - med) for t in self._totals)
            # 1.4826 rescales MAD to a std-dev-comparable unit under
            # normality; the max() keeps both guards in force
            threshold = max(
                self.factor * med, med + self.mad_gate * 1.4826 * mad
            )
            if total_s > threshold and total_s > 0:
                attribution, comp_v, comp_med = self._attribute(breakdown)
                report = AnomalyReport(
                    step=int(step),
                    total_s=float(total_s),
                    median_s=med,
                    mad_s=mad,
                    threshold_s=threshold,
                    attribution=attribution,
                    component_s=comp_v,
                    component_median_s=comp_med,
                    breakdown={k: float(v) for k, v in breakdown.items()},
                )
                self.anomalies += 1

        self._totals.append(float(total_s))
        for name, value in breakdown.items():
            dq = self._components.get(name)
            if dq is None:
                dq = self._components[name] = deque(
                    maxlen=self._totals.maxlen
                )
            dq.append(float(value))
        return report

    def _attribute(self, breakdown: Dict[str, float]):
        """Component whose absolute growth over its own rolling median is
        largest — the thing to go look at first."""
        best = ("total", 0.0, 0.0)
        best_delta = float("-inf")
        for name, value in breakdown.items():
            history = self._components.get(name)
            med = _median(history) if history else 0.0
            delta = float(value) - med
            if delta > best_delta:
                best_delta = delta
                best = (name, float(value), med)
        return best
