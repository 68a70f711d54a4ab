"""First-party Prometheus-text metric primitives, shared by both planes.

No prometheus_client dependency (the container bakes in the jax toolchain,
nothing else): three metric kinds — Counter, Gauge, Histogram — registered
in a Registry that renders the Prometheus text exposition format served at
``GET /metrics``. The Histogram additionally keeps a bounded sample
reservoir so latency quantiles (p50/p95/p99) can be exported as plain
gauges and reported by ``bench.py`` without a PromQL engine.

Grew up in ``serve/metrics.py`` for the serving plane; lifted here so the
training plane (``train/telemetry.py`` + ``metrics/exporter.py``) exports
through the same primitives. ``serve.metrics`` remains as a re-export shim.

Thread-safety: every mutation takes the metric's lock — observations come
from HTTP handler threads, the batcher thread, the engine, the train loop
and the prefetch thread concurrently.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


def _fmt(value: float) -> str:
    """Prometheus sample formatting: integers stay integral, +Inf is the
    literal label Prometheus expects."""
    if value == math.inf:
        return "+Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


class Counter:
    """Monotonically increasing counter."""

    kind = "counter"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name, self.value)]


class Gauge:
    """Set-to-current-value gauge."""

    kind = "gauge"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name, self.value)]


class Info:
    """Prometheus info-style metric: constant ``1`` with identifying labels
    (``name{key="value",...} 1``) — the idiomatic way to expose build/mode
    facts like the serving plane's active precision without a label-aware
    metric model. Labels may be replaced wholesale (``set``); values are
    escaped per the text exposition format."""

    kind = "gauge"

    def __init__(self, name: str, help_: str, labels: Dict[str, str]):
        self.name = name
        self.help = help_
        self._labels = dict(labels)
        self._lock = threading.Lock()

    def set(self, **labels: str) -> None:
        with self._lock:
            self._labels = dict(labels)

    @property
    def labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._labels)

    @staticmethod
    def _escape(value: str) -> str:
        return (str(value).replace("\\", r"\\").replace('"', r"\"")
                .replace("\n", r"\n"))

    def samples(self) -> List[Tuple[str, float]]:
        with self._lock:
            label_str = ",".join(
                f'{k}="{self._escape(v)}"'
                for k, v in sorted(self._labels.items())
            )
        return [(f"{self.name}{{{label_str}}}", 1.0)]


class LabeledGauge:
    """One-label gauge family: ``name{label="key"} value`` per key — the
    per-category badput series (``train_badput_seconds_total{category=...}``)
    without a full label-aware metric model. Keys render sorted; values are
    replaced per key (``set``) or accumulated (``inc``)."""

    kind = "gauge"

    def __init__(self, name: str, help_: str, label: str):
        self.name = name
        self.help = help_
        self.label = label
        self._values: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: float) -> None:
        with self._lock:
            self._values[str(key)] = float(value)

    def inc(self, key: str, amount: float = 1.0) -> None:
        with self._lock:
            self._values[str(key)] = self._values.get(str(key), 0.0) + amount

    def value(self, key: str) -> Optional[float]:
        with self._lock:
            return self._values.get(str(key))

    def values(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def samples(self) -> List[Tuple[str, float]]:
        with self._lock:
            return [
                (f'{self.name}{{{self.label}="{Info._escape(k)}"}}', v)
                for k, v in sorted(self._values.items())
            ]


# default latency buckets: 1 ms .. 30 s (request latency on a serving box)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

_RESERVOIR = 4096  # quantiles come from the most recent observations


class Histogram:
    """Prometheus histogram + bounded reservoir for direct quantiles.

    Renders cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``;
    ``quantile(q)`` interpolates over the (bounded) recent-sample reservoir
    — good enough for /metrics convenience gauges and the bench JSON line,
    while the bucket series stay the scrape-side source of truth.
    """

    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self._bounds = sorted(float(b) for b in buckets)
        self._counts = [0] * (len(self._bounds) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._recent: List[float] = []
        self._recent_i = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._counts[bisect_left(self._bounds, value)] += 1
            self._sum += value
            self._count += 1
            if len(self._recent) < _RESERVOIR:
                self._recent.append(value)
            else:  # ring overwrite: bounded memory, recent-biased quantiles
                self._recent[self._recent_i] = value
                self._recent_i = (self._recent_i + 1) % _RESERVOIR
        return None

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self._sum / self._count if self._count else None

    def quantile(self, q: float) -> Optional[float]:
        """Linear-interpolated quantile over the reservoir (None when no
        observations yet)."""
        with self._lock:
            data = sorted(self._recent)
        if not data:
            return None
        if len(data) == 1:
            return data[0]
        pos = (len(data) - 1) * min(max(q, 0.0), 1.0)
        lo = int(pos)
        frac = pos - lo
        hi = min(lo + 1, len(data) - 1)
        return data[lo] * (1 - frac) + data[hi] * frac

    def samples(self) -> List[Tuple[str, float]]:
        with self._lock:
            out = []
            cum = 0
            for bound, n in zip(self._bounds, self._counts):
                cum += n
                out.append(
                    (f'{self.name}_bucket{{le="{_fmt(bound)}"}}', float(cum))
                )
            cum += self._counts[-1]
            out.append((f'{self.name}_bucket{{le="+Inf"}}', float(cum)))
            out.append((f"{self.name}_sum", self._sum))
            out.append((f"{self.name}_count", float(self._count)))
            return out


class Registry:
    """Named metric collection rendering the text exposition format."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help_: str) -> Counter:
        return self.register(Counter(name, help_))

    def gauge(self, name: str, help_: str) -> Gauge:
        return self.register(Gauge(name, help_))

    def histogram(self, name: str, help_: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, buckets))

    def info(self, name: str, help_: str, labels: Dict[str, str]) -> Info:
        return self.register(Info(name, help_, labels))

    def labeled_gauge(self, name: str, help_: str, label: str) -> LabeledGauge:
        return self.register(LabeledGauge(name, help_, label))

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        """Every registered metric name (the docs-consistency gate in
        tests/test_serve_cache.py walks this against /metrics output and
        the README metrics table, so the Prometheus surface cannot
        silently drift from the docs)."""
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample_name, value in m.samples():
                lines.append(f"{sample_name} {_fmt(value)}")
        return "\n".join(lines) + "\n"
