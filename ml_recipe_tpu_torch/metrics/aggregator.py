"""Pod-scope metrics aggregation (the port of
``ml_recipe_tpu/metrics/aggregator.py``): every exporter in one scrape.

The fleet router serves ``GET /metrics/fleet`` through a
:class:`PodAggregator` over its engines' ``/metrics`` pages, and the fleet
manager reads one engine's counters with :func:`parse_prometheus_text`.
The aggregator polls every target at render time and emits ONE merged
Prometheus text page with three views:

- **pod aggregates** — for every unlabeled counter/gauge a
  ``<name>_pod{agg="sum"|"min"|"max"}`` series, and for every histogram
  the bucket/sum/count series summed across targets (``<name>_pod_*``);
- **derived pod gauges** — ``pod_slowest_host_step_seconds`` and
  ``pod_step_time_skew_seconds`` where the targets export training step
  times, plus reachability (``pod_hosts`` / ``pod_hosts_unreachable``);
- **per-host series** — every original sample re-emitted with a
  ``host="..."`` label.

A dead target degrades to an ``unreachable`` count: the page must render
while a target is down, because that is when someone is looking at it.
"""

from __future__ import annotations

import logging
import re
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# one Prometheus sample line: name, optional {labels}, value
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$"
)

# the per-host mean-step source series for the derived pod gauges
_STEP_SUM = "train_step_seconds_sum"
_STEP_COUNT = "train_step_seconds_count"


def parse_prometheus_text(text: str) -> Tuple[Dict[str, str], List[Tuple[str, str, float]]]:
    """``(types, samples)``: metric kinds from ``# TYPE`` lines and every
    sample as ``(name, raw_label_block_or_'', value)``. Unparseable lines
    are skipped (a merged page must not die on one odd exporter)."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, str, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) == 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, raw = m.group(1), m.group(2) or "", m.group(3)
        try:
            value = float(raw)
        except ValueError:
            continue
        samples.append((name, labels, value))
    return types, samples


def _with_host(labels: str, host: str) -> str:
    host_label = f'host="{host}"'
    if not labels:
        return "{" + host_label + "}"
    return "{" + host_label + "," + labels[1:-1] + "}" if len(labels) > 2 \
        else "{" + host_label + "}"


class PodAggregator:
    """Fan-in scraper over a fixed set of ``host:port`` exporter targets."""

    def __init__(
        self,
        targets: Sequence[str],
        *,
        fetch: Optional[Callable[[str], str]] = None,
        timeout: float = 2.0,
    ):
        self.targets = [t.strip() for t in targets if t.strip()]
        self.timeout = float(timeout)
        self._fetch = fetch if fetch is not None else self._http_fetch

    def _http_fetch(self, target: str) -> str:
        with urllib.request.urlopen(
            f"http://{target}/metrics", timeout=self.timeout
        ) as resp:
            return resp.read().decode("utf-8", errors="replace")

    def scrape(self) -> Tuple[List[Tuple[str, Dict[str, str], List[Tuple[str, str, float]]]], List[str]]:
        """Poll every target CONCURRENTLY; ``(pages, unreachable_targets)``
        where each page is ``(target, types, samples)``. Concurrency is the
        availability property: render cost is one timeout, not
        N×timeout — a half-dead pod must not push the pod page itself past
        the scraper's deadline."""
        import concurrent.futures

        pages = []
        unreachable: List[str] = []
        if not self.targets:
            return pages, unreachable
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(16, len(self.targets)),
            thread_name_prefix="pod-scrape",
        ) as pool:
            fetched = pool.map(self._fetch_one, self.targets)
        for target, text in zip(self.targets, fetched):
            if text is None:
                unreachable.append(target)
                continue
            pages.append((target, *parse_prometheus_text(text)))
        return pages, unreachable

    def _fetch_one(self, target: str) -> Optional[str]:
        try:
            return self._fetch(target)
        except Exception as e:  # noqa: BLE001 - a dead host must degrade
            # to a count on the pod page, not kill the scrape
            logger.warning(f"pod aggregation: {target} unreachable: {e}")
            return None

    def render(self) -> str:
        pages, unreachable = self.scrape()
        lines: List[str] = []

        def emit(name: str, kind: str, help_: str,
                 series: List[Tuple[str, float]]) -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for sample_name, value in series:
                if float(value).is_integer():
                    lines.append(f"{sample_name} {int(value)}")
                else:
                    lines.append(f"{sample_name} {value!r}")

        emit("pod_hosts", "gauge", "Host exporters merged into this page.",
             [("pod_hosts", float(len(pages)))])
        emit("pod_hosts_unreachable", "gauge",
             "Configured host exporters that did not answer the scrape.",
             [("pod_hosts_unreachable", float(len(unreachable)))])

        # derived straggler gauges from each host's mean step time
        means: Dict[str, float] = {}
        for target, _, samples in pages:
            scalars = {n: v for n, labels, v in samples if not labels}
            count = scalars.get(_STEP_COUNT, 0.0)
            if count > 0:
                means[target] = scalars.get(_STEP_SUM, 0.0) / count
        if means:
            slowest = max(means.values())
            emit("pod_slowest_host_step_seconds", "gauge",
                 "Slowest host's mean step wall time (the straggler).",
                 [("pod_slowest_host_step_seconds", slowest)])
            emit("pod_step_time_skew_seconds", "gauge",
                 "Slowest minus fastest host mean step time.",
                 [("pod_step_time_skew_seconds", slowest - min(means.values()))])

        # pod aggregates: unlabeled scalars -> sum/min/max; histograms ->
        # bucket-wise sums
        scalar_values: Dict[str, List[float]] = {}
        hist_series: Dict[str, Dict[str, float]] = {}
        for _, types, samples in pages:
            hist_bases = {n for n, k in types.items() if k == "histogram"}
            for name, labels, value in samples:
                base = None
                for suffix in ("_bucket", "_sum", "_count"):
                    if name.endswith(suffix) and name[: -len(suffix)] in hist_bases:
                        base = name[: -len(suffix)]
                        break
                if base is not None:
                    hist_series.setdefault(base, {})
                    key = name[len(base):] + labels
                    hist_series[base][key] = (
                        hist_series[base].get(key, 0.0) + value
                    )
                elif not labels:
                    scalar_values.setdefault(name, []).append(value)
        for name in sorted(scalar_values):
            vals = scalar_values[name]
            emit(
                f"{name}_pod", "gauge",
                f"Pod aggregate of {name} across host exporters.",
                [
                    (f'{name}_pod{{agg="sum"}}', sum(vals)),
                    (f'{name}_pod{{agg="min"}}', min(vals)),
                    (f'{name}_pod{{agg="max"}}', max(vals)),
                ],
            )
        for base in sorted(hist_series):
            emit(
                f"{base}_pod", "histogram",
                f"Pod-wide {base} (bucket-wise sum across hosts).",
                [
                    (f"{base}_pod{key}", value)
                    for key, value in sorted(hist_series[base].items())
                ],
            )

        # per-host view: every original sample with a host label injected
        lines.append("# HELP pod_host_series every host sample, host-labeled")
        for target, _, samples in pages:
            for name, labels, value in samples:
                sample_name = f"{name}{_with_host(labels, target)}"
                if float(value).is_integer():
                    lines.append(f"{sample_name} {int(value)}")
                else:
                    lines.append(f"{sample_name} {value!r}")
        return "\n".join(lines) + "\n"
