"""Crash flight recorder: the last N structured events, durably (the port
of ``ml_recipe_tpu/metrics/flightrec.py``).

A crash leaves a stack dump; what an operator actually needs is the
TIMELINE that led into it — the last K steps' breakdown, the anomaly
verdicts, the checkpoint events, the watchdog heartbeat ages. The
:class:`FlightRecorder` keeps a bounded ring of structured events fed by
the telemetry plane and dumps it atomically (``metrics.artifacts``) to a
timestamped JSON file in the experiment directory:

- periodically (every ``flush_every`` records), so even an un-catchable
  ``os._exit`` — an injected drill kill, an OOM kill, a preemption — leaves
  the last flushed window on disk;
- terminally, with the reason recorded, on watchdog timeout, SIGTERM,
  unhandled exception, and clean run end.

The supervisor's exit classifier reads the newest dump back
(:func:`newest_flight_record` / :func:`timeline_lines`) so a crash-loop
diagnosis carries the last-K-step timeline instead of just an exit code.
Stdlib-only on purpose: the supervisor imports it without paying for torch.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
import time
from collections import deque
from datetime import datetime, timezone
from typing import List, Optional, Tuple

from .artifacts import atomic_write_json, wall_now as _wall_now

logger = logging.getLogger(__name__)

FLIGHTREC_PREFIX = "flightrec"


class FlightRecorder:
    """Bounded ring of structured events with atomic dumps."""

    def __init__(self, path, *, capacity: int = 256, flush_every: int = 32,
                 process_index: int = 0):
        self.path = os.fspath(path)
        self.capacity = max(8, int(capacity))
        self.flush_every = max(1, int(flush_every))
        self.process_index = int(process_index)
        self._events: deque = deque(maxlen=self.capacity)
        self._since_flush = 0
        self._last_mono: Optional[float] = None
        self._lock = threading.Lock()

    @classmethod
    def open_in(cls, directory, *, process_index: int = 0,
                capacity: int = 256, flush_every: int = 32,
                ) -> "FlightRecorder":
        """Recorder on a per-attempt timestamped file in ``directory`` —
        successive supervised attempts each leave their own dump, and
        :func:`newest_flight_record` finds the latest."""
        stamp = datetime.now(timezone.utc).strftime("%Y%m%d-%H%M%S-%f")
        return cls(
            os.path.join(
                os.fspath(directory),
                f"{FLIGHTREC_PREFIX}_p{process_index}_{stamp}.json",
            ),
            capacity=capacity, flush_every=flush_every,
            process_index=process_index,
        )

    # -- recording -------------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one event; every ``flush_every`` records the ring is
        persisted, so a hard kill can lose at most one flush window."""
        event = {"t": _wall_now(), "kind": str(kind)}
        event.update(fields)
        with self._lock:
            self._events.append(event)
            self._last_mono = time.monotonic()
            self._since_flush += 1
            due = self._since_flush >= self.flush_every
            if due:
                self._since_flush = 0
        if due:
            self.dump("periodic")

    def last_event_age(self) -> Optional[float]:
        """Seconds since the last recorded event (the /healthz staleness
        probe); None before any event."""
        with self._lock:
            if self._last_mono is None:
                return None
            return max(0.0, time.monotonic() - self._last_mono)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- dumping ---------------------------------------------------------------

    def dump(self, reason: str, **extra) -> Optional[str]:
        """Atomically persist the ring with the dump reason; returns the
        path (None when the write failed — a recorder must never take the
        process down on the way to recording why it went down)."""
        with self._lock:
            events = list(self._events)
        doc = {
            "reason": str(reason),
            "dumped_at": _wall_now(),
            "process_index": self.process_index,
            "pid": os.getpid(),
            "events": events,
        }
        if extra:
            doc.update(extra)
        try:
            return atomic_write_json(self.path, doc, indent=1)
        except OSError as e:
            logger.warning(
                f"FLIGHTREC: could not dump to {self.path}: {e}"
            )
            return None


# -- read-back (supervisor exit classifier, tests) ------------------------------


def newest_flight_record(directory) -> Optional[Tuple[str, dict]]:
    """``(path, document)`` of the newest parseable flight-record dump in
    ``directory`` (by ``dumped_at``), or None. Torn/corrupt files are
    skipped — read-back degrades, never crashes the supervisor."""
    import json

    best: Optional[Tuple[str, dict]] = None
    pattern = os.path.join(os.fspath(directory), f"{FLIGHTREC_PREFIX}*.json")
    for path in glob.glob(pattern):
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "events" not in doc:
            continue
        stamp = doc.get("dumped_at", 0.0)
        if best is None or stamp > best[1].get("dumped_at", 0.0):
            best = (path, doc)
    return best


def timeline_lines(doc: dict, *, last: int = 8) -> List[str]:
    """The dump's last-K events as compact human lines (crash-loop
    diagnosis body)."""
    lines: List[str] = []
    events = doc.get("events", [])
    for e in events[-max(1, int(last)):]:
        fields = ", ".join(
            f"{k}={v}" for k, v in e.items() if k not in ("t", "kind")
        )
        stamp = e.get("t")
        when = (
            datetime.fromtimestamp(stamp, timezone.utc).strftime("%H:%M:%S")
            if isinstance(stamp, (int, float)) else "?"
        )
        lines.append(f"  [{when}] {e.get('kind', '?')}: {fields or '-'}")
    return lines
