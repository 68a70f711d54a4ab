"""Structured trace spans: first-party Chrome trace-event JSON (the port of
``ml_recipe_tpu/metrics/trace.py``'s ``TraceWriter`` and its process-global
``install`` / ``current`` / ``span``).

A :class:`TraceWriter` collects complete-duration events (``"ph": "X"``) and
writes them in the Chrome trace-event format: load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.
The serving plane emits ``admission`` → ``queue`` → ``flush`` → ``device`` →
``span_reduce`` → ``respond``, keyed by request id in ``args``. Training's
spans (``--trace_spans`` on ``cli.train``) are not ported (ROADMAP.md queue
1, 'Runtime subsystems').

With no tracer installed every hook is a no-op costing one global load and
a None check. Timestamps come from ``time.perf_counter()`` against a
per-writer origin (Chrome ``ts`` values are relative microseconds).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .artifacts import atomic_write_json, wall_now

logger = logging.getLogger(__name__)

# bound memory on long runs: the newest events win
_MAX_EVENTS = 200_000


class TraceWriter:
    """Thread-safe Chrome trace-event collector.

    ``complete(name, t0, t1)`` records a span from explicit
    ``perf_counter`` readings (for call sites that timed the interval
    themselves, e.g. a queue wait reconstructed from an enqueue stamp);
    ``span(name)`` is the context-manager spelling. ``tid`` defaults to the
    calling thread so Perfetto lays concurrent planes out on separate
    tracks.
    """

    def __init__(self, path: str, *, process_name: str = "ml_recipe_tpu_torch"):
        self.path = os.fspath(path)
        self.origin = time.perf_counter()
        # wall-clock anchor of the perf_counter origin, for aligning
        # per-process trace files onto one timeline
        self.origin_unix = wall_now()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._meta = process_name

    def now(self) -> float:
        """Current ``perf_counter`` reading (callers stamp intervals with
        this so explicit ``complete`` calls share the writer's clock)."""
        return time.perf_counter()

    def _us(self, t: float) -> float:
        return (t - self.origin) * 1e6

    def _append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                # drop the OLDEST half once, keeping the recent window
                self._dropped += len(self._events) // 2
                self._events = self._events[len(self._events) // 2:]
            self._events.append(event)

    def complete(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        cat: str = "host",
        tid: Optional[int] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One complete-duration event from two ``perf_counter`` readings."""
        event: Dict[str, Any] = {
            "name": name,
            "ph": "X",
            "ts": self._us(t0),
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": self._pid,
            "tid": tid if tid is not None else threading.get_ident() % (1 << 31),
            "cat": cat,
        }
        if args:
            event["args"] = args
        self._append(event)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "host",
             args: Optional[Dict[str, Any]] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, time.perf_counter(), cat=cat, args=args)

    def flush(self) -> str:
        """Write the collected events as Chrome trace JSON, atomically;
        returns the path. Safe to call repeatedly."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "ml_recipe_tpu_torch.metrics.trace",
                "dropped_events": dropped,
                "process_name": self._meta,
                "origin_unix": self.origin_unix,
            },
        }
        return atomic_write_json(self.path, doc)

    def close(self) -> str:
        path = self.flush()
        logger.info(f"Trace spans written to {path} (load in Perfetto).")
        return path


# -- process-global instance (deep call sites: the engine's batcher thread) ----

_active: Optional[TraceWriter] = None


def install(tracer: Optional[TraceWriter]) -> Optional[TraceWriter]:
    """Install (or clear, with None) the process-global tracer."""
    global _active
    _active = tracer
    return tracer


def current() -> Optional[TraceWriter]:
    return _active


@contextlib.contextmanager
def span(name: str, *, cat: str = "host",
         args: Optional[Dict[str, Any]] = None):
    """Span against the process-global tracer; a no-op when none is
    installed (the default)."""
    tracer = _active
    if tracer is None:
        yield
        return
    with tracer.span(name, cat=cat, args=args):
        yield
