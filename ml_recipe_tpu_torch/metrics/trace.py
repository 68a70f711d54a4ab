"""Structured trace spans: first-party Chrome trace-event JSON (the port of
``ml_recipe_tpu/metrics/trace.py``).

A :class:`TraceWriter` collects complete-duration events (``"ph": "X"``) and
instants (``"ph": "i"``) and writes them in the Chrome trace-event format:
load the file in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
Spans cover the host side of both planes:

- training (``--trace_spans`` on ``cli.train``): ``data_wait`` (loader) →
  ``place`` (collate + micro split + host-to-device) → ``step`` (launch +
  device, CUDA synchronized) → ``checkpoint_save`` / ``ckpt_snapshot`` /
  ``checkpoint_restore``, ``prefetch_stage`` on the prefetch thread, and
  the ``_train`` / ``_test`` units of :func:`time_profiler`;
- serving: ``admission`` → ``queue`` → ``flush`` → ``device`` →
  ``span_reduce`` → ``respond``, keyed by request id in ``args``.

With no tracer installed every hook is a no-op costing one global load and
a None check. Timestamps come from ``time.perf_counter()`` against a
per-writer origin (Chrome ``ts`` values are relative microseconds).

:class:`ProfilerWindow` is the trainer's device capture (``--trace``): a
``torch.profiler`` trace of a window of steps, exported as a Chrome
trace, where the JAX package's ``XplaneWindow`` takes a ``jax.profiler``
xplane dump.
"""

from __future__ import annotations

import contextlib
import functools
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

    def instant(self, name: str, *, cat: str = "host",
                args: Optional[Dict[str, Any]] = None) -> None:
        event: Dict[str, Any] = {
            "name": name,
            "ph": "i",
            "ts": self._us(time.perf_counter()),
            "pid": self._pid,
            "tid": threading.get_ident() % (1 << 31),
            "cat": cat,
            "s": "p",  # process-scoped instant
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

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# -- process-global instance (deep call sites: engine, prefetch worker) --------

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


def complete(name: str, t0: float, t1: float, *, cat: str = "host",
             tid: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None) -> None:
    tracer = _active
    if tracer is not None:
        tracer.complete(name, t0, t1, cat=cat, tid=tid, args=args)


def instant(name: str, *, cat: str = "host",
            args: Optional[Dict[str, Any]] = None) -> None:
    tracer = _active
    if tracer is not None:
        tracer.instant(name, cat=cat, args=args)


# -- wall-time profiling decorator (the utils.profiler surface) ---------------


def time_profiler(fun):
    """Log a function call's wall time AND emit it as a trace span.

    When a tracer is installed, ``_train``/``_test`` and every other
    decorated unit appear as ``cat="profile"`` spans on the same Perfetto
    timeline as the step/checkpoint spans; without one, only the log line
    is emitted.
    """

    @functools.wraps(fun)
    def _profiled_func(*args, **kwargs):
        start = time.perf_counter()
        try:
            return fun(*args, **kwargs)
        finally:
            end = time.perf_counter()
            complete(fun.__name__, start, end, cat="profile")
            logger.info(
                f"Execution of {fun.__name__} took {end - start:.3f} sec."
            )

    return _profiled_func


# -- the trainer's device capture (--trace) -----------------------------------


class ProfilerWindow:
    """``torch.profiler`` capture over a window of steps.

    The window counts the steps it is shown (:meth:`on_step_start`, step 0
    first, across epochs). A capture opens before step ``start`` runs and
    closes once ``steps`` steps have run, or when the epoch ends first
    (:meth:`abort`), so the trace covers exactly those steps. It records
    CPU activity and, on a CUDA ``device``, CUDA activity; it synchronizes
    the device before it stops, so every kernel of the window lands in the
    trace. The trace is exported as Chrome trace JSON into ``log_dir``
    (``profile_p<process>_steps<a>-<b>.json``; Perfetto reads it). When a
    span tracer is installed the same boundaries are marked with
    ``profiler_capture_start``/``profiler_capture_stop`` instants, so host
    spans and the device capture line up.

    On CUDA a capture that holds no CUDA activity is not written (without
    the device the trace would say nothing about where the step's time
    goes): the window logs it, marks a ``profiler_capture_empty`` instant
    and captures the next steps instead, up to ``captures`` captures. When
    every capture taken came back empty it raises: at the last capture, or
    in :meth:`finish` when the run ended before the captures ran out.
    """

    def __init__(self, log_dir, *, start: int = 2, steps: int = 3,
                 device="cpu", process_index: int = 0, captures: int = 3):
        import torch
        from torch.profiler import ProfilerActivity, supported_activities

        self.log_dir = str(log_dir)
        self.start = int(start)
        self.steps = max(1, int(steps))
        self.captures = max(1, int(captures))
        self.device = torch.device(device)
        self.process_index = int(process_index)
        self.activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError(
                    "--trace on CUDA: this torch build's profiler cannot "
                    "capture CUDA activity (no CUPTI); refusing to write a "
                    "CPU-only trace")
            self.activities.append(ProfilerActivity.CUDA)
        self.path: Optional[str] = None
        self.device_events = 0
        self.empty_captures = 0
        self._step = -1                   # the step being run
        self._first: Optional[int] = None  # the open capture's first step
        self._prof = None

    @property
    def done(self) -> bool:
        return self.path is not None

    def on_step_start(self) -> None:
        self._step += 1
        if (self._prof is None and not self.done
                and self._step >= self.start):
            from torch.profiler import profile

            self._prof = profile(activities=self.activities)
            self._prof.start()
            self._first = self._step
            instant("profiler_capture_start", cat="train",
                    args={"step": self._step, "dir": self.log_dir})

    def on_step_end(self) -> bool:
        """Close the capture once its last step has run; returns True when
        it was written here."""
        if self._prof is None or self._step < self._first + self.steps - 1:
            return False
        return self._stop()

    def abort(self) -> None:
        """Close a still-open capture (the epoch ended mid-capture)."""
        if self._prof is not None:
            self._stop()

    def finish(self) -> None:
        """The run's end: close an open capture, and raise when every
        capture taken on CUDA came back empty."""
        self.abort()
        if not self.done and self.empty_captures:
            raise RuntimeError(
                f"--trace: {self.empty_captures} torch.profiler capture(s) "
                f"held no CUDA activity and the run ended; refusing to "
                f"write a CPU-only trace")

    def _stop(self) -> bool:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        steps = f"{self._first}-{self._step}"
        if self.device.type == "cuda":
            self.device_events = sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            if not self.device_events:
                self.empty_captures += 1
                instant("profiler_capture_empty", cat="train",
                        args={"steps": steps})
                if self.empty_captures >= self.captures:
                    raise RuntimeError(
                        f"--trace: {self.captures} torch.profiler captures "
                        f"(the last of steps {steps}) held no CUDA "
                        f"activity; refusing to write a CPU-only trace")
                logger.warning(
                    f"--trace: the capture of steps {steps} held no CUDA "
                    f"activity (capture {self.empty_captures} of "
                    f"{self.captures}); capturing the next steps instead.")
                return False
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(
            self.log_dir, f"profile_p{self.process_index}_steps{steps}.json")
        prof.export_chrome_trace(path)
        self.path = path
        instant("profiler_capture_stop", cat="train",
                args={"dir": self.log_dir, "path": path})
        logger.info(f"Device trace (steps {steps}) written to {path}.")
        return True
