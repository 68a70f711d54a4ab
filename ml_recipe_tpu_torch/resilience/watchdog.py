"""Step watchdog: turn silent hangs into supervised restarts (the port of
``ml_recipe_tpu/resilience/watchdog.py``, unchanged in behaviour).

A hung collective (one host dropped out of a barrier), a wedged data worker
or a stuck device transfer does not crash — it WAITS, forever, holding the
whole pod. The watchdog arms a deadline around every unit of work that must
make progress (train/eval steps, checkpoint barriers); when a deadline is
missed it dumps every thread's stack plus the last completed step to stderr
and aborts the process with :data:`WATCHDOG_EXIT_CODE`, so the supervisor
sees a classifiable exit (`hang`) and restarts from the last checkpoint
instead of wedging.

Arming is re-entrant (a stack): the trainer arms a step-level frame and the
checkpoint barrier arms its own nested frame on top; only the TOP frame's
deadline is monitored — it is the unit of work actually executing — and
when it pops, the frame below gets a fresh deadline (it just regained
control, so its clock restarts).

The monitor is a daemon thread, and the stack dump tries ``faulthandler``
first (works even when the main thread is stuck inside a C call that holds
the GIL) with a pure-Python fallback for captured/non-fd stderr.
"""

from __future__ import annotations

import faulthandler
import logging
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

# Distinct from any plausible library exit and from faults.KILL_EXIT_CODE:
# the supervisor classifies this as a hang.
WATCHDOG_EXIT_CODE = 87


class _Frame:
    __slots__ = ("label", "timeout", "deadline")

    def __init__(self, label: str, timeout: float):
        self.label = label
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout


def dump_all_stacks(out) -> None:
    """Write every thread's stack to ``out`` (faulthandler when possible —
    it needs a real fd but works under a held GIL; python fallback keeps
    captured-stderr environments like pytest working)."""
    try:
        faulthandler.dump_traceback(file=out, all_threads=True)
        return
    except Exception:  # noqa: BLE001 - no fd / closed file: fall through
        pass
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.write(f"\n--- thread {names.get(tid, '?')} ({tid}) ---\n")
        out.write("".join(traceback.format_stack(frame)))


class Watchdog:
    """Deadline monitor for units of work that must make progress.

    Usage::

        wd = Watchdog(timeout=300)
        with wd.watch("train epoch 1") as tick:
            for step, batch in enumerate(loader):
                tick(f"train step {step}")   # fresh deadline per step
                ...
                wd.note_progress(step)

    ``on_timeout``/``exit_fn`` exist for tests; production uses the
    defaults (dump stacks, ``os._exit(WATCHDOG_EXIT_CODE)``).
    """

    def __init__(
        self,
        timeout: float,
        *,
        exit_code: int = WATCHDOG_EXIT_CODE,
        poll_interval: Optional[float] = None,
        on_timeout: Optional[Callable[[str], None]] = None,
        exit_fn: Optional[Callable[[int], None]] = None,
    ):
        if timeout <= 0:
            raise ValueError(f"watchdog timeout must be positive, got {timeout}")
        self.timeout = float(timeout)
        self.exit_code = exit_code
        self.poll_interval = (
            poll_interval if poll_interval is not None
            else max(0.02, min(1.0, self.timeout / 10.0))
        )
        self.on_timeout = on_timeout
        self._exit = exit_fn if exit_fn is not None else self._default_exit
        self._lock = threading.Lock()
        self._frames: List[_Frame] = []
        self._last_step: Optional[int] = None
        self._last_beat: Optional[float] = None  # monotonic, see heartbeat_age
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._on_beat: Optional[Callable[[Optional[int]], None]] = None
        self._on_beat_interval = 1.0
        self._beat_emitted: Optional[float] = None  # monotonic of last emit

    # -- arming ----------------------------------------------------------------

    def arm(self, label: str, timeout: Optional[float] = None) -> None:
        with self._lock:
            if timeout is None and self._frames:
                # nested frames inherit the ENCLOSING budget by default: a
                # barrier inside a (deliberately generous) checkpoint-save
                # frame must not shrink the deadline back to step size
                timeout = self._frames[-1].timeout
            self._frames.append(_Frame(label, timeout or self.timeout))
            self._last_beat = time.monotonic()
        self._ensure_thread()

    def disarm(self) -> None:
        with self._lock:
            if self._frames:
                self._frames.pop()
            if self._frames:
                # the frame below just regained control: restart its clock
                top = self._frames[-1]
                top.deadline = time.monotonic() + top.timeout

    def tick(self, label: Optional[str] = None) -> None:
        """Fresh deadline for the top frame (call once per unit of work)."""
        with self._lock:
            if not self._frames:
                return
            top = self._frames[-1]
            if label is not None:
                top.label = label
            top.deadline = time.monotonic() + top.timeout
            self._last_beat = time.monotonic()
        self._emit_beat()

    @contextmanager
    def watch(self, label: str, timeout: Optional[float] = None):
        self.arm(label, timeout)
        try:
            yield self.tick
        finally:
            self.disarm()

    def add_on_timeout(self, hook: Callable[[str], None]) -> None:
        """Chain ``hook`` onto the timeout path (runs after any existing
        hook, before the process exit) — how the flight recorder gets its
        dump out on a hang abort. Hook failures are already contained by
        the firing path: the exit must happen regardless."""
        prev = self.on_timeout

        def chained(label: str) -> None:
            if prev is not None:
                try:
                    prev(label)
                except Exception:  # noqa: BLE001 - dying anyway; the next
                    # hook (and the exit) must still run
                    logger.exception("watchdog on_timeout hook failed")
            hook(label)

        self.on_timeout = chained

    def note_progress(self, step: int) -> None:
        with self._lock:
            self._last_step = int(step)
            self._last_beat = time.monotonic()
        self._emit_beat()

    def add_on_beat(
        self, hook: Callable[[Optional[int]], None], *,
        min_interval: float = 1.0,
    ) -> None:
        """Piggyback a liveness hook on the watchdog's OWN heartbeat: each
        ``tick``/``note_progress`` may call ``hook(last_step)``, rate-
        limited to one emit per ``min_interval`` seconds — how the elastic
        child publishes its cross-host heartbeat file at training cadence
        without a second timer thread. The hook runs OUTSIDE the lock (it
        does IO) and its failures are contained: heartbeating degrades,
        training never does."""
        self._on_beat = hook
        self._on_beat_interval = float(min_interval)

    def _emit_beat(self) -> None:
        hook = self._on_beat
        if hook is None:
            return
        now = time.monotonic()
        if (self._beat_emitted is not None
                and now - self._beat_emitted < self._on_beat_interval):
            return
        self._beat_emitted = now
        try:
            hook(self._last_step)
        except Exception:  # noqa: BLE001 - liveness IO must not hurt training
            logger.exception("watchdog on_beat hook failed")

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the last sign of life (arm/tick/note_progress) —
        the /metrics liveness gauge. None before any frame was ever armed
        (nothing is being watched, so there is no heartbeat to age)."""
        with self._lock:
            if self._last_beat is None:
                return None
            return max(0.0, time.monotonic() - self._last_beat)

    def stop(self) -> None:
        """Shut the monitor thread down (tests; production lets the daemon
        thread die with the process)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # -- monitor ---------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, name="step-watchdog", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                if self._fired or not self._frames:
                    continue
                top = self._frames[-1]
                expired = time.monotonic() > top.deadline
                label, timeout, step = top.label, top.timeout, self._last_step
                if expired:
                    self._fired = True
            if expired:
                self._fire(label, timeout, step)
                return

    def _fire(self, label: str, timeout: float, step: Optional[int]) -> None:
        out = sys.stderr
        try:
            out.write(
                f"WATCHDOG: '{label}' exceeded {timeout:g}s "
                f"(last completed step: "
                f"{step if step is not None else 'none'}); "
                f"dumping all thread stacks and aborting.\n"
            )
            dump_all_stacks(out)
            out.flush()
        except Exception:  # noqa: BLE001 - dying anyway; the exit must happen
            pass
        if self.on_timeout is not None:
            try:
                self.on_timeout(label)
            except Exception:  # noqa: BLE001
                pass
        self._exit(self.exit_code)

    @staticmethod
    def _default_exit(code: int) -> None:
        import os

        # os._exit, not sys.exit: the main thread is stuck — possibly inside
        # a C extension — and atexit/finally would never run; the supervisor
        # needs the process GONE so it can restart it.
        os._exit(code)


# -- process-global instance (for call sites without a Trainer handle) ---------

_active: Optional[Watchdog] = None


def install(wd: Optional[Watchdog]) -> Optional[Watchdog]:
    """Install (or clear, with None) the process-global watchdog that
    barrier-level call sites pick up via :func:`current`."""
    global _active
    _active = wd
    return wd


def current() -> Optional[Watchdog]:
    return _active


@contextmanager
def watched(label: str, timeout: Optional[float] = None):
    """Arm the process-global watchdog around a block; no-op when none is
    installed (single-host debug runs stay zero-overhead)."""
    wd = current()
    if wd is None:
        yield lambda *_: None
        return
    with wd.watch(label, timeout) as tick:
        yield tick
