"""Async overlapped checkpointing: persist on a background thread (the port
of ``ml_recipe_tpu/resilience/checkpoint_async.py``, without its fault
site).

A checkpoint save has two legs with very different costs on the step
critical path: the device -> host SNAPSHOT (one bounded copy of the live
state, which must block training — the next step updates the parameters
and moments in place) and the PERSIST tail (serialize + write + atomic
swap), which scales with state size and touches nothing the training step
needs. The sync path pays both on the critical path; ``--async_checkpoint``
pays only the snapshot and runs the persist here, on a dedicated thread,
in the TorchTitan distributed-checkpoint shape (arxiv 2410.06511):

- at most ONE persist is in flight: :meth:`submit` implicitly waits for
  the previous one (the completion barrier before the next save), so two
  saves can never interleave their writes to one path;
- :meth:`wait` is the explicit completion barrier the trainer arms before
  restores, at exit, and before a SIGTERM resume hands the checkpoint to
  the supervisor — a persist error is re-raised there (wrapped in
  :class:`AsyncCheckpointError`), never swallowed;
- the worker is a NON-daemon thread, so even a caller that forgets the
  exit barrier gets the interpreter's thread-join at shutdown instead of
  a torn tmp file (hard kills are covered by the persist functions'
  atomic rename discipline: the previous valid checkpoint stays newest).

The persist callable itself comes from ``train.checkpoint``
(``persist_state`` / ``persist_state_sharded``) — the background writer
reuses the same per-leaf crc32 and tmp+rename helpers as the sync path,
not a parallel implementation.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class AsyncCheckpointError(RuntimeError):
    """A background checkpoint persist failed. Raised at the NEXT
    completion barrier (the following save, an explicit ``wait``, or
    process exit) with the original exception chained — an async save
    failure must surface where the caller can still act on it, not
    vanish into a thread log."""


class AsyncCheckpointer:
    """Single-flight background persist executor for checkpoint saves."""

    def __init__(self, *, name: str = "async-checkpoint"):
        self.name = name
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._pending_path: Optional[str] = None
        self._error: Optional[tuple] = None  # (path, exception)
        # perf_counter stamp of a wait() currently blocked on the
        # in-flight persist, or None: lets the worker report how much of
        # its persist wall the main thread spent STALLED waiting for it —
        # that share did not overlap training and must not be booked as
        # overlapped time (it is already on the caller's critical path)
        self._wait_started: Optional[float] = None

    def pending(self) -> bool:
        """True while a persist is in flight (its thread is alive)."""
        with self._lock:
            thread = self._thread
        return thread is not None and thread.is_alive()

    def wait(self, *, raise_errors: bool = True) -> None:
        """Block until any in-flight persist lands; re-raise its failure.

        ``raise_errors=False`` (best-effort paths: an exception is
        already propagating, or an emergency save is about to run and
        must not be aborted by a STALE failure) logs the failure at ERROR
        instead. Either way the error is consumed — it has been surfaced
        once, and re-raising it later would abort a save it has nothing
        to do with (e.g. the SIGTERM interrupt checkpoint).
        """
        with self._lock:
            thread = self._thread
            if thread is not None and thread.is_alive():
                self._wait_started = time.perf_counter()
        if thread is not None:
            thread.join()
            with self._lock:
                self._wait_started = None
                if self._thread is thread:
                    self._thread = None
                    self._pending_path = None
        with self._lock:
            error, self._error = self._error, None
        if error is None:
            return
        path, exc = error
        if raise_errors:
            raise AsyncCheckpointError(
                f"background checkpoint persist to {path} failed: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
        logger.error(
            f"Background checkpoint persist to {path} failed: {exc!r} "
            f"(not re-raised: a best-effort barrier consumed it)."
        )

    def submit(
        self,
        path,
        persist_fn: Callable[[], None],
        *,
        on_done: Optional[Callable[[float, float], None]] = None,
    ) -> None:
        """Run ``persist_fn`` on the background thread.

        Waits for the previous persist first (single-flight — the
        caller's snapshot is already taken, so this wait is part of the
        save's blocking time and is what keeps writes to one path
        ordered). ``on_done(persist_s, stalled_s)`` is called from the
        worker thread on success: ``persist_s`` is the persist wall time,
        ``stalled_s`` the share of it the main thread spent blocked in
        :meth:`wait` on THIS persist — the genuinely overlapped time is
        their difference (stalled time is already on the caller's
        critical path and must not be double-booked as overlap).
        """
        self.wait()
        path = str(path)

        def run() -> None:
            t0 = time.perf_counter()
            try:
                persist_fn()
            except BaseException as e:  # noqa: BLE001 - recorded, re-raised at wait()
                with self._lock:
                    self._error = (path, e)
                logger.error(
                    f"ASYNC CHECKPOINT: persist to {path} failed on the "
                    f"background thread: {e!r} (will re-raise at the next "
                    f"completion barrier)."
                )
                return
            if on_done is not None:
                end = time.perf_counter()
                with self._lock:
                    waited = self._wait_started
                stalled = end - waited if waited is not None else 0.0
                try:
                    on_done(end - t0, max(0.0, stalled))
                except Exception as e:  # noqa: BLE001 - telemetry must not fail the save
                    logger.warning(
                        f"ASYNC CHECKPOINT: on_done callback failed: {e!r}"
                    )

        # non-daemon: a forgotten exit barrier degrades to the
        # interpreter's clean thread join, not a torn write. START before
        # publishing: a signal (SIGTERM->KeyboardInterrupt) landing
        # between the two lines must leave a RUNNING untracked persist
        # (joined by the interpreter at exit, writes atomic) rather than
        # a tracked never-started thread whose join() would raise and
        # abort the emergency save.
        thread = threading.Thread(target=run, name=self.name, daemon=False)
        thread.start()
        with self._lock:
            self._thread = thread
            self._pending_path = path
