"""Continuous micro-batching queue with deadline coalescing + backpressure.

The serving engine scatters each request into per-chunk work items; this
batcher coalesces concurrent items that share a bucket seq into the largest
eligible ``(batch, seq)`` bucket:

- a bucket FIRES EARLY the moment its largest batch is full (no reason to
  hold a full program back);
- otherwise it fires when the OLDEST queued item has waited
  ``max_batch_delay_ms`` (the deadline trades a bounded latency floor for
  occupancy — concurrent requests arriving within the window share one
  program launch);
- the queue is BOUNDED: admission past ``queue_size`` raises
  :class:`QueueFullError` immediately (explicit reject-on-full backpressure
  — the HTTP layer turns it into 429 — instead of unbounded growth and
  collapse-under-overload);
- admission is all-or-nothing per request (``submit_many``): a request's
  chunks either all enter the queue or none do, so a rejected request never
  leaves orphan chunks behind.

Draining (SIGTERM): new admissions raise :class:`DrainingError`; everything
already admitted is flushed through normal batch launches (deadlines are
ignored — flush at full speed) and ``drain()`` returns when the queue is
empty and the last in-flight batch has completed.

One worker thread launches batches; the device work itself runs in that
thread (the engine's ``run_fn``), so batches are serialized — matching one
accelerator — while HTTP handler threads only block on their own request's
completion event.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

from .bucketing import BucketGrid

logger = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded work queue is full (backpressure)."""


class DrainingError(RuntimeError):
    """Admission rejected: the batcher is draining for shutdown."""


@dataclass
class ChunkWork:
    """One chunk-sized unit of work, opaque to the batcher beyond its
    bucket seq."""

    seq: int
    payload: Any
    enqueued_at: float = field(default=0.0)


class MicroBatcher:
    def __init__(
        self,
        grid: BucketGrid,
        run_fn: Callable[[int, Sequence[ChunkWork]], None],
        *,
        max_batch_delay_ms: float = 10.0,
        queue_size: int = 256,
        fail_fn: Optional[Callable[[Sequence[ChunkWork], BaseException], None]] = None,
        on_depth: Optional[Callable[[int], None]] = None,
        flush_cost_fn: Optional[Callable[[int, int], Optional[float]]] = None,
    ):
        self.grid = grid
        self._run_fn = run_fn
        self._fail_fn = fail_fn
        self._on_depth = on_depth
        # measured flush ranking: when several seqs are deadline-expired at
        # once, ``flush_cost_fn(seq, n_items)`` returns the measured step
        # cost of the program that would launch (the engine backs it with
        # the tuning cache, ops/autotune.py) and the CHEAPEST flushes first,
        # so small fast programs stop queueing behind expensive ones. None
        # (or no hook) -> the historical order (see ``_rank_flush``). Under
        # sustained cheap-bucket saturation the cheap queue re-expires every
        # loop iteration, so cost ranking alone would starve an expensive
        # bucket: once any eligible seq's oldest item has waited
        # ``_starve_after_s``, fairness overrides cost and the oldest
        # flushes next.
        self._flush_cost_fn = flush_cost_fn
        self.max_batch_delay_s = max(0.0, float(max_batch_delay_ms)) / 1e3
        self.queue_size = int(queue_size)
        # starvation bound for cost-ranked flushing: several deadlines of
        # grace for the ranking to earn its occupancy, floored so a 0 ms
        # deadline does not degenerate to pure oldest-first
        self._starve_after_s = max(8.0 * self.max_batch_delay_s, 0.05)

        self._pending: Dict[int, deque] = {}
        # long-request scatter groups: pre-sliced batches that
        # launch AS-IS, immediately — one request's chunks co-scheduled
        # chunk-parallel instead of interleaving with the coalescing queue.
        # Each entry is one ``(seq, works)`` batch; items count against the
        # same bounded queue.
        self._groups: deque = deque()
        self._n_pending = 0
        self._inflight = False
        self._draining = False
        self._stopped = False
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    # -- admission -------------------------------------------------------------

    def submit_many(self, works: Sequence[ChunkWork]) -> None:
        """Admit all of ``works`` or none of them."""
        if not works:
            return
        now = time.monotonic()
        with self._cv:
            if self._draining or self._stopped:
                raise DrainingError("batcher is draining; not accepting work")
            if self._n_pending + len(works) > self.queue_size:
                raise QueueFullError(
                    f"work queue full ({self._n_pending}/{self.queue_size} "
                    f"queued, request needs {len(works)} slots)"
                )
            for w in works:
                w.enqueued_at = now
                self._pending.setdefault(w.seq, deque()).append(w)
            self._n_pending += len(works)
            depth = self._n_pending
            self._cv.notify_all()
        if self._on_depth is not None:
            self._on_depth(depth)

    def submit_group(self, slices: Sequence[Sequence[ChunkWork]]) -> None:
        """Admit a long request's pre-sliced scatter batches, all or
        nothing. Every inner slice launches as ONE dedicated batch, ahead
        of the coalescing queue and with no deadline wait — the request is
        already complete, so holding its chunks back buys nothing. The
        engine slices via ``BucketGrid.scatter_plan``; slices share the
        bounded queue's capacity with ordinary chunk admissions."""
        slices = [list(s) for s in slices if s]
        total = sum(len(s) for s in slices)
        if not total:
            return
        now = time.monotonic()
        with self._cv:
            if self._draining or self._stopped:
                raise DrainingError("batcher is draining; not accepting work")
            if self._n_pending + total > self.queue_size:
                raise QueueFullError(
                    f"work queue full ({self._n_pending}/{self.queue_size} "
                    f"queued, request needs {total} slots)"
                )
            for works in slices:
                for w in works:
                    w.enqueued_at = now
                self._groups.append((works[0].seq, works))
            self._n_pending += total
            depth = self._n_pending
            self._cv.notify_all()
        if self._on_depth is not None:
            self._on_depth(depth)

    @property
    def depth(self) -> int:
        with self._cv:
            return self._n_pending

    def precheck(self, *, check_full: bool = True) -> None:
        """Cheap fast-fail BEFORE the caller pays host-side tokenization:
        raises :class:`DrainingError`/:class:`QueueFullError` when no
        request could possibly be admitted right now (draining, or the
        queue has zero free slots). NOT authoritative — ``submit_many``
        re-checks all-or-nothing under the lock; this only keeps a
        saturated server from burning CPU chunking documents it is about
        to 429 anyway. ``check_full=False`` skips the queue-full arm: with
        the chunk-result cache enabled a request may need ZERO queue slots
        (fully hot), so "queue full" no longer implies "will 429"."""
        with self._cv:
            if self._draining or self._stopped:
                raise DrainingError("batcher is draining; not accepting work")
            if check_full and self._n_pending >= self.queue_size:
                raise QueueFullError(
                    f"work queue full ({self._n_pending}/{self.queue_size} "
                    f"queued)"
                )

    # -- worker ----------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._thread.start()

    def _full_seq(self) -> Optional[int]:
        """A seq whose pending work already fills its largest bucket."""
        for seq, q in self._pending.items():
            if q and len(q) >= self.grid.max_batch_for(seq):
                return seq
        return None

    def _oldest_seq(self) -> Optional[int]:
        oldest, pick = None, None
        for seq, q in self._pending.items():
            if q and (oldest is None or q[0].enqueued_at < oldest):
                oldest, pick = q[0].enqueued_at, seq
        return pick

    def _eligible_seqs(self) -> list:
        """Seqs allowed to flush right now: all non-empty while draining,
        otherwise those whose oldest item has aged past the deadline."""
        if self._draining:
            return [s for s, q in self._pending.items() if q]
        now = time.monotonic()
        return [
            s for s, q in self._pending.items()
            if q and now - q[0].enqueued_at >= self.max_batch_delay_s
        ]

    def _rank_flush(self, eligible: list) -> int:
        """Which deadline-expired seq flushes first.

        With a ``flush_cost_fn``: cheapest measured step cost first, seqs
        without a cost after the measured ones in ascending-seq order (the
        documented fallback), UNLESS some eligible item has already waited
        past the starvation bound, in which case the oldest flushes (cost
        ranking trades latency ORDER, never bounded service). Without the
        hook, or when NO eligible seq has a cost (nothing measured must not
        reorder flushes): the historical oldest-item-first order.
        """
        oldest = min(eligible, key=lambda s: self._pending[s][0].enqueued_at)
        if self._flush_cost_fn is None:
            return oldest
        waited = time.monotonic() - self._pending[oldest][0].enqueued_at
        if waited >= self._starve_after_s:
            return oldest

        def key(s: int):
            n = min(len(self._pending[s]), self.grid.max_batch_for(s))
            est = self._flush_cost_fn(s, n)
            if est is None:
                return (1, float(s), s)
            return (0, float(est), s)

        keys = {s: key(s) for s in eligible}
        if all(k[0] == 1 for k in keys.values()):
            return oldest
        return min(eligible, key=keys.__getitem__)

    def _take_locked(self) -> Optional[tuple]:
        """Pop the next batch to launch, or None to keep waiting."""
        if self._groups:
            # scatter slices are ready-by-construction batches: launch them
            # before coalescing-queue work so a long request's chunks run
            # back-to-back (its latency is len(plan) device steps, period)
            seq, works = self._groups.popleft()
            self._n_pending -= len(works)
            return seq, works
        seq = self._full_seq()
        if seq is None:
            eligible = self._eligible_seqs()
            if not eligible:
                return None  # deadline not reached, nothing full
            seq = self._rank_flush(eligible)
        q = self._pending[seq]
        take = min(len(q), self.grid.max_batch_for(seq))
        works = [q.popleft() for _ in range(take)]
        self._n_pending -= take
        return seq, works

    def _loop(self) -> None:
        while True:
            with self._cv:
                batch = None
                while batch is None:
                    if self._stopped and self._n_pending == 0:
                        return
                    batch = self._take_locked()
                    if batch is None:
                        # sleep until new work, a deadline, or shutdown
                        timeout = None
                        pick = self._oldest_seq()
                        if pick is not None:
                            deadline = (self._pending[pick][0].enqueued_at
                                        + self.max_batch_delay_s)
                            timeout = max(0.0, deadline - time.monotonic())
                            # a zero-ish timeout busy-spins; floor it
                            timeout = max(timeout, 1e-4)
                        self._cv.wait(timeout)
                seq, works = batch
                self._inflight = True
                depth = self._n_pending
            if self._on_depth is not None:
                self._on_depth(depth)
            try:
                self._run_fn(seq, works)
            except BaseException as exc:  # noqa: BLE001 - fail the batch,
                # keep the loop alive: one poisoned batch must not take the
                # whole serving plane down with it
                logger.exception("batch launch failed (seq=%d, n=%d)",
                                 seq, len(works))
                if self._fail_fn is not None:
                    try:
                        self._fail_fn(works, exc)
                    except Exception:  # noqa: BLE001
                        logger.exception("fail_fn raised")
            finally:
                with self._cv:
                    self._inflight = False
                    self._cv.notify_all()

    # -- shutdown --------------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admissions, flush everything admitted, return True when the
        queue emptied and the last in-flight batch completed (False on
        timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while self._n_pending > 0 or self._inflight:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(remaining if remaining is not None else 0.5)
        return True

    def close(self, timeout: float = 10.0) -> None:
        """drain() then stop the worker thread."""
        self.drain(timeout=timeout)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
