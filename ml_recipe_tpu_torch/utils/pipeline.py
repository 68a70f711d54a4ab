"""One-step-lag host/device pipelining (a copy of
``ml_recipe_tpu/utils/pipeline.py`` without its grouped delivery, which
only the reference's grouped fetches use).

The predictor's loop has this shape: dispatch batch N to the device, then
do the host-side work (the device->host copy, candidate updates) for batch
N-1, by which time batch N is already enqueued, so the device never idles
on host work. This
helper keeps the feed/flush discipline (including the trailing flush that a
hand-rolled copy can silently forget) in one place.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional


class LaggedConsumer:
    """Calls ``consume(*args)`` ``depth`` feeds late; ``flush`` drains the tail.

    ``feed(*args)`` consumes the item fed ``depth`` calls ago (if any) and
    stores the new one. ``depth=1`` is the classic one-step lag; deeper lags
    keep more batches in flight — useful when each device round-trip carries
    real latency and the consumer's fetch would otherwise re-serialize the
    pipeline. When ``total`` is given (the known number of feeds), the
    final ``feed`` drains everything immediately, so progress displays that
    close with the loop still include the last item.
    ``flush()`` consumes all stored items; call it after the loop (covers
    early exits and unknown-length streams) — it is idempotent.
    """

    def __init__(self, consume: Callable[..., None], total: Optional[int] = None,
                 depth: int = 1):
        self._consume = consume
        self._total = total
        self._depth = max(1, depth)
        self._fed = 0
        self._pending: deque = deque()

    def feed(self, *args) -> None:
        self._pending.append(args)
        while len(self._pending) > self._depth:
            self._consume(*self._pending.popleft())
        self._fed += 1
        if self._total is not None and self._fed >= self._total:
            self.flush()

    def flush(self) -> None:
        while self._pending:
            self._consume(*self._pending.popleft())
