"""Device prefetch: host->device staging off the step path (the port of
``ml_recipe_tpu/data/device_prefetch.py``).

:class:`DevicePrefetcher` runs ``place_fn`` on each loader batch in a
background thread, keeping ``depth`` placed batches in flight, so the copy
of step k+1 overlaps the compute of step k. One worker and a FIFO bounded
queue: batches come out in exactly the loader's order. A worker failure is
re-raised on the consumer thread with the worker's traceback.

:class:`BatchPlacer` is the placement: every array of a batch goes into
pinned host memory and is copied with ``non_blocking=True`` on a side CUDA
stream; an event recorded after the copies travels with the batch, and
:meth:`PlacedBatch.ready` makes the consumer's stream wait on it, so a
batch is never read before its copy ends (and the tensors are marked as
used on the consumer's stream, for the caching allocator). On the CPU the
placement is a plain conversion.

``--device_prefetch auto`` resolves to a fixed depth of 2 with a logged
note (the JAX trainer times the first steps to choose 1 or 2; the port does
not).
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from .loader import DataLoaderWorkerError

logger = logging.getLogger(__name__)

AUTO_DEPTH = 2


def resolve_depth(spec) -> int:
    """``--device_prefetch``: an int depth, or ``auto`` -> :data:`AUTO_DEPTH`
    (logged)."""
    if str(spec).strip().lower() == "auto":
        logger.info("device_prefetch auto: the port uses a fixed depth of %d "
                    "(it does not time the first steps to choose).",
                    AUTO_DEPTH)
        return AUTO_DEPTH
    return max(0, int(spec or 0))


class PlacedBatch:
    """Device tensors of one batch, and the event their copy ends on."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]], meta: Any,
                 event: Optional["torch.cuda.Event"], host: list):
        self._tensors = tensors
        self.meta = meta
        self._event = event
        self._host = host   # pinned buffers, alive until the copy is waited

    def ready(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The tensors, usable on the current stream."""
        if self._event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self._event)
            for group in self._tensors.values():
                for t in group.values():
                    t.record_stream(stream)
            self._event = None
            self._host = []
        return self._tensors


class BatchPlacer:
    """``place(groups, meta)``: numpy arrays -> device tensors (see the
    module docstring); ``groups`` maps a name (``inputs``, ``labels``) to a
    dict of arrays."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, groups: Dict[str, Dict[str, np.ndarray]],
                 meta: Any = None) -> PlacedBatch:
        if self._stream is None:
            tensors = {g: {k: torch.from_numpy(np.asarray(v)).to(self.device)
                           for k, v in arrays.items()}
                       for g, arrays in groups.items()}
            return PlacedBatch(tensors, meta, None, [])
        host, tensors = [], {}
        with torch.cuda.stream(self._stream):
            for g, arrays in groups.items():
                tensors[g] = {}
                for k, v in arrays.items():
                    pinned = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    host.append(pinned)
                    tensors[g][k] = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return PlacedBatch(tensors, meta, event, host)


class _WorkerFailure:
    __slots__ = ("exc", "tb")

    def __init__(self, exc: BaseException, tb: str):
        self.exc = exc
        self.tb = tb


class DevicePrefetcher:
    """Iterate ``place_fn(item)`` for each item of ``source``, with the
    placement running ``depth`` batches ahead on a background thread.
    Single use: build one per pass over the source."""

    _DONE = object()

    def __init__(self, source: Iterable, place_fn: Callable[[Any], Any], *,
                 depth: int = 2, join_timeout: float = 10.0,
                 name: str = "device-prefetch"):
        self._source = source
        self._place = place_fn
        self.depth = max(1, int(depth))
        self._join_timeout = join_timeout
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._started = False
        self._closed = False

    def _worker(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                payload = (self._place(item),)
                while not self._stop.is_set():
                    try:
                        self._queue.put(payload, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised on consumer
            tb = traceback.format_exc()
            logger.error(f"Device-prefetch worker failed:\n{tb}")
            self._put_final(_WorkerFailure(exc, tb))
        else:
            self._put_final(self._DONE)

    def _put_final(self, token) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(token, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        if self._closed or self._started:
            raise RuntimeError("DevicePrefetcher is single-use; construct a "
                               "new instance for each pass over the source")
        self._started = True
        self._thread.start()
        try:
            while True:
                got = self._queue.get()
                if got is self._DONE:
                    return
                if isinstance(got, _WorkerFailure):
                    raise DataLoaderWorkerError(
                        f"device-prefetch worker failed: {got.exc!r}\n"
                        f"--- worker traceback ---\n{got.tb}") from got.exc
                yield got[0]
        finally:
            self.close()

    def close(self) -> None:
        """Stop the worker and join it. Idempotent; a worker still alive
        after the timeout gets its stack logged and, when no other exception
        is propagating, raises."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while True:  # unblock a worker parked on the full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if not self._started:
            return
        self._thread.join(timeout=self._join_timeout)
        if not self._thread.is_alive():
            return
        frame = sys._current_frames().get(self._thread.ident)
        stack = ("".join(traceback.format_stack(frame)) if frame is not None
                 else "<no frame available>")
        logger.warning(f"Prefetch thread {self._thread.name!r} still alive "
                       f"{self._join_timeout:g}s after close; its stack:\n{stack}")
        if sys.exc_info()[0] is None:
            raise DataLoaderWorkerError(
                f"device-prefetch thread {self._thread.name!r} failed to stop "
                f"within {self._join_timeout:g}s (stack logged above)")

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
