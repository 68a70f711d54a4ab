"""Host-side input pipeline (a copy of ``ml_recipe_tpu/data/loader.py``'s
single-process parts).

- :class:`ShardedBatchSampler`: one deterministic global index ordering per
  epoch, from ``np.random.SeedSequence([seed, epoch])`` (shuffled, or
  weighted-with-replacement), chopped into global batches, of which it
  yields this process's contiguous row slice (the whole batch in a
  one-process run); the orderings and slices match the JAX loader's
  element for element.
- :class:`DataLoader`: a thread-pool prefetching loader producing collated
  fixed-shape numpy batches, in sampler order;
- :class:`ListDataloader`: the predictor's loader over a dataset whose items
  are LISTS of chunks, re-batched to a fixed size across documents.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..resilience.faults import fire as _fault
from ..resilience.faults import retry_transient

logger = logging.getLogger(__name__)


class DataLoaderWorkerError(RuntimeError):
    """An async loader worker died; the message carries its traceback."""


def read_with_retry(dataset, index: int, *, retries: int = 3,
                    base_delay: float = 0.05):
    """One dataset item read, retried with exponential backoff on a
    transient ``OSError`` (``resilience.faults.retry_transient``; the
    ``loader.read`` fault site fires before every read); other errors
    propagate at once."""

    def read():
        _fault("loader.read")
        return dataset[index]

    return retry_transient(read, retries=retries, base_delay=base_delay,
                           exceptions=(OSError,),
                           what=f"dataset read [{index}]")


class ShardedBatchSampler:
    """Deterministic per-process batch index sampler.

    Each epoch: one global ordering (shuffled, or weighted-with-replacement
    when ``weights`` is given), chopped into batches of
    ``global_batch_size``, of which process ``process_index`` of
    ``process_count`` gets rows ``[i*B/W, (i+1)*B/W)``. ``drop_last``
    mirrors the reference's train loader; ``pad_last`` keeps the final
    partial batch at full shape by repeating its last index (consumers trim
    with :meth:`valid_count`, a count of the global batch)."""

    def __init__(
        self,
        dataset_len: int,
        global_batch_size: int,
        *,
        process_index: int = 0,
        process_count: int = 1,
        shuffle: bool = True,
        weights: Optional[Sequence[float]] = None,
        drop_last: bool = True,
        pad_last: bool = False,
        seed: int = 0,
    ):
        if global_batch_size % process_count:
            raise ValueError(f"global batch {global_batch_size} must divide "
                             f"over {process_count} processes")
        self.dataset_len = dataset_len
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle = shuffle
        self.weights = None if weights is None else np.asarray(weights, dtype=np.float64)
        self.drop_last = drop_last
        self.pad_last = pad_last and not drop_last
        self.seed = seed

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_len // self.global_batch_size
        return (self.dataset_len + self.global_batch_size - 1) // self.global_batch_size

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        if self.weights is not None:
            p = self.weights / self.weights.sum()
            return rng.choice(self.dataset_len, size=self.dataset_len, replace=True, p=p)
        if self.shuffle:
            return rng.permutation(self.dataset_len)
        return np.arange(self.dataset_len)

    def valid_count(self, batch_index: int) -> int:
        """Number of real (non-padding) rows in the given global batch."""
        remaining = self.dataset_len - batch_index * self.global_batch_size
        return int(min(self.global_batch_size, max(remaining, 0)))

    def __call__(self, epoch: int) -> Iterator[np.ndarray]:
        indices = self.epoch_indices(epoch)
        for b in range(len(self)):
            batch = indices[b * self.global_batch_size:(b + 1) * self.global_batch_size]
            if len(batch) < self.global_batch_size:
                if self.drop_last:
                    return
                if self.pad_last:
                    pad = np.full(self.global_batch_size - len(batch),
                                  batch[-1] if len(batch) else 0,
                                  dtype=indices.dtype)
                    batch = np.concatenate([batch, pad])
            lo = self.process_index * self.local_batch_size
            yield batch[lo:lo + self.local_batch_size]


class DataLoader:
    """Prefetching map-style loader producing collated fixed-shape batches."""

    def __init__(self, dataset, sampler: ShardedBatchSampler,
                 collate_fun: Callable, *, n_jobs: int = 4, prefetch: int = 4,
                 read_retries: int = 3):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fun = collate_fun
        self.n_jobs = max(1, n_jobs)
        self.prefetch = max(1, prefetch)
        self.read_retries = max(0, read_retries)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.sampler)

    def real_rows(self, batch_index: int) -> int:
        """Real (non-padding) rows in the given batch."""
        return self.sampler.valid_count(batch_index)

    def _load_batch(self, batch_indices: np.ndarray):
        items = [read_with_retry(self.dataset, int(i), retries=self.read_retries)
                 for i in batch_indices]
        return self.collate_fun(items)

    def __iter__(self):
        batches = list(self.sampler(self._epoch))
        if not batches:
            return
        with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
            futures: list = []
            it = iter(batches)
            for _ in range(min(self.prefetch, len(batches))):
                futures.append(pool.submit(self._load_batch, next(it)))
            pending = len(batches) - len(futures)
            while futures:
                fut = futures.pop(0)
                if pending > 0:
                    futures.append(pool.submit(self._load_batch, next(it)))
                    pending -= 1
                yield fut.result()


class ListDataloader:
    """Async loader for datasets whose ``__getitem__`` returns a LIST of chunks
    (the JAX package's ``ListDataloader``; reference utils/list_dataloader.py).

    A thread pool expands each document into its chunk list, in index
    order (shuffled from ``seed`` when ``shuffle``), the chunks stream
    through a bounded queue, and the consumer re-batches them to
    ``batch_size`` across document boundaries; the last batch may be
    short. A worker's error reaches the consumer as
    :class:`DataLoaderWorkerError` carrying the worker's traceback.

    The JAX loader submits every document to ``pool.map`` at once; here at
    most ``2 * n_jobs`` documents are read ahead of the one the queue takes
    next, in the same order. The batches are
    the same; a consumer that stops early (the predictor's ``--limit``)
    leaves the rest unread, and closing the iterator stops the producer."""

    _SENTINEL = object()

    def __init__(self, dataset, batch_size: int, *, n_jobs: int = 4,
                 collate_fun: Optional[Callable] = None,
                 buffer_size: int = 1024, shuffle: bool = False,
                 seed: int = 0, read_retries: int = 3):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fun = collate_fun
        self.n_jobs = max(1, n_jobs)
        self.buffer_size = buffer_size
        self.shuffle = shuffle
        self.seed = seed
        self.read_retries = max(0, read_retries)

    def process_batch(self, batch):
        return self.collate_fun(batch) if self.collate_fun is not None else batch

    def __iter__(self):
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(idxs)

        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        errors: list = []
        stop = threading.Event()

        def read(i: int):
            if stop.is_set():
                return []
            return read_with_retry(self.dataset, i, retries=self.read_retries)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
                    order = iter(idxs.tolist())
                    reads = deque(pool.submit(read, i) for i in
                                  itertools.islice(order, 2 * self.n_jobs))
                    try:
                        while reads:
                            chunks = reads.popleft().result()
                            nxt = next(order, None)
                            if nxt is not None:
                                reads.append(pool.submit(read, nxt))
                            for chunk in chunks:
                                if not put(chunk):
                                    return
                    finally:
                        for fut in reads:
                            fut.cancel()
            except Exception as e:  # surface worker errors to the consumer
                # the traceback is taken here: the consumer's re-raise has
                # another stack
                tb = traceback.format_exc()
                logger.error(f"ListDataloader worker failed:\n{tb}")
                errors.append((e, tb))
            finally:
                put(self._SENTINEL)

        thread = threading.Thread(target=producer, name="list-dataloader",
                                  daemon=True)
        thread.start()
        try:
            batch = []
            while True:
                chunk = q.get()
                if chunk is self._SENTINEL:
                    break
                batch.append(chunk)
                if len(batch) == self.batch_size:
                    yield self.process_batch(batch)
                    batch = []
            if errors:
                e, tb = errors[0]
                raise DataLoaderWorkerError(
                    f"async loader worker failed: {e!r}\n"
                    f"--- worker traceback ---\n{tb}") from e
            if batch:
                yield self.process_batch(batch)
        finally:
            stop.set()
            thread.join()
