"""Length-bucketed token-budget batching (a copy of the single-process parts
of ``ml_recipe_tpu/data/bucketing.py`` and of the step planner in
``ml_recipe_tpu/data/packing.py``).

Items go to the smallest bucket seq that fits them and are padded to that
bucket; the per-bucket batch size scales inversely with the seq so every
step carries about the same number of tokens (the token budget). The loader
walks the sampler's deterministic epoch ordering, so the batches match the
JAX loader's element for element. :meth:`BucketedDataLoader.
planned_epoch_steps` is the length-only simulation the LR schedule is sized
from. Multi-host planning (the shared length oracle) waits for DDP
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from .collate import rebind_collate_seq
from .loader import read_with_retry

logger = logging.getLogger(__name__)

DEFAULT_NUM_BUCKETS = 4

# LR-schedule planning reads item LENGTHS, which means materializing items;
# past this many items the planner simulates on the epoch ordering's prefix
# and scales the step count (packing.py's PLAN_SAMPLE_ITEMS)
PLAN_SAMPLE_ITEMS = 4096


def auto_seq_grid(max_seq_len: int, n_buckets: int = DEFAULT_NUM_BUCKETS) -> List[int]:
    """Evenly spaced seq grid ending exactly at ``max_seq_len``, each edge
    rounded UP to a multiple of 8. max 512 -> [128, 256, 384, 512]."""
    if max_seq_len < 8:
        return [int(max_seq_len)]
    grid = set()
    for k in range(1, max(1, n_buckets) + 1):
        edge = int(-(-(max_seq_len * k) // (n_buckets * 8)) * 8)  # ceil to 8
        grid.add(min(edge, int(max_seq_len)))
    grid.add(int(max_seq_len))
    return sorted(grid)


def parse_length_buckets(spec, max_seq_len: Optional[int] = None) -> Optional[List[int]]:
    """``--length_buckets``: ``off``/``none``/``0`` (or None) -> None
    (pad-to-max); ``auto`` -> :func:`auto_seq_grid`; ``"128,256,384"`` ->
    explicit edges; a list/tuple passes through. With ``max_seq_len`` the
    grid is extended to cover it."""
    if spec is None:
        return None
    if isinstance(spec, (list, tuple)):
        grid = [int(s) for s in spec]
    else:
        s = str(spec).strip().lower()
        if s in ("off", "none", "0", "false", ""):
            return None
        if s == "auto":
            if max_seq_len is None:
                raise ValueError("length_buckets=auto requires max_seq_len")
            grid = auto_seq_grid(int(max_seq_len))
        else:
            try:
                grid = [int(p) for p in s.split(",") if p.strip()]
            except ValueError:
                raise ValueError(
                    f"bad length_buckets spec {spec!r} (want 'off', 'auto', "
                    f"or comma-separated seq edges like '128,256,384,512')"
                ) from None
    if not grid:
        return None
    if any(g < 8 for g in grid):
        raise ValueError(f"length_buckets edges must be >= 8, got {sorted(grid)}")
    grid = sorted(set(grid))
    if max_seq_len is not None:
        if grid[-1] > int(max_seq_len):
            raise ValueError(
                f"length_buckets edge {grid[-1]} exceeds max_seq_len "
                f"{int(max_seq_len)} (batches would outgrow the model's "
                f"position table)")
        if grid[-1] < int(max_seq_len):
            grid.append(int(max_seq_len))
    return grid


def bucket_batch_sizes(seq_grid: Sequence[int], token_budget: int, *,
                       multiple: int = 1) -> Dict[int, int]:
    """Per-bucket batch sizes holding ``batch * seq`` at (or just under) the
    token budget, rounded DOWN to ``multiple`` (``batch_split``), never
    below it."""
    multiple = max(1, int(multiple))
    sizes = {}
    for seq in seq_grid:
        b = (int(token_budget) // int(seq)) // multiple * multiple
        sizes[int(seq)] = max(b, multiple)
    return sizes


class BucketedBatch(NamedTuple):
    """One collated batch padded to its bucket: ``rows`` rows of ``seq``
    tokens, the first ``real_rows`` real (the rest repeat the last real row:
    eval tail padding; train batches are always full)."""

    inputs: dict
    labels: dict
    seq: int
    real_rows: int
    rows: int


class TokenBudgetBucketer:
    """Streaming item -> bucket accumulator: ``add`` returns a full ``(seq,
    items)`` group when the item completes its bucket's batch, ``flush``
    drains the partial tails in grid order."""

    def __init__(self, seq_grid: Sequence[int], batch_sizes: Dict[int, int]):
        self.seq_grid = sorted(int(s) for s in seq_grid)
        self.batch_sizes = {int(k): int(v) for k, v in batch_sizes.items()}
        self._pending: Dict[int, list] = {s: [] for s in self.seq_grid}

    def bucket_for(self, length: int) -> int:
        for seq in self.seq_grid:
            if length <= seq:
                return seq
        return self.seq_grid[-1]

    def add(self, length: int, item):
        seq = self.bucket_for(length)
        pending = self._pending[seq]
        pending.append(item)
        if len(pending) >= self.batch_sizes[seq]:
            self._pending[seq] = []
            return seq, pending
        return None

    def flush(self):
        for seq in self.seq_grid:
            pending = self._pending[seq]
            if pending:
                self._pending[seq] = []
                yield seq, pending


def _epoch_item_lengths(dataset, indices: List[int], *, cache: Dict[int, int],
                        n_jobs: int, read_retries: int) -> List[int]:
    """Item lengths in epoch order, each unique index read once (``cache``
    persists across epochs). A dataset's chunk-sampling ``rng``, when it has
    one, is swapped for a throwaway during the reads so planning never
    perturbs the training draw stream."""
    missing = sorted({i for i in indices if i not in cache})
    if missing:
        saved_rng = getattr(dataset, "rng", None)
        if saved_rng is not None:
            dataset.rng = np.random.default_rng(0)
        try:
            with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as pool:
                items = pool.map(
                    lambda i: read_with_retry(dataset, i, retries=read_retries),
                    missing)
                for idx, item in zip(missing, items):
                    cache[idx] = len(item.input_ids)
        finally:
            if saved_rng is not None:
                dataset.rng = saved_rng
    return [cache[i] for i in indices]


class BucketedDataLoader:
    """Prefetching loader producing bucket-homogeneous collated batches.

    Walks ``sampler.epoch_indices(epoch)``, reads items through a retrying
    thread pool in submission order, and groups them by length bucket under
    the token budget. Train mode (``pad_last=False``) drops the partial
    bucket tails at epoch end; eval mode pads them by repeating the last
    real item and reports ``real_rows``."""

    def __init__(self, dataset, sampler, collate_fun, *,
                 seq_grid: Sequence[int], token_budget: Optional[int] = None,
                 batch_multiple: int = 1, n_jobs: int = 4,
                 read_window: Optional[int] = None, read_retries: int = 3,
                 pad_last: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fun = collate_fun
        self.seq_grid = sorted(int(s) for s in seq_grid)
        self.token_budget = int(
            token_budget if token_budget is not None
            else sampler.global_batch_size * self.seq_grid[-1])
        self.n_jobs = max(1, n_jobs)
        self.read_window = (int(read_window) if read_window is not None
                            else self.n_jobs * 8)
        self.read_retries = max(0, read_retries)
        self.pad_last = pad_last
        self._epoch = 0
        self._collates: Dict[int, object] = {}
        self._last_stats: Optional[dict] = None
        self._len_cache: Dict[int, int] = {}
        self.batch_multiple = max(1, int(batch_multiple))
        self.batch_sizes = bucket_batch_sizes(
            self.seq_grid, self.token_budget, multiple=self.batch_multiple)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        """Upper-bound step estimate (the pad-to-max batch count)."""
        return len(self.sampler)

    def planned_epoch_steps(self, epoch: int) -> int:
        """Planned batch count of one epoch: the bucketer simulated over the
        epoch's item lengths (prefix-bounded by ``PLAN_SAMPLE_ITEMS`` and
        scaled back), plus the eval tails when ``pad_last``."""
        order = [int(i) for i in self.sampler.epoch_indices(epoch)]
        prefix = order[:PLAN_SAMPLE_ITEMS]
        lengths = _epoch_item_lengths(
            self.dataset, prefix, cache=self._len_cache, n_jobs=self.n_jobs,
            read_retries=self.read_retries)
        bucketer = TokenBudgetBucketer(self.seq_grid, self.batch_sizes)
        count = sum(1 for length in lengths
                    if bucketer.add(length, None) is not None)
        tail = sum(1 for _ in bucketer.flush()) if self.pad_last else 0
        if lengths and len(order) > len(lengths):
            count = int(round(count * len(order) / len(lengths)))
        return count + tail

    def _collate_for(self, seq: int):
        collate = self._collates.get(seq)
        if collate is None:
            collate = rebind_collate_seq(self.collate_fun, seq)
            self._collates[seq] = collate
        return collate

    def _emit(self, seq: int, items: list, stats: dict, *, real_rows=None):
        real = len(items) if real_rows is None else int(real_rows)
        inputs, labels = self._collate_for(seq)(items)[:2]
        rows = len(items)
        stats["real_tokens"] += sum(len(it.input_ids) for it in items[:real])
        stats["bucket_tokens"] += rows * seq
        stats["padmax_tokens"] += real * self.seq_grid[-1]
        stats["batches"] += 1
        stats["items"] += real
        return BucketedBatch(inputs=inputs, labels=labels, seq=seq,
                             real_rows=real, rows=rows)

    def __iter__(self):
        indices = [int(i) for i in self.sampler.epoch_indices(self._epoch)]
        self._last_stats = stats = {
            "real_tokens": 0, "bucket_tokens": 0, "padmax_tokens": 0,
            "batches": 0, "items": 0, "dropped_items": 0,
        }
        bucketer = TokenBudgetBucketer(self.seq_grid, self.batch_sizes)
        if indices:
            with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:

                def read(i):
                    return read_with_retry(self.dataset, i,
                                           retries=self.read_retries)

                futures: deque = deque()
                it = iter(indices)
                for idx in indices[: self.read_window]:
                    futures.append(pool.submit(read, idx))
                    next(it)
                while futures:
                    # consumed in SUBMISSION order: bucket assignment must
                    # follow the epoch ordering
                    item = futures.popleft().result()
                    nxt = next(it, None)
                    if nxt is not None:
                        futures.append(pool.submit(read, nxt))
                    emitted = bucketer.add(len(item.input_ids), item)
                    if emitted is not None:
                        yield self._emit(emitted[0], emitted[1], stats)
        for seq, items in bucketer.flush():
            if self.pad_last:
                real = len(items)
                pad = self.batch_sizes[seq] - real
                yield self._emit(seq, items + [items[-1]] * pad, stats,
                                 real_rows=real)
            else:
                stats["dropped_items"] += len(items)
        if stats["dropped_items"]:
            logger.info("Bucketed epoch dropped %d partial-bucket tail items "
                        "(drop_last parity; they re-enter next epoch's "
                        "shuffle).", stats["dropped_items"])

    @property
    def epoch_stats(self) -> Optional[dict]:
        """Token accounting of the last (or in-progress) epoch."""
        s = self._last_stats
        if not s:
            return None
        out = dict(s)
        if s["bucket_tokens"]:
            out["padding_waste_pct"] = round(
                100.0 * (1.0 - s["real_tokens"] / s["bucket_tokens"]), 2)
        if s["padmax_tokens"]:
            out["padmax_waste_pct"] = round(
                100.0 * (1.0 - s["real_tokens"] / s["padmax_tokens"]), 2)
        return out
