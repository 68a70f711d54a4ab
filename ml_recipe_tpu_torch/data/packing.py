"""The shared length oracle and the LR-schedule step planner (a copy of the
planning parts of ``ml_recipe_tpu/data/packing.py``).

Bucketing is content-dependent: which items form which ``(seq, rows)``
batch depends on the chunk lengths, which every process must agree on for
the step shapes to stay in lockstep. The oracle makes every item read a
pure function of ``(epoch, index)``: a dataset that draws its chunks from
an ``rng`` has it swapped for one seeded by ``(ORACLE_SEED, epoch,
index)`` for the read, so every process materialises the same items and
derives the same epoch plan from the deterministic epoch ordering, and
then collates only its row slice of each planned global batch. No
traffic between processes is needed.

Sequence packing itself (``SequencePacker``, ``PackedDataLoader``, the
splitting packer) is not ported (ROADMAP.md queue 1, 'Sequence packing').
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .loader import read_with_retry

# seed of the shared length oracle (the JAX package's ORACLE_SEED)
ORACLE_SEED = 0x0AC1E

# LR-schedule planning reads item LENGTHS, which means materializing items;
# past this many items the planner simulates on the epoch ordering's prefix
# and scales the step count
PLAN_SAMPLE_ITEMS = 4096

# the dataset.rng swap is process-global state: oracle reads of rng-carrying
# datasets are serialized (rng-less datasets read fully parallel)
_ORACLE_LOCK = threading.Lock()


def oracle_read(dataset, index: int, *, retries: int = 3, epoch: int = 0):
    """One item read as a pure function of ``(epoch, index)``: a dataset's
    chunk-sampling ``rng``, when it has one, is swapped for
    ``default_rng(SeedSequence([ORACLE_SEED, epoch, index]))`` for the
    read (fresh chunks each epoch, the same on every process and every
    repeat); the training draw stream is untouched."""
    if getattr(dataset, "rng", None) is None:
        return read_with_retry(dataset, int(index), retries=retries)
    with _ORACLE_LOCK:
        saved = dataset.rng
        dataset.rng = np.random.default_rng(
            np.random.SeedSequence([ORACLE_SEED, int(epoch), int(index)]))
        try:
            return read_with_retry(dataset, int(index), retries=retries)
        finally:
            dataset.rng = saved


def _oracle_epoch_key(dataset, epoch: int) -> int:
    """The epoch part of an oracle cache key: rng-less datasets give the
    same item every epoch (key 0, cached once for the run), stochastic-chunk
    datasets draw per epoch."""
    return int(epoch) if getattr(dataset, "rng", None) is not None else 0


def _item_meta(item) -> Tuple[int, int, int]:
    """The cached planning meta of one item: ``(length, start_id,
    end_id)``."""
    return (len(item.input_ids), int(getattr(item, "start_id", -1)),
            int(getattr(item, "end_id", -1)))


def oracle_epoch_meta(dataset, indices, *, cache: Dict[tuple, tuple],
                      n_jobs: int, read_retries: int,
                      epoch: int = 0) -> List[tuple]:
    """Item metas for ``indices`` under the oracle, each unique ``(epoch
    key, index)`` read at most once (``cache`` persists across epochs and
    is exact: oracle reads are reproducible)."""
    ek = _oracle_epoch_key(dataset, epoch)
    missing = sorted({int(i) for i in indices if (ek, int(i)) not in cache})
    if missing:
        with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as pool:
            for idx, item in zip(missing, pool.map(
                    lambda i: oracle_read(dataset, i, retries=read_retries,
                                          epoch=ek), missing)):
                cache[(ek, idx)] = _item_meta(item)
    return [cache[(ek, int(i))] for i in indices]


def oracle_epoch_lengths(dataset, indices, *, cache: Dict[tuple, tuple],
                         n_jobs: int, read_retries: int,
                         epoch: int = 0) -> List[int]:
    """Item lengths under the oracle (the bucket planner's column of
    :func:`oracle_epoch_meta`)."""
    return [meta[0] for meta in oracle_epoch_meta(
        dataset, indices, cache=cache, n_jobs=n_jobs,
        read_retries=read_retries, epoch=epoch)]


def epoch_item_meta(dataset, sampler, epoch, *, cache: dict, n_jobs: int,
                    read_retries: int, max_items: Optional[int] = None,
                    oracle: bool = False) -> List[tuple]:
    """Item metas in one epoch's order (the first ``max_items`` when
    given), each unique index read at most once. Without the oracle the
    dataset's ``rng`` is swapped for a throwaway during the reads, so
    planning never perturbs the training draws, and a stochastic-chunk
    item's meta is one draw, an estimate; ``oracle=True`` reads through
    :func:`oracle_read`: exact and the same on every process, which
    multi-process planning needs (a step count that differed across
    processes would differ the LR schedule itself)."""
    indices = [int(i) for i in sampler.epoch_indices(epoch)]
    if max_items is not None:
        indices = indices[:max_items]
    if oracle:
        return oracle_epoch_meta(dataset, indices, cache=cache, n_jobs=n_jobs,
                                 read_retries=read_retries, epoch=epoch)
    missing = sorted({i for i in indices if i not in cache})
    if missing:
        saved_rng = getattr(dataset, "rng", None)
        if saved_rng is not None:
            dataset.rng = np.random.default_rng(0)
        try:
            with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as pool:
                for idx, item in zip(missing, pool.map(
                        lambda i: read_with_retry(dataset, i,
                                                  retries=read_retries),
                        missing)):
                    cache[idx] = _item_meta(item)
        finally:
            if saved_rng is not None:
                dataset.rng = saved_rng
    return [cache[i] for i in indices]


def epoch_item_lengths(dataset, sampler, epoch, *, cache: dict, n_jobs: int,
                       read_retries: int, max_items: Optional[int] = None,
                       oracle: bool = False) -> List[int]:
    """Item lengths in one epoch's order (:func:`epoch_item_meta`'s length
    column)."""
    return [meta[0] for meta in epoch_item_meta(
        dataset, sampler, epoch, cache=cache, n_jobs=n_jobs,
        read_retries=read_retries, max_items=max_items, oracle=oracle)]


def plan_scaled_count(dataset, sampler, epoch, *, cache: dict, n_jobs: int,
                      read_retries: int, simulate,
                      oracle: bool = False) -> int:
    """The LR-schedule planning skeleton: read the epoch's item lengths
    (the first ``PLAN_SAMPLE_ITEMS`` of its ordering), run ``simulate(lengths)
    -> count``, and scale the count to the whole epoch when only a prefix
    was read. Tail handling stays with the caller (it must not be
    scaled)."""
    n_total = len(sampler.epoch_indices(epoch))
    lengths = epoch_item_lengths(
        dataset, sampler, epoch, cache=cache, n_jobs=n_jobs,
        read_retries=read_retries, max_items=PLAN_SAMPLE_ITEMS, oracle=oracle)
    count = simulate(lengths)
    if lengths and n_total > len(lengths):
        count = int(round(count * n_total / len(lengths)))
    return count
