"""Bucketed shape admission for online serving.

Every request is admitted into a SMALL FIXED GRID of ``(batch, seq)``
buckets, so the device only ever sees a handful of shapes, each warmed at
startup (the attention kernel built, allocator blocks sized): a chunk of
length L runs in the smallest bucket seq >= L (padded to it), and a group
of N concurrent chunks runs at the smallest bucket batch >= N (rows padded
to it). The whole traffic distribution is served by
``len(grid)`` shapes, all warmed at startup (``QAEngine.warmup``).

Also home to ``pad_trailing_batch``, the pad-rows-to-static-batch helper
that the JAX package's batch predictor and serving engine share.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

# "8x128, 16x384" — batch x seq, comma-separated
_BUCKET_RE = re.compile(r"^\s*(\d+)\s*[xX*]\s*(\d+)\s*$")


@dataclass(frozen=True, order=True)
class Bucket:
    """One serving shape: ``batch`` rows of ``seq`` tokens."""

    seq: int
    batch: int

    def __str__(self) -> str:  # the spec syntax round-trips
        return f"{self.batch}x{self.seq}"


def parse_bucket_spec(spec: str) -> List[Bucket]:
    """Parse ``"4x64,8x64,8x384"`` (``batch x seq``) into sorted buckets."""
    buckets = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        m = _BUCKET_RE.match(part)
        if not m:
            raise ValueError(
                f"bad bucket {part!r} in spec {spec!r} "
                f"(want 'BATCHxSEQ[,BATCHxSEQ...]', e.g. '8x128,16x384')"
            )
        batch, seq = int(m.group(1)), int(m.group(2))
        if batch < 1 or seq < 8:
            raise ValueError(
                f"bucket {part!r}: batch must be >= 1 and seq >= 8"
            )
        buckets.append(Bucket(seq=seq, batch=batch))
    if not buckets:
        raise ValueError(f"bucket spec {spec!r} names no buckets")
    return sorted(set(buckets))


class BucketGrid:
    """The admission map over a fixed set of ``(batch, seq)`` buckets."""

    def __init__(self, buckets: Sequence[Bucket]):
        if not buckets:
            raise ValueError("empty bucket grid")
        self._by_seq: Dict[int, List[int]] = {}
        for b in sorted(set(buckets)):
            self._by_seq.setdefault(b.seq, []).append(b.batch)
        for batches in self._by_seq.values():
            batches.sort()

    @classmethod
    def from_spec(cls, spec: str) -> "BucketGrid":
        return cls(parse_bucket_spec(spec))

    def __len__(self) -> int:
        return sum(len(bs) for bs in self._by_seq.values())

    def __iter__(self):
        for seq in sorted(self._by_seq):
            for batch in self._by_seq[seq]:
                yield Bucket(seq=seq, batch=batch)

    @property
    def seqs(self) -> List[int]:
        return sorted(self._by_seq)

    @property
    def max_seq(self) -> int:
        return max(self._by_seq)

    def admit(self, seq_len: int) -> Optional[int]:
        """Smallest bucket seq that fits ``seq_len`` tokens, or None when
        the input exceeds every bucket (the caller rejects the request —
        an over-long chunk must never reach the device)."""
        for seq in sorted(self._by_seq):
            if seq_len <= seq:
                return seq
        return None

    def max_batch_for(self, seq: int) -> int:
        return self._by_seq[seq][-1]

    def batch_for(self, seq: int, n_items: int) -> int:
        """Smallest bucket batch >= ``n_items`` at this seq (least padding);
        the largest when even it is smaller than ``n_items`` (the caller
        splits the group)."""
        for batch in self._by_seq[seq]:
            if n_items <= batch:
                return batch
        return self._by_seq[seq][-1]

    def scatter_plan(self, seq: int, n_items: int) -> List[int]:
        """Batch sizes that run ``n_items`` chunks CHUNK-PARALLEL at
        ``seq`` in as few program launches as possible: greedy slices of
        the largest bucket batch, with the remainder admitted into the
        smallest batch that fits it (least padding). This is the
        long-request path: a document that windows into dozens
        of chunks launches ``len(plan)`` dedicated batches immediately
        instead of trickling through deadline coalescing one bucket at a
        time — with a long-request bucket sized to the windowed chunk
        count, a whole book answers in ONE device step."""
        if n_items < 1:
            return []
        largest = self.max_batch_for(seq)
        plan = [largest] * (n_items // largest)
        rest = n_items % largest
        if rest:
            plan.append(self.batch_for(seq, rest))
        return plan

    def drop(self, bucket: Bucket) -> bool:
        """Remove one bucket (the memory pre-flight shrinking an
        over-committed grid at warm-up instead of running out of memory
        mid-traffic). Returns False when it was the last bucket at any seq
        AND the last seq: the grid never shrinks to nothing."""
        batches = self._by_seq.get(bucket.seq)
        if not batches or bucket.batch not in batches:
            return False
        if len(self._by_seq) == 1 and len(batches) == 1:
            return False
        batches.remove(bucket.batch)
        if not batches:
            del self._by_seq[bucket.seq]
        return True


def pad_trailing_batch(inputs: dict, batch_size: int) -> dict:
    """Pad a dict of ``[n, ...]`` host arrays up to ``batch_size`` rows by
    repeating each array's last row (factored from the predictor's
    trailing-partial-batch handling — repeated real rows, never all-pad
    rows, so no fully-masked attention row ever reaches a softmax).

    A no-op (same dict) when the batch is already full.
    """
    n_valid = min(
        int(np.shape(v)[0]) for v in inputs.values()
    ) if inputs else 0
    if n_valid >= batch_size:
        return inputs
    pad = batch_size - n_valid
    return {
        k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
        for k, v in inputs.items()
    }

