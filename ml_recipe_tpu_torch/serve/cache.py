"""Serving hot-path caches: byte-budgeted LRU tiers for the QA engine (the
port of ``ml_recipe_tpu/serve/cache.py``).

Two independent tiers, both off by default and both strictly
transparency-preserving (a hit returns the exact object a miss would have
computed, so cached and uncached responses are bit-identical by
construction — pinned in tests/test_torch_serve_cache.py):

- **Tier 1 — document preprocessing cache** (``--doc_cache_bytes``): the
  ``encode_document`` token stream (the offset maps are train/eval-only —
  serving discards them) and the ``window_chunks`` layout, keyed by a
  content hash of the raw document text. Tokenization is question-
  independent by construction; the window layout depends on the question
  only through its token LENGTH (``document_len = max_seq - q_len - 3``),
  so its key carries ``(doc_hash, question_len, max_seq, doc_stride)`` —
  the same document asked a hundred different questions of tokenizes
  once. Hot documents skip host tokenization entirely.

- **Tier 2 — chunk-result cache** (``--serve_cache_bytes``): the packed
  span-logit output row of one device input row, keyed by a hash of the
  EXACT ``assemble_input_ids`` output plus a checkpoint fingerprint and
  the active precision (``off``/``int8`` are distinct keys — same bytes
  through a different arithmetic are a different result). A hit bypasses the
  micro-batcher and offers its row to the ticket directly: a fully-hot
  request never touches the device, and a partially-hot request (the same
  question over an edited/grown document) only computes the changed
  windows. The tier additionally runs SINGLE-FLIGHT dedup: identical
  chunks already in flight are joined as waiters instead of re-enqueued,
  so a burst of the same question/document pair costs one device row.

Both tiers are byte-budgeted LRUs with exact accounting: an insert that
would exceed the budget evicts least-recently-used entries first, and an
entry whose own cost exceeds the whole budget is refused outright (storing
it would evict everything and still not fit). Budget 0 disables a tier
completely — the engine then never computes keys, registers flights, or
touches this module's locks on the request path.

The per-document affinity this cache rewards is what the fleet's
consistent-hash router (``fleet/router.py``) feeds.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

__all__ = [
    "ByteBudgetLRU", "ChunkResultCache", "content_key", "row_key",
    "params_fingerprint",
]

# documented cost model for the byte budget: python object overhead per
# cached entry (key string + OrderedDict node + value holder), plus a
# per-token charge for the payloads. Token streams and window records are
# stored as the Python int lists the hot path consumes directly — a
# small-int list slot really costs ~36 B (28 B int object + 8 B pointer),
# and charging the int32 wire size instead would let resident memory
# overshoot the configured budget ~9x
ENTRY_OVERHEAD = 96
TOKEN_BYTES = 36


def content_key(text: str) -> str:
    """Stable content hash of one raw document text (tier-1 key root)."""
    return hashlib.sha256(text.encode("utf-8", "surrogatepass")).hexdigest()[:32]


def row_key(fingerprint: str, precision: str, input_ids) -> str:
    """Tier-2 key of one exact device input row.

    ``input_ids`` is the ``assemble_input_ids`` output (``[CLS] question
    [SEP] chunk [SEP]``) — hashing the final row means ANY difference that
    could change the model output (question text, chunk bytes, truncation)
    changes the key, while padding (applied later, to the bucket shape)
    cannot: the score function masks pad rows identically regardless of
    bucket, so one row has one result.
    """
    import numpy as np

    digest = hashlib.sha256(
        np.asarray(input_ids, np.int32).tobytes()
    ).hexdigest()[:32]
    return f"{fingerprint}|{precision or 'off'}|{digest}"


# tensors larger than this are fingerprinted by head + tail + byte count
# instead of a full hash: checkpoints that differ at all differ pervasively
# (every step updates every weight), so sampling is collision-safe in
# practice while keeping the startup device->host copy bounded
_FP_SAMPLE_BYTES = 1 << 20


def _host_bytes(t) -> bytes:
    """The raw bytes of a (flat, contiguous) tensor on the host. The bits
    are viewed as uint8 first: bf16 has no numpy dtype."""
    import torch

    return t.contiguous().view(torch.uint8).cpu().numpy().tobytes()


def params_fingerprint(model) -> str:
    """Checkpoint fingerprint: a content hash over the model's named
    tensors (``state_dict``: parameters and buffers, int8 codes and scales
    included) — name, dtype, shape and bytes, tensors over 2 MiB by their
    head, tail and byte count, sliced ON THE DEVICE before the host copy.
    Computed once at engine start-up, only when the tier-2 cache is on; two
    engines serving different weights can then never alias each other's
    cached rows. The value is the port's own (a cache lives inside one
    process): equal for the same weights loaded twice, different when one
    weight differs."""
    state = model.state_dict() if hasattr(model, "state_dict") else model
    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name].detach()
        nbytes = t.numel() * t.element_size()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        flat = t.reshape(-1)
        if nbytes > 2 * _FP_SAMPLE_BYTES:
            # slice on the device before the copy: the bound must hold for
            # the transfer, not just the hashing
            n = max(1, _FP_SAMPLE_BYTES // t.element_size())
            h.update(_host_bytes(flat[:n]))
            h.update(_host_bytes(flat[-n:]))
            h.update(str(nbytes).encode())
        else:
            h.update(_host_bytes(flat))
    return h.hexdigest()[:24]


class ByteBudgetLRU:
    """Thread-safe LRU over string keys with exact byte accounting.

    Every entry carries the caller-declared ``cost`` in bytes; inserts past
    ``budget_bytes`` evict least-recently-used entries until the new entry
    fits. ``get`` refreshes recency. Stats (``hits``/``misses``/
    ``evictions``/``bytes``) are plain monotonic counters the engine
    mirrors into its Prometheus registry.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.RLock()

    @property
    def lock(self) -> threading.RLock:
        return self._lock

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: str):
        """Cached value (refreshing recency) or None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: str, value, cost: int) -> int:
        """Insert (or refresh) ``key``; returns how many entries were
        evicted to make room. An entry whose own cost exceeds the whole
        budget is refused (it would evict everything and still not fit);
        a refreshed key's old cost is released first."""
        cost = int(cost)
        evicted = 0
        with self._lock:
            if cost > self.budget_bytes:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old[1]
                return evicted
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            while self._entries and self._bytes + cost > self.budget_bytes:
                _, (_, old_cost) = self._entries.popitem(last=False)
                self._bytes -= old_cost
                self.evictions += 1
                evicted += 1
            self._entries[key] = (value, cost)
            self._bytes += cost
        return evicted

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "bytes": self._bytes,
                "entries": len(self._entries),
            }


class ChunkResultCache(ByteBudgetLRU):
    """Tier 2: chunk-result LRU + single-flight dedup of in-flight rows.

    The flight table maps a row key to the list of WAITERS piggybacking on
    the one enqueued computation (the leader's ``ChunkWork``). The engine
    holds :attr:`lock` across classify-and-admit in ``submit`` so the
    flight table and the batcher admission stay atomic: a flight the
    engine leases is guaranteed to reach the queue (or be aborted under
    the same lock hold) before any other thread can observe it.
    """

    def __init__(self, budget_bytes: int):
        super().__init__(budget_bytes)
        self._flight: Dict[str, List[Tuple[Any, int]]] = {}
        # both MONOTONIC (the engine mirrors them into Prometheus
        # counters): joins count every piggyback as it happens, rollbacks
        # count joins later undone by admission failure — net dedup wins
        # are joins - rollbacks
        self.flight_joins = 0
        self.flight_join_rollbacks = 0

    def join_flight(self, key: str, waiter: Tuple[Any, int]) -> bool:
        """True = an identical row is already in flight and ``waiter`` was
        appended to it; False = no flight existed and one was LEASED (the
        caller must enqueue the row, then ``complete``/``abort`` it)."""
        with self._lock:
            waiters = self._flight.get(key)
            if waiters is not None:
                waiters.append(waiter)
                self.flight_joins += 1
                return True
            self._flight[key] = []
            return False

    def complete(self, key: str, row, cost: int) -> Tuple[List[Tuple[Any, int]], int]:
        """The leader's row arrived: cache it (LRU rules) and return
        ``(waiters, evicted)`` — every waiter gets the SAME row object the
        leader does."""
        with self._lock:
            waiters = self._flight.pop(key, [])
            evicted = self.put(key, row, cost)
        return waiters, evicted

    def fail_flight(self, key: str) -> List[Tuple[Any, int]]:
        """The leader's batch failed: nothing is cached; the waiters are
        returned so the engine can fail their tickets too."""
        with self._lock:
            return self._flight.pop(key, [])

    def abort_flight(self, key: str) -> None:
        """Admission of the leased leader failed (queue full / draining):
        forget the flight. Only callable under the same :attr:`lock` hold
        that leased it — no waiter can have joined in between."""
        with self._lock:
            self._flight.pop(key, None)

    def remove_waiters(self, owner) -> int:
        """Drop every waiter whose ticket IS ``owner`` (admission rollback
        of a request that joined flights — other requests' or its own
        just-leased ones). ``flight_joins`` stays monotonic; the undo is
        recorded in ``flight_join_rollbacks``."""
        removed = 0
        with self._lock:
            for waiters in self._flight.values():
                kept = [w for w in waiters if w[0] is not owner]
                removed += len(waiters) - len(kept)
                waiters[:] = kept
            self.flight_join_rollbacks += removed
        return removed

    def inflight(self) -> int:
        with self._lock:
            return len(self._flight)
