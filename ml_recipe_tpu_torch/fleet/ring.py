"""Consistent-hash ring with bounded-replica virtual nodes (the port of
``ml_recipe_tpu/fleet/ring.py``; the same positions, so one document maps
to the same node id in both packages).

The router hashes each request's document content hash onto this ring so
repeat traffic for a document keeps landing on the engine whose tier-1
doc cache (``serve/cache.py``) is already warm. Classic consistent hashing
(Karger et al.): each engine owns ``replicas`` pseudo-random positions on
a 64-bit ring, a key is served by the first position clockwise from its
own hash, and membership changes only remap the keys the joining/leaving
engine owns — every other engine's cache stays warm through an ejection
or a rolling restart.

Replicas are BOUNDED, and double as the health-weighting mechanism: a
node's virtual-node count is ``ceil(replicas * weight)`` with weight in
(0, 1], so the router's health poll can shrink a degraded engine's share
of the keyspace (weight-reduce) without ejecting it, and restore it in
one call. Positions for the retained vnodes are a prefix of the full set
— restoring a weight re-adds exactly the positions that were shed, so a
degrade/restore round-trip is a no-op for key placement.
"""

from __future__ import annotations

import bisect
import hashlib
import math
import threading
from typing import Dict, List, Optional

__all__ = ["HashRing"]


def _position(token: str) -> int:
    """64-bit ring position of one token (node#replica or a request key)."""
    return int.from_bytes(
        hashlib.sha256(token.encode("utf-8", "surrogatepass")).digest()[:8],
        "big",
    )


class HashRing:
    """Thread-safe consistent-hash ring over string node ids."""

    def __init__(self, *, replicas: int = 64):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = int(replicas)
        self._weights: Dict[str, float] = {}
        # sorted ring positions + the node owning each (rebuilt on change;
        # lookups are pure bisect over immutable snapshots)
        self._positions: List[int] = []
        self._owners: List[str] = []
        self._lock = threading.Lock()

    # -- membership ------------------------------------------------------------

    def add(self, node: str, weight: float = 1.0) -> None:
        """Add ``node`` (or reset its weight if present) and rebuild."""
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"weight must be in (0, 1], got {weight}")
        with self._lock:
            self._weights[node] = float(weight)
            self._rebuild()

    def set_weight(self, node: str, weight: float) -> None:
        """Resize ``node``'s virtual-node share (health-driven shedding)."""
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"weight must be in (0, 1], got {weight}")
        with self._lock:
            if node not in self._weights:
                raise KeyError(f"node {node!r} not on the ring")
            self._weights[node] = float(weight)
            self._rebuild()

    def remove(self, node: str) -> None:
        """Eject ``node``; absent nodes are a no-op (eject is idempotent)."""
        with self._lock:
            if self._weights.pop(node, None) is not None:
                self._rebuild()

    def __contains__(self, node: str) -> bool:
        with self._lock:
            return node in self._weights

    def __len__(self) -> int:
        with self._lock:
            return len(self._weights)

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._weights)

    def weight(self, node: str) -> Optional[float]:
        with self._lock:
            return self._weights.get(node)

    # -- lookup ----------------------------------------------------------------

    def node_for(self, key: str) -> Optional[str]:
        """The node owning ``key`` (first position clockwise), or None."""
        owners = self.preference(key, limit=1)
        return owners[0] if owners else None

    def preference(self, key: str, limit: Optional[int] = None) -> List[str]:
        """Distinct nodes in ring order starting at ``key``'s position.

        The spill order: index 0 owns the key, index 1 is where requests
        spill when the owner is ejected mid-flight, and so on. ``limit``
        caps the list (None = every ring member).
        """
        pos = _position(key)
        with self._lock:
            if not self._positions:
                return []
            if limit is None:
                limit = len(self._weights)
            start = bisect.bisect_right(self._positions, pos)
            seen: List[str] = []
            n = len(self._positions)
            for step in range(n):
                owner = self._owners[(start + step) % n]
                if owner not in seen:
                    seen.append(owner)
                    if len(seen) >= limit:
                        break
            return seen

    # -- internals -------------------------------------------------------------

    def _rebuild(self) -> None:
        """Recompute the sorted position arrays. Caller holds the lock.

        A node's vnode tokens are ``node#0 .. node#(k-1)`` with
        ``k = ceil(replicas * weight)`` — a weight change keeps a PREFIX
        of the full token set, so shrink/restore round-trips reproduce the
        original placement exactly.
        """
        pairs = []
        for node, weight in self._weights.items():
            k = max(1, min(self.replicas, math.ceil(self.replicas * weight)))
            for i in range(k):
                pairs.append((_position(f"{node}#{i}"), node))
        pairs.sort()
        self._positions = [p for p, _ in pairs]
        self._owners = [o for _, o in pairs]
