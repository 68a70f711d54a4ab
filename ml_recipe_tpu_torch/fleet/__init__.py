"""Serving fleet: consistent-hash router tier over N engine processes (the
port of ``ml_recipe_tpu/fleet/``).

One shared-nothing HTTP router (``.router``) hashes each request's
document content hash onto a consistent-hash ring (``.ring``) so repeat
traffic lands on the engine whose serving caches are already warm, sheds
load health-first (weight-reduce -> eject -> spill -> 503+Retry-After),
and aggregates the tier's metrics; a fleet supervisor (``.manager``)
owns the N engine children under the ``resilience/`` exit-code contract
and performs rolling restarts in which no replacement builds a kernel
(``ops/cuda_build.py``).

Everything here is stdlib-only — the router tier never imports torch, so
it stays cheap to run anywhere in front of the engines.
"""

from .manager import EngineHandle, FleetError, FleetManager
from .ring import HashRing
from .router import EngineEndpoint, FleetRouter

__all__ = [
    "EngineEndpoint",
    "EngineHandle",
    "FleetError",
    "FleetManager",
    "FleetRouter",
    "HashRing",
]
