"""The serving plane's metric primitives, re-exported from
``ml_recipe_tpu_torch.metrics.registry`` (the JAX package's layout)."""

from __future__ import annotations

from ..metrics.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Info,
    Registry,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "Info",
    "Registry",
]
