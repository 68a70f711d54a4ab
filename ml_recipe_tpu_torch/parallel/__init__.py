"""Parallelism over ``torch.distributed`` (the port of
``ml_recipe_tpu/parallel/``): joining the world (``dist.py``), the process
mesh of ``data`` and ``seq`` axes (``mesh.py``) and its plan
(``plan.py``), the ZeRO-1 layout and the sequence split (``sharding.py``),
and the collectives of the step, the ring attention's hop included
(``collectives.py``). Tensor and pipeline parallelism and the bucketed
ZeRO-1 overlap are not ported (ROADMAP.md queue 1, 'Parallelism beyond
data parallelism')."""

from .collectives import (
    all_reduce_gradients,
    all_reduce_sum_,
    broadcast_parameters,
    gather_to_host,
    regroup_for_world,
)
from .dist import (
    barrier,
    initialize_distributed,
    initialize_from_params,
    is_primary,
    process_count,
    process_index,
    shutdown,
)

__all__ = [
    "all_reduce_gradients",
    "all_reduce_sum_",
    "barrier",
    "broadcast_parameters",
    "gather_to_host",
    "initialize_distributed",
    "initialize_from_params",
    "is_primary",
    "process_count",
    "process_index",
    "regroup_for_world",
    "shutdown",
]
