"""Data parallelism over ``torch.distributed`` (the port of
``ml_recipe_tpu/parallel/``'s multi-process parts): joining the world
(``dist.py``) and the collectives of the data-parallel step
(``collectives.py``). Meshes, ZeRO-1, tensor, pipeline and ring parallelism
are not ported (ROADMAP.md queue 1, 'Parallelism beyond data
parallelism')."""

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
