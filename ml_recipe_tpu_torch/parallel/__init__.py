"""Parallelism over ``torch.distributed`` (the port of
``ml_recipe_tpu/parallel/``): joining the world (``dist.py``), the process
mesh of ``data``, ``seq``, ``pipe`` and ``model`` axes (``mesh.py``) and
its plan (``plan.py``, narrowed over the live processes under ``--elastic
on``), the tensor-parallel rules, the ZeRO-1 layout and its gradient
buckets and the sequence split (``sharding.py``), the pipeline's stages
and schedules (``pipeline.py``), and the collectives of the step, the
ring attention's hop, the pipeline stages' hand-offs, the ``model``
group's conjugate all-reduces and the bucketed ZeRO-1 exchange included
(``collectives.py``). A ``model`` axis runs beside ``data`` and ``pipe``
(a stage's layers split over its ``model`` group); beside ``seq`` it is
not ported (ROADMAP.md queue 1, 'Parallelism beyond data parallelism',
item 'seq x model')."""

from .collectives import (
    BucketedExchange,
    GradBucket,
    all_reduce_gradients,
    all_reduce_sum_,
    broadcast_parameters,
    gather_to_host,
    plan_grad_buckets,
    regroup_for_world,
)
from .dist import (
    barrier,
    elastic_world_override,
    initialize_distributed,
    initialize_from_params,
    is_primary,
    process_count,
    process_index,
    shutdown,
)
from .mesh import ElasticMeshError, elastic_axes
from .pipeline import (
    PIPE_SCHEDULES,
    StageLayout,
    modeled_bubble_fraction,
    stage_assignment,
)
from .plan import ParallelPlan
from .sharding import leaf_sizes, zero1_bucket_plan

__all__ = [
    "BucketedExchange",
    "ElasticMeshError",
    "PIPE_SCHEDULES",
    "GradBucket",
    "ParallelPlan",
    "all_reduce_gradients",
    "all_reduce_sum_",
    "barrier",
    "broadcast_parameters",
    "elastic_axes",
    "elastic_world_override",
    "gather_to_host",
    "initialize_distributed",
    "initialize_from_params",
    "is_primary",
    "leaf_sizes",
    "plan_grad_buckets",
    "process_count",
    "process_index",
    "regroup_for_world",
    "shutdown",
    "StageLayout",
    "modeled_bubble_fraction",
    "stage_assignment",
    "zero1_bucket_plan",
]
