"""The process mesh (the port of ``ml_recipe_tpu/parallel/mesh.py``).

The JAX package builds one named ``jax.sharding.Mesh`` over every device;
the port runs one process per device, so its mesh is the world of
``torch.distributed`` ranks laid out on named axes, with a process group
for every row of each axis the step reduces or rotates over:

- ``data``: data parallelism (batch rows; gradients reduce over it, ZeRO-1
  shards the optimizer state over it);
- ``seq``: sequence parallelism (each rank of a ``seq`` group holds one
  contiguous block of every row's tokens; ring attention rotates K/V blocks
  around the group);
- ``pipe``: pipeline parallelism (each rank of a ``pipe`` group is one
  stage, a contiguous range of the encoder's layers; activations go
  forward and their gradients back between neighbouring stages,
  ``parallel/pipeline.py``);
- ``model``: tensor parallelism (each rank of a ``model`` group holds
  ``1/T`` of every layer's attention heads and MLP columns, the JAX
  package's Megatron-style ``TP_RULES``; the group all-reduces each
  attention and MLP block's output, ``parallel/collectives.py``
  ``reduce_from_model``, and their inputs' gradients, ``copy_to_model``).

Axis sizes come from ``--mesh`` (``data:2,seq:2``, ``data:2,pipe:2``,
``data:2,model:2``, ``pipe:2,model:2``, ``data:2,pipe:2,model:2``), by
default one ``data`` axis over the whole world. Ranks follow the JAX
package's axis order :data:`AXIS_ORDER` (its device array is reshaped in
that order, ``pipe`` outermost, ``model`` innermost), so with
``pipe:K,data:D,seq:S,model:T`` rank ``r`` sits at ``pipe_index = r //
(D*S*T)``, ``data_index = r // (S*T) % D``, ``seq_index = r // T % S``,
``model_index = r % T``: the data coordinate, which picks a rank's rows of
every global batch and folds into its dropout seeds, is the one the JAX
package gives the same device, and a model group's ranks are neighbours.
:func:`mesh_groups` lists every group of every axis in that order; each
rank creates all of them, and a pipeline stage's ``model`` group is its
own (a stage runs the tensor-parallel layers over it). ``pipe`` with
``seq`` raises, as in the JAX package
(``parallel/pipeline.validate_pipeline_plan``), and so does a ``model``
axis beside ``seq`` (the port's ring hops do not run a rank's heads yet).
Where the JAX package warns about devices a mesh leaves idle, the port
requires the mesh to cover the world exactly. Under ``--elastic on``
:func:`elastic_axes` shrinks a requested mesh onto the live processes
(only ``data`` narrows).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from . import dist as pdist
from .collectives import ModelTransport, RingTransport, StageTransport

logger = logging.getLogger(__name__)

# pipe outermost, then data, seq, model innermost (the JAX package's order)
AXIS_ORDER = ("pipe", "data", "seq", "model")
DATA_AXIS, SEQ_AXIS, PIPE_AXIS, MODEL_AXIS = "data", "seq", "pipe", "model"
PORTED_AXES = (DATA_AXIS, SEQ_AXIS, PIPE_AXIS, MODEL_AXIS)
_PARALLEL = "queue 1, 'Parallelism beyond data parallelism'"
# the item of that queue a refused composition waits for
_SEQ_MODEL = f"{_PARALLEL}, item 'seq x model'"
# the ranks of one pipeline stage (every rank with its pipe index), a
# group of mesh_groups beside the axes'
STAGE = "stage"


def parse_mesh_spec(spec: Optional[str]) -> Dict[str, int]:
    """``"data:2,seq:2"`` (or ``data=2,seq=2``) as an ordered dict; raises
    on a malformed entry, a duplicate axis or a size below 1, naming the
    spec (the JAX package's ``parse_mesh_spec``)."""
    if not spec:
        return {}
    axes: Dict[str, int] = {}
    for part in str(spec).replace("=", ":").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, size_s = part.partition(":")
        name = name.strip()
        if not name or not sep or not size_s.strip():
            raise ValueError(f"mesh spec {spec!r}: malformed entry {part!r} "
                             f"(expected 'axis:size')")
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(f"mesh spec {spec!r}: axis {name!r} has "
                             f"non-integer size {size_s.strip()!r}") from None
        if name in axes:
            raise ValueError(f"mesh spec {spec!r}: duplicate axis {name!r}")
        if size < 1:
            raise ValueError(f"mesh spec {spec!r}: axis {name!r} size must "
                             f"be >= 1, got {size}")
        axes[name] = size
    return axes


def refuse_unported_axes(axes: Dict[str, int]) -> None:
    """Raise on an axis other than ``data``, ``seq``, ``pipe`` and
    ``model``, naming the ROADMAP item; on ``pipe`` > 1 beside ``seq`` > 1,
    which the JAX package refuses too; and on a ``model`` axis beside
    ``seq`` > 1, whose composition waits for its own ROADMAP item."""
    bad = [name for name in axes if name not in PORTED_AXES]
    if bad:
        raise NotImplementedError(
            f"mesh axes {bad} are not ported yet (the port runs 'data', "
            f"'seq', 'pipe' and 'model'): ROADMAP.md {_PARALLEL}")
    if MODEL_AXIS in axes and axes.get(SEQ_AXIS, 1) > 1:
        raise NotImplementedError(
            "--mesh with both seq and model axes is not composable in the "
            "port yet: the tensor-parallel heads would have to run inside "
            f"a ring hop, as in the JAX package; ROADMAP.md {_SEQ_MODEL}")
    if axes.get(PIPE_AXIS, 1) > 1 and axes.get(SEQ_AXIS, 1) > 1:
        raise NotImplementedError(
            "--mesh with both seq and pipe axes is not composable yet: the "
            "ring attention's hops would have to run inside a pipeline "
            "stage's forward and backward, as in the JAX package "
            f"(parallel/pipeline.validate_pipeline_plan); ROADMAP.md "
            f"{_PARALLEL}")


def check_model_split(num_heads: int, intermediate_size: int,
                      model_size: int) -> None:
    """Raise unless a ``model`` axis of ``model_size`` divides the heads and
    the MLP's intermediate columns: every rank of a group holds an equal
    slice of both (uneven splits are not ported)."""
    if model_size > 1 and (num_heads % model_size
                           or intermediate_size % model_size):
        raise NotImplementedError(
            f"a model axis of {model_size} does not divide the encoder's "
            f"{num_heads} heads and {intermediate_size} MLP columns; uneven "
            f"tensor-parallel splits are not ported: ROADMAP.md {_PARALLEL}")


class ElasticMeshError(ValueError):
    """A requested mesh cannot be re-derived over the live device set —
    a STRUCTURAL axis (pipe/seq/model) would have to change size."""


def elastic_axes(axes: Dict[str, int], n_devices: int, *,
                 min_data: int = 1) -> Dict[str, int]:
    """Shrink a requested axes dict onto ``n_devices`` live devices (the
    JAX package's ``elastic_axes``; in the port a device is a process).

    Only the DATA axis shrinks: ``seq`` (and the JAX package's ``pipe`` and
    ``model``) groups hold disjoint shards, so changing their sizes changes
    what each device OWNS, which the crop/zero-fill checkpoint
    reconciliation cannot express. The data axis only replicates:
    narrowing it keeps every parameter whole and reshapes the ZeRO-1
    optimizer slices, which a restore crops or zero-fills. Refusals are
    loud and specific."""
    requested = dict(axes)
    total = math.prod(requested.values())
    if total <= n_devices:
        return requested
    structural = {k: v for k, v in requested.items() if k != DATA_AXIS}
    fixed = math.prod(structural.values()) if structural else 1
    if fixed > n_devices:
        raise ElasticMeshError(
            f"cannot shrink mesh {requested} onto {n_devices} device(s): "
            f"the structural axes {structural} alone need {fixed} devices. "
            f"Only the data axis shrinks elastically — pipe/seq/model "
            f"change what each device OWNS (layer/tensor shards), which "
            f"checkpoint reconciliation cannot re-derive. Relaunch with a "
            f"smaller --mesh or restore the lost hosts.")
    new_data = n_devices // fixed
    if new_data < max(1, int(min_data)):
        raise ElasticMeshError(
            f"cannot shrink mesh {requested} onto {n_devices} device(s): "
            f"the data axis would narrow to {new_data}, below the floor of "
            f"{min_data} — training that narrow is degenerate (see "
            f"--min_world).")
    out = {k: (new_data if k == DATA_AXIS else v)
           for k, v in requested.items()}
    logger.warning(
        "ELASTIC: shrinking mesh %s -> %s over %d live device(s) "
        "(data axis %d -> %d; structural axes unchanged).",
        requested, out, n_devices, requested.get(DATA_AXIS, 1), new_data)
    return out


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    axes: Dict[str, int]

    @classmethod
    def from_string(cls, spec: Optional[str],
                    n_devices: Optional[int] = None) -> "MeshSpec":
        axes = parse_mesh_spec(spec)
        if not axes:
            axes = {DATA_AXIS: int(n_devices if n_devices is not None
                                   else pdist.process_count())}
        return cls(axes=axes)

    @property
    def size(self) -> int:
        return math.prod(self.axes.values())

    def ordered(self) -> Dict[str, int]:
        """The axes in :data:`AXIS_ORDER` (any other name after them)."""
        out = {n: self.axes[n] for n in AXIS_ORDER if n in self.axes}
        out.update((n, s) for n, s in self.axes.items() if n not in out)
        return out


@dataclasses.dataclass
class Mesh:
    """This process's place on the mesh, and the groups it talks over.

    ``axes``: ordered ``{name: size}``; ``rank``/``world``: the process's
    rank and the world size. ``data_group`` holds the ranks of this
    process's ``data`` row (same pipe, seq and model index), ``seq_group``
    those of its ``seq`` ring (same pipe, data and model index),
    ``pipe_group`` those of its pipeline (same data, seq and model index),
    ``model_group`` those of its ``model`` group (same pipe, data and seq
    index), each in coordinate order (:func:`mesh_groups`), and
    ``stage_group`` every rank of its pipeline stage (same pipe index); a
    group is None (its collectives run over the world) where it is the
    whole world or its axis has size 1 (then nothing reduces over it;
    ``stage_group`` None: no ``pipe`` axis, the stage is the world, or a
    stage of one rank, over which nothing reduces). The
    ``model`` group exists whenever ``model`` > 1.
    ``model_ranks`` are the model group's global ranks and
    ``model_transport`` its all-reduce
    (``parallel.collectives.ModelTransport``) when ``model`` is > 1.
    ``seq_ranks`` are the global ranks of the ring, ``ring`` its transport
    (``parallel.collectives.RingTransport``) when ``seq`` is > 1;
    ``pipe_ranks`` the global ranks of the pipeline, stage by stage, and
    ``stage`` the transport to the neighbouring stages
    (``parallel.collectives.StageTransport``) when ``pipe`` is > 1."""

    axes: Dict[str, int]
    rank: int = 0
    world: int = 1
    data_group: object = None
    seq_group: object = None
    seq_ranks: Tuple[int, ...] = (0,)
    ring: object = None
    pipe_group: object = None
    pipe_ranks: Tuple[int, ...] = (0,)
    stage: object = None
    model_group: object = None
    model_ranks: Tuple[int, ...] = (0,)
    model_transport: object = None
    stage_group: object = None

    def axis_size(self, name: str) -> int:
        return int(self.axes.get(name, 1))

    @property
    def data_size(self) -> int:
        return self.axis_size(DATA_AXIS)

    @property
    def seq_size(self) -> int:
        return self.axis_size(SEQ_AXIS)

    @property
    def pipe_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    @property
    def model_size(self) -> int:
        return self.axis_size(MODEL_AXIS)

    @property
    def data_index(self) -> int:
        return self.rank // (self.seq_size * self.model_size) % self.data_size

    @property
    def seq_index(self) -> int:
        return self.rank // self.model_size % self.seq_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @property
    def pipe_index(self) -> int:
        return self.rank // (self.data_size * self.seq_size * self.model_size)

    @property
    def data_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this process's ``data`` row, in data
        order."""
        inner = self.seq_size * self.model_size
        base = (self.pipe_index * self.data_size * inner
                + self.rank % inner)
        return tuple(base + d * inner for d in range(self.data_size))

    def describe(self) -> Dict[str, int]:
        return {str(n): int(s) for n, s in self.axes.items()}


def mesh_groups(axes: Dict[str, int]) -> Dict[str, List[List[int]]]:
    """Every group of the mesh ``axes`` (a dict in :data:`AXIS_ORDER`,
    missing axes of size 1), as the JAX package's device array lays them
    out: ``rank = ((pipe*D + data)*S + seq)*T + model``. For each axis of
    size > 1, its groups (the ranks that differ in that coordinate alone,
    in its order), one per index of the other axes, in rank order of their
    first member; with ``pipe`` > 1 and more than one rank a stage also
    :data:`STAGE`, the ranks of each pipeline stage. A pure function: every rank builds the same lists."""
    sizes = [int(axes.get(name, 1)) for name in AXIS_ORDER]
    ranks = np.arange(math.prod(sizes)).reshape(sizes)
    out: Dict[str, List[List[int]]] = {}
    for i, name in enumerate(AXIS_ORDER):
        if sizes[i] > 1:
            out[name] = np.moveaxis(ranks, i, -1).reshape(
                -1, sizes[i]).tolist()
    if sizes[0] > 1 and math.prod(sizes[1:]) > 1:
        out[STAGE] = ranks.reshape(sizes[0], -1).tolist()
    return out


def _groups(ranks_of: List[List[int]], rank: int):
    """``dist.new_group`` for every list in ``ranks_of`` (every process
    creates every group, in one order); returns this rank's group."""
    mine = None
    for ranks in ranks_of:
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def build_mesh(spec: Optional[str] = None, *,
               axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh of ``spec`` (``--mesh``) or ``axes`` over the joined world
    (one process alone outside one); with neither, ``data:W``. Raises when
    the axes do not multiply to the world size or name an unported axis.
    In a world of several processes every process must call it, in the
    same order as its peers, since it creates the process groups: those of
    every axis of size > 1 (:func:`mesh_groups`, in :data:`AXIS_ORDER`,
    then the pipeline stages'), but for an axis whose one group is the
    world (its collectives run over the world); the ``model`` group always,
    the transport's own."""
    mesh_spec = (MeshSpec(dict(axes)) if axes is not None
                 else MeshSpec.from_string(spec))
    ordered = mesh_spec.ordered()
    refuse_unported_axes(ordered)
    world, rank = pdist.process_count(), pdist.process_index()
    if mesh_spec.size != world:
        raise ValueError(
            f"mesh {ordered} needs {mesh_spec.size} processes (one per "
            f"device); the world has {world} (--dist_world_size)")
    mesh = Mesh(axes=ordered, rank=rank, world=world,
                seq_ranks=(rank,), pipe_ranks=(rank,), model_ranks=(rank,))
    for name, ranks_of in mesh_groups(ordered).items():
        if name in (SEQ_AXIS, PIPE_AXIS, MODEL_AXIS):
            setattr(mesh, f"{name}_ranks",
                    next(tuple(g) for g in ranks_of if rank in g))
        if len(ranks_of) > 1 or name == MODEL_AXIS:
            setattr(mesh, f"{name}_group", _groups(ranks_of, rank))
    if mesh.seq_size > 1:
        mesh.ring = RingTransport(mesh.seq_ranks, rank)
    if mesh.model_size > 1:
        mesh.model_transport = ModelTransport(mesh.model_ranks, rank,
                                              mesh.model_group)
    if mesh.pipe_size > 1:
        mesh.stage = StageTransport(mesh.pipe_ranks, rank)
    logger.info("Built process mesh %s: rank %d at data %d, seq %d%s%s.",
                ordered, rank, mesh.data_index, mesh.seq_index,
                f", pipe {mesh.pipe_index}" if mesh.pipe_size > 1 else "",
                f", model {mesh.model_index}" if mesh.model_size > 1
                else "")
    return mesh
