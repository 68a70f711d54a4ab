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
``data:2,model:2``), by default one ``data`` axis over the whole world.
Ranks follow the JAX package's axis order :data:`AXIS_ORDER` (its device
array is reshaped in that order, ``pipe`` outermost, ``model`` innermost),
so with ``pipe:K,data:D,seq:S,model:T`` rank ``r`` sits at ``pipe_index =
r // (D*S*T)``, ``data_index = r // (S*T) % D``, ``seq_index = r // T %
S``, ``model_index = r % T``: the data coordinate, which picks a rank's
rows of every global batch and folds into its dropout seeds, is the one
the JAX package gives the same device, and a model group's ranks are
neighbours. ``pipe`` with ``seq`` raises, as in the JAX package
(``parallel/pipeline.validate_pipeline_plan``), and so does a ``model``
axis beside ``pipe`` or ``seq`` (the port's tensor-parallel layers do not
run inside a pipeline stage or a ring hop yet).
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

import torch.distributed as dist

from . import dist as pdist
from .collectives import ModelTransport, RingTransport, StageTransport

logger = logging.getLogger(__name__)

# pipe outermost, then data, seq, model innermost (the JAX package's order)
AXIS_ORDER = ("pipe", "data", "seq", "model")
DATA_AXIS, SEQ_AXIS, PIPE_AXIS, MODEL_AXIS = "data", "seq", "pipe", "model"
PORTED_AXES = (DATA_AXIS, SEQ_AXIS, PIPE_AXIS, MODEL_AXIS)
_PARALLEL = "queue 1, 'Parallelism beyond data parallelism'"
# the items of that queue a refused composition waits for
_PIPE_MODEL = f"{_PARALLEL}, item 'pipe x model'"
_SEQ_MODEL = f"{_PARALLEL}, item 'seq x model'"


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
    ``pipe`` > 1 or ``seq`` > 1, whose compositions wait for their own
    ROADMAP items."""
    bad = [name for name in axes if name not in PORTED_AXES]
    if bad:
        raise NotImplementedError(
            f"mesh axes {bad} are not ported yet (the port runs 'data', "
            f"'seq', 'pipe' and 'model'): ROADMAP.md {_PARALLEL}")
    if MODEL_AXIS in axes:
        for other, item in ((PIPE_AXIS, _PIPE_MODEL), (SEQ_AXIS, _SEQ_MODEL)):
            if axes.get(other, 1) > 1:
                raise NotImplementedError(
                    f"--mesh with both {other} and model axes is not "
                    f"composable in the port yet: the tensor-parallel "
                    f"layers would have to run inside "
                    f"{'a pipeline stage' if other == PIPE_AXIS else 'a ring hop'}"
                    f", as in the JAX package; ROADMAP.md {item}")
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
    those of its ``seq`` ring (same data index), ``pipe_group`` those of
    its pipeline (same data index), ``model_group`` those of its ``model``
    group (same data index; ``model_ranks`` their global ranks), in
    coordinate order; a group is None (the whole world, or a group of one)
    when the other axes have size 1. ``model_transport`` is the model
    group's all-reduce (``parallel.collectives.ModelTransport``) when
    ``model`` is > 1.
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
    same order as its peers, since it creates the process groups."""
    mesh_spec = (MeshSpec(dict(axes)) if axes is not None
                 else MeshSpec.from_string(spec))
    ordered = mesh_spec.ordered()
    refuse_unported_axes(ordered)
    world, rank = pdist.process_count(), pdist.process_index()
    if mesh_spec.size != world:
        raise ValueError(
            f"mesh {ordered} needs {mesh_spec.size} processes (one per "
            f"device); the world has {world} (--dist_world_size)")
    K = ordered.get(PIPE_AXIS, 1)
    D, S = ordered.get(DATA_AXIS, 1), ordered.get(SEQ_AXIS, 1)
    T = ordered.get(MODEL_AXIS, 1)
    mesh = Mesh(axes=ordered, rank=rank, world=world,
                seq_ranks=tuple(range(rank - rank % S, rank - rank % S + S)),
                model_ranks=tuple(range(rank - rank % T,
                                        rank - rank % T + T)))
    row = D * S * T             # the ranks of one pipeline stage
    mesh.pipe_ranks = tuple(range(rank % row, world, row))
    if D > 1 and (S > 1 or K > 1 or T > 1):   # other axes of 1: WORLD
        mesh.data_group = _groups(
            [list(range(k * row + j, (k + 1) * row, S * T))
             for k in range(K) for j in range(S * T)], rank)
    if D > 1 and S > 1:
        mesh.seq_group = _groups(
            [list(range(d * S, d * S + S)) for d in range(D)], rank)
    if D > 1 and T > 1:
        mesh.model_group = _groups(
            [list(range(d * T, d * T + T)) for d in range(D)], rank)
    if S > 1:
        mesh.ring = RingTransport(mesh.seq_ranks, rank)
    if T > 1:
        mesh.model_transport = ModelTransport(mesh.model_ranks, rank,
                                              mesh.model_group)
    if K > 1:
        if D > 1:
            mesh.pipe_group = _groups(
                [list(range(i, world, row)) for i in range(row)], rank)
        mesh.stage = StageTransport(mesh.pipe_ranks, rank)
    logger.info("Built process mesh %s: rank %d at data %d, seq %d%s%s.",
                ordered, rank, mesh.data_index, mesh.seq_index,
                f", pipe {mesh.pipe_index}" if K > 1 else "",
                f", model {mesh.model_index}" if T > 1 else "")
    return mesh
