"""The parallelism plan (the port of ``ml_recipe_tpu/parallel/plan.py``):
one object every layout derives from. The trainer reads its axis sizes,
ZeRO-1 layout and ``describe()``, which checkpoints record as
``mesh_axes`` (the JAX package's spelling, so a checkpoint names the
topology that wrote it in both packages)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh
from .sharding import MIN_SIZE, ParamSlice, zero1_param_plan


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    mesh: Mesh

    @classmethod
    def from_mesh(cls, mesh: Mesh) -> "ParallelPlan":
        return cls(mesh=mesh)

    def axis_size(self, name: str) -> int:
        """An axis's size; 1 when the mesh lacks it."""
        return self.mesh.axis_size(name)

    @property
    def data_size(self) -> int:
        return self.axis_size(DATA_AXIS)

    @property
    def seq_size(self) -> int:
        return self.axis_size(SEQ_AXIS)

    @property
    def single_device(self) -> bool:
        return self.mesh.world == 1

    def describe(self) -> Dict[str, int]:
        """``{axis: size}`` in mesh order."""
        return self.mesh.describe()

    def zero1(self, named_shapes: Iterable[Tuple[str, Sequence[int]]], *,
              min_size: int = MIN_SIZE) -> Dict[str, ParamSlice]:
        """The per-parameter ZeRO-1 placement over the ``data`` axis."""
        return zero1_param_plan(named_shapes, data_size=self.data_size,
                                min_size=min_size)
