"""The parallelism plan (the port of ``ml_recipe_tpu/parallel/plan.py``):
one object every layout derives from. The trainer reads its axis sizes,
ZeRO-1 layout and ``describe()``, which checkpoints record as
``mesh_axes`` (the JAX package's spelling, so a checkpoint names the
topology that wrote it in both packages). Under ``--elastic on``
:meth:`ParallelPlan.elastic_from_spec` builds the mesh over the live
processes, narrowing the requested ``data`` axis, and records the request
(``requested_axes``, ``shrunk``). With a ``pipe`` axis it names each
stage's layers (:meth:`ParallelPlan.stage_map`) and plans ZeRO-1 within a
stage's leaves (``zero1(..., stage_pipe=True)``, the JAX plan's); with a
``model`` axis it plans ZeRO-1 under the tensor-parallel rules, ``model``
first, as the JAX plan does; with both, ``model``, then ``pipe``, then
``data`` (``pipe:2,model:2``, ``data:2,pipe:2,model:2``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

from . import dist as pdist
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    MeshSpec,
    build_mesh,
    elastic_axes,
)
from .sharding import MIN_SIZE, ParamSlice, zero1_param_plan


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    mesh: Mesh
    # the axes the operator asked for (--mesh), recorded by
    # elastic_from_spec so `shrunk` can report a topology change; None for
    # plans of the fixed-world constructors
    requested_axes: Optional[Dict[str, int]] = None

    @classmethod
    def from_mesh(cls, mesh: Mesh) -> "ParallelPlan":
        return cls(mesh=mesh)

    @classmethod
    def from_spec(cls, spec: Optional[str] = None) -> "ParallelPlan":
        return cls(mesh=build_mesh(spec))

    @classmethod
    def elastic_from_spec(cls, spec: Optional[str] = None, *,
                          n_devices: Optional[int] = None,
                          min_data: int = 1) -> "ParallelPlan":
        """:meth:`from_spec` that SHRINKS instead of raising when the
        requested mesh no longer fits the live processes
        (``n_devices``, by default the joined world's size): only the data
        axis narrows (``mesh.elastic_axes``). Every process of the world
        must call it, as :func:`~.mesh.build_mesh`."""
        n = int(n_devices if n_devices is not None
                else pdist.process_count())
        requested = MeshSpec.from_string(spec, n_devices=n).ordered()
        axes = elastic_axes(requested, n, min_data=min_data)
        return cls(mesh=build_mesh(axes=axes), requested_axes=dict(requested))

    @property
    def shrunk(self) -> bool:
        """True when this plan was elastically narrowed below the requested
        topology (always False for fixed-world plans)."""
        return (self.requested_axes is not None
                and self.requested_axes != self.describe())

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
    def pipe_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    @property
    def model_size(self) -> int:
        return self.axis_size(MODEL_AXIS)

    @property
    def single_device(self) -> bool:
        return self.mesh.world == 1

    def describe(self) -> Dict[str, int]:
        """``{axis: size}`` in mesh order."""
        return self.mesh.describe()

    def stage_map(self, num_layers: int) -> Dict[str, str]:
        """``{"stage_k": "layer_lo..layer_hi"}``; empty without a pipe
        axis > 1."""
        from .pipeline import stage_map

        return stage_map(int(num_layers), self.pipe_size)

    def zero1(self, named_shapes: Iterable[Tuple[str, Sequence[int]]], *,
              min_size: int = MIN_SIZE,
              stage_pipe: bool = False) -> Dict[str, ParamSlice]:
        """The per-parameter ZeRO-1 placement over the ``data`` axis of the
        parameters' whole shapes; a ``model`` axis claims the
        tensor-parallel rules' dimensions first, then with ``stage_pipe``
        the ``pipe`` axis its stage-scope dimension, so ``data`` is
        planned within a stage's leaves on what is left."""
        return zero1_param_plan(
            named_shapes, data_size=self.data_size, min_size=min_size,
            pipe_size=self.pipe_size if stage_pipe else 1,
            model_size=self.model_size)
