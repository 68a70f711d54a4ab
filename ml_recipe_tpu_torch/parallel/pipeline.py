"""Pipeline parallelism over the ``pipe`` mesh axis, GPipe and 1F1B (the
port of ``ml_recipe_tpu/parallel/pipeline.py``).

The encoder's layers split into K equal contiguous stages
(:func:`stage_assignment`); stage k is the rank at ``pipe_index`` k of a
``pipe`` group (``parallel/mesh.py``). The embeddings go with stage 0, the
pooler, the heads and the loss with stage K-1. The ``batch_split``
micro-batches of a step stream through the stages: stage k runs its layers
on micro-batch i's activations from stage k-1 and sends its output on to
stage k+1 (``parallel.collectives.StageTransport``); the backward sends
each activation's gradient back the same way. Every rank of a ``pipe``
group holds the same rows (its data coordinate's), so only the hidden
states cross between stages.

Two schedules (:func:`stage_schedule`), the JAX package's
``--pipe_schedule``:

- ``gpipe``: every micro-batch's forward, then the backward
  (``make_pipeline_encoder``). All m micro-batches' activations are held;
- ``1f1b``: after ``min(K-k-1, m)`` warm-up forwards, one forward and one
  backward in turn, then the remaining backwards
  (``make_pipeline_train_step``). A stage holds at most ``K - k`` of them,
  within the JAX schedule's window ``W = min(m, 2K-1)``.

Both run each micro-batch's backward in micro-batch order, so the two
schedules accumulate the same gradients in the same order: their steps
are bit for bit equal. The port keeps each in-flight micro-batch's autograd
graph instead of JAX's recompute from the saved stage input.

Dropout: each micro-batch and layer has a generator of its own, seeded
from ``(seed, step, micro-batch, slot)`` with slot 0 the embeddings, 1 + i
layer i and 1 + L the classifier (the JAX pipeline's
``fold_in(fold_in(key, micro), 1 + layer)``). With data parallelism each
mask is drawn at the global micro-batch's shape and a rank keeps its rows,
so the draws are a function of (seed, step, data index, micro-batch,
layer): both schedules draw the same masks, and a resume draws what the
uninterrupted run draws. A pipe run does not draw what a one-stage run
draws (neither does the JAX package's).

Stage-local state (``--pipe_param_sharding``, :class:`StageLayout`):
``stage`` keeps on each rank only its stage's parameters (the others are
shape-only ``meta`` tensors) and their optimizer moments; ``replicated``
keeps every parameter on every rank and, after each update, broadcasts
each stage's updated parameters over the ``pipe`` group; each stage's
optimizer updates its own leaves in both. ``auto`` is ``stage`` when pipe
> 1. The JAX package's stage layout instead splits every stage-scope leaf
over the pipe ranks; :meth:`StageLayout.pieces` writes a checkpoint in
that geometry, so a save reads the same in both packages.

Tensor parallelism inside a stage (``pipe:K,model:T``, the JAX package's
``pipe x model``): each stage runs its layers on a rank's heads and MLP
columns (``models/encoder.py``) over its own ``model`` group; stage k's
model rank j hands its activations to stage k+1's model rank j (the
``pipe`` group of a rank holds the ranks of its data and model index).
A model group's ranks run one schedule in one order, so they make the
same all-reduces in the same order, forward and backward. The dropout
streams are the ones above on every rank of the group (a rank's heads
draw their global heads' attention masks, ``ops/attention.model_row_seeds``),
so ``pipe:K,model:T`` draws ``pipe:K``'s masks. :class:`StageLayout` plans
on the whole leaves, the ``model`` dimension claimed first (the JAX
``stage_param_specs``), and cuts a rank's ``model`` slice into the stage
layout's pieces.

Schedule accounting: :func:`modeled_bubble_fraction` and
:func:`measured_bubble_fractions` are the JAX package's (``(K-1)/(K-1+m)``
for GPipe, ``(2K-2)/(2K-2+m)`` for 1F1B over its combined tick program).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import MODEL_AXIS, PIPE_AXIS
from .sharding import (
    STAGE_SCOPE_RE,
    LocalPiece,
    _path_str,
    _walk,
    _zero_leaf_plan,
)

PIPE_SCHEDULES = ("gpipe", "1f1b")
PIPE_PARAM_LAYOUTS = ("auto", "stage", "replicated")


# -- schedule accounting (the JAX package's, line for line) --------------------

def _schedule_overhead_ticks(stages: int, schedule: str) -> int:
    """Idle ticks a stage sees beyond its m useful ones: ``K-1`` for GPipe's
    forward program, ``2(K-1)`` for 1F1B's forward+backward program."""
    if schedule not in PIPE_SCHEDULES:
        raise ValueError(f"unknown pipe schedule {schedule!r}; choose one of "
                         f"{PIPE_SCHEDULES}")
    return (stages - 1) if schedule == "gpipe" else 2 * (stages - 1)


def modeled_bubble_fraction(stages: int, microbatches: int,
                            schedule: str = "gpipe") -> float:
    """The fraction of schedule ticks a stage idles: ``(K-1)/(K-1+m)``
    (GPipe), ``(2K-2)/(2K-2+m)`` (1F1B); 0 for a single stage."""
    stages = int(stages)
    microbatches = max(1, int(microbatches))
    c = _schedule_overhead_ticks(stages, schedule)
    if stages <= 1:
        return 0.0
    return c / (c + microbatches)


def measured_bubble_fractions(step_times: Mapping[int, float], stages: int,
                              schedule: str = "gpipe") -> Dict[int, float]:
    """The bubble per micro-batch count of a step-time sweep: each ``T(m)``
    estimates the ideal step as ``T(m) * m / (m + c)``, their median is
    the reference, and ``1 - ideal / T(m)`` the measured bubble."""
    stages = int(stages)
    c = _schedule_overhead_ticks(max(stages, 1), schedule)
    if stages <= 1 or not step_times:
        return {int(m): 0.0 for m in step_times}
    ideal = float(np.median([t * m / (m + c) for m, t in step_times.items()]))
    return {int(m): max(0.0, 1.0 - ideal / float(t))
            for m, t in step_times.items()}


def stage_layer_count(num_layers: int, stages: int) -> int:
    """Layers per stage; the stack must split into K equal stages."""
    stages = int(stages)
    if stages < 1:
        raise ValueError(f"pipe axis size must be >= 1, got {stages}")
    if num_layers % stages != 0:
        raise ValueError(
            f"--mesh pipe:{stages} needs the encoder depth to split into "
            f"equal contiguous stages, but {num_layers} layers % {stages} "
            f"!= 0; choose a pipe size dividing num_layers")
    return num_layers // stages


def validate_pipeline_plan(plan, model, *, batch_split: int,
                           schedule: str = "gpipe") -> None:
    """Refuse, at construction, what the pipeline does not run: a model
    without layers, a depth the pipe size does not divide, an unknown
    schedule, a ``seq`` axis beside ``pipe`` (``mesh.refuse_unported_axes``
    words it) and a ``batch_split`` below 1."""
    cfg = getattr(model, "cfg", None)
    if cfg is None or not hasattr(cfg, "num_layers"):
        raise ValueError("pipeline parallelism needs a layered encoder model "
                         "(model.cfg.num_layers); got a model without one")
    stage_layer_count(cfg.num_layers, plan.pipe_size)
    if schedule not in PIPE_SCHEDULES:
        raise ValueError(f"--pipe_schedule must be one of {PIPE_SCHEDULES}, "
                         f"got {schedule!r}")
    if plan.seq_size > 1:
        from .mesh import refuse_unported_axes

        refuse_unported_axes(plan.describe())
    if batch_split < 1:
        raise ValueError(f"batch_split must be >= 1, got {batch_split}")


def stage_assignment(num_layers: int, stages: int) -> Dict[int, tuple]:
    """``{stage: (first_layer, last_layer_exclusive)}``."""
    S = stage_layer_count(num_layers, stages)
    return {k: (k * S, (k + 1) * S) for k in range(int(stages))}


def stage_map(num_layers: int, stages: int) -> Dict[str, str]:
    """``{"stage_k": "layer_lo..layer_hi"}`` (the JAX plan's ``stage_map``):
    empty without a multi-way pipe axis."""
    if stages <= 1:
        return {}
    return {f"stage_{k}": f"layer_{lo}..layer_{hi - 1}"
            for k, (lo, hi) in stage_assignment(num_layers, stages).items()}


def stage_param_bytes(params: dict, *, pipe_size: int,
                      model_size: int = 1) -> dict:
    """Modeled bytes of a flax-named parameter tree (``to_jax_params`` of
    the port's weights, whole leaves) under the JAX package's stage layout:
    ``replicated_bytes`` (every leaf whole), ``per_chip_bytes`` (stage-scope
    leaves over their ``pipe`` dimension and, with ``model_size`` > 1, the
    tensor-parallel leaves over their ``model`` dimension, the rest whole)
    and ``per_stage_bytes`` (``{stage: bytes}`` in the ownership view: the
    embeddings with stage 0, each layer with its owner, the pooler and the
    heads with stage K-1)."""
    pipe_size = max(1, int(pipe_size))
    model_size = max(1, int(model_size))
    num_layers = len([k for k in params.get("transformer", {})
                      if k.startswith("layer_")])
    owners = {}
    if num_layers and pipe_size > 1:
        for k, (lo, hi) in stage_assignment(num_layers, pipe_size).items():
            for li in range(lo, hi):
                owners[f"layer_{li}"] = k
    replicated = per_chip = 0
    per_stage = {k: 0 for k in range(pipe_size)}
    for path, leaf in _walk(params):
        shape = tuple(np.shape(leaf))
        dtype = np.dtype(getattr(leaf, "dtype", np.float32))
        full = int(np.prod(shape or (1,), dtype=np.int64)) * dtype.itemsize
        replicated += full
        spec = _zero_leaf_plan(path, shape, data_size=1, min_size=0,
                               pipe_size=pipe_size,
                               model_size=model_size).spec
        shard = full
        for ax in spec:
            if ax == PIPE_AXIS:
                shard //= pipe_size
            elif ax == MODEL_AXIS:
                shard //= model_size
        per_chip += shard
        path_s = _path_str(path)
        m = re.search(r"(^|/)transformer/(layer_\d+)(/|$)", path_s)
        if m and m.group(2) in owners:
            per_stage[owners[m.group(2)]] += full
        elif STAGE_SCOPE_RE.search(path_s):
            per_stage[0] += full
        else:
            per_stage[pipe_size - 1] += full
    return {"pipe_size": pipe_size, "replicated_bytes": int(replicated),
            "per_chip_bytes": int(per_chip),
            "per_stage_bytes": {k: int(v) for k, v in per_stage.items()}}


# -- stage ownership and storage ---------------------------------------------

def param_stage(name: str, num_layers: int, stages: int) -> int:
    """The stage owning the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "transformer" and parts[1] == "embeddings":
        return 0
    if parts[0] == "transformer" and parts[1].startswith("layer_"):
        return int(parts[1][len("layer_"):]) // stage_layer_count(
            num_layers, stages)
    return stages - 1


def resolve_param_layout(value, pipe_size: int) -> str:
    """``--pipe_param_sharding`` as ``'stage'`` or ``'replicated'``
    (``auto``: ``stage`` when pipe > 1), the JAX trainer's spellings
    ``on``/``off`` included; raises on anything else."""
    v = "auto" if value is None else str(value).strip().lower()
    v = {"on": "stage", "off": "replicated"}.get(v, v)
    if v not in PIPE_PARAM_LAYOUTS:
        raise ValueError(f"--pipe_param_sharding must be one of "
                         f"auto|stage|replicated, got {value!r}")
    if v == "auto":
        v = "stage" if pipe_size > 1 else "replicated"
    return v


class StageLayout:
    """This rank's stage of a ``K``-stage pipeline over ``model``: ``index``
    (``pipe_index``), its layer range ``lo .. hi - 1``, the parameters it
    owns (``owned``), and ``layout`` (``'stage'`` or ``'replicated'``,
    :func:`resolve_param_layout`). ``split``: the rank's
    ``parallel.sharding.ModelSplit`` under a ``model`` axis (the stage runs
    its layers on a rank's heads and MLP columns), else None. ``shapes``
    are the rank's own tensors' shapes (a ``model`` slice's), ``whole``
    the whole leaves' (what the JAX stage layout plans).
    :meth:`release` turns the parameters of other stages into shape-only
    ``meta`` tensors under ``stage``."""

    def __init__(self, model, *, stages: int, index: int, layout: str,
                 split=None):
        self.K, self.index, self.layout = int(stages), int(index), layout
        self.split = split
        self.num_layers = int(model.cfg.num_layers)
        self.lo, self.hi = stage_assignment(self.num_layers, self.K)[index]
        self.first, self.last = index == 0, index == self.K - 1
        self.shapes = {n: tuple(p.shape)
                       for n, p in model.named_parameters()}
        self.whole = (dict(self.shapes) if split is None else
                      {n: split.whole_shape(n, s)
                       for n, s in self.shapes.items()})
        self.owner = {n: param_stage(n, self.num_layers, self.K)
                      for n in self.shapes}
        self.owned = [n for n in self.shapes if self.owner[n] == index]

    @property
    def model_size(self) -> int:
        return 1 if self.split is None else self.split.size

    def owns(self, name: str) -> bool:
        return self.owner[name] == self.index

    def release(self, model) -> None:
        """Under ``stage``, replace every parameter of another stage by a
        ``meta`` tensor of its shape (under a ``model`` axis, of the rank's
        slice): the rank stores only its stage."""
        if self.layout != "stage":
            return
        for name, module in list(model.named_modules()):
            for pname, p in list(module._parameters.items()):
                full = f"{name}.{pname}" if name else pname
                if p is not None and not self.owns(full):
                    module._parameters[pname] = torch.nn.Parameter(
                        torch.empty(p.shape, dtype=p.dtype, device="meta"),
                        requires_grad=p.requires_grad)

    def pipe_dim(self, name: str) -> Optional[int]:
        """The flax dimension the JAX stage layout splits over ``pipe`` for
        parameter ``name`` (None: not a stage-scope leaf, or no dimension
        the pipe size divides, or the replicated layout): planned on the
        whole leaf, its ``model`` dimension claimed first, as the JAX
        ``stage_param_specs`` plans it."""
        if self.layout != "stage":
            return None
        from ..models.convert import jax_path
        from .sharding import flax_shape

        spec = _zero_leaf_plan(jax_path(name),
                               flax_shape(name, self.whole[name]),
                               data_size=1, min_size=0, pipe_size=self.K,
                               model_size=self.model_size).spec
        return spec.index(PIPE_AXIS) if PIPE_AXIS in spec else None

    def pieces(self, name: str, piece: LocalPiece) -> List[LocalPiece]:
        """``piece`` (this rank's part of a leaf, flax orientation: the
        whole leaf, a ``model`` slice or a ZeRO-1 slice, bounded in the
        whole leaf) cut into the JAX stage layout's pieces: ``K`` equal
        parts along the leaf's pipe dimension (which neither the ``model``
        nor the ``data`` axis takes), each counted as ``K`` times as many
        shards."""
        dim = self.pipe_dim(name)
        if dim is None:
            return [piece]
        a, b = piece.bounds[dim]
        step = (b - a) // self.K
        out = []
        for j in range(self.K):
            bounds = tuple((a + j * step, a + (j + 1) * step) if i == dim
                           else ab for i, ab in enumerate(piece.bounds))
            data = np.take(piece.data, range(j * step, (j + 1) * step),
                           axis=dim)
            out.append(LocalPiece(piece.shape, bounds,
                                  np.ascontiguousarray(data),
                                  piece.shards * self.K, piece.owner))
        return out


def step_generator(seed: int, step: int, micro: int, slot: int,
                   device) -> torch.Generator:
    """Micro-batch ``micro``'s generator of ``slot`` (0 the embeddings,
    1 + i layer i, 1 + L the classifier) at optimizer step ``step``."""
    state = np.random.SeedSequence(
        [int(seed), int(step), int(micro), int(slot)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(state) & ((1 << 63) - 1))


# -- the schedules -----------------------------------------------------------

def stage_schedule(schedule: str, stages: int, index: int,
                   microbatches: int) -> List[Tuple[str, int]]:
    """Stage ``index``'s ordered units: ``("F", i)`` micro-batch i's forward,
    ``("B", i)`` its backward. GPipe: every forward, then every backward;
    1F1B: ``min(K - k - 1, m)`` warm-up forwards, then a forward and a
    backward in turn, then the remaining backwards."""
    m = int(microbatches)
    if schedule == "gpipe":
        return [("F", i) for i in range(m)] + [("B", i) for i in range(m)]
    if schedule != "1f1b":
        raise ValueError(f"unknown pipe schedule {schedule!r}; choose one of "
                         f"{PIPE_SCHEDULES}")
    warm = min(int(stages) - int(index) - 1, m)
    ops = [("F", i) for i in range(warm)]
    for i in range(m - warm):
        ops += [("F", warm + i), ("B", i)]
    ops += [("B", i) for i in range(m - warm, m)]
    return ops


def max_in_flight(ops: Sequence[Tuple[str, int]]) -> int:
    """The most micro-batches a schedule holds between forward and
    backward."""
    held = peak = 0
    for kind, _ in ops:
        held += 1 if kind == "F" else -1
        peak = max(peak, held)
    return peak


class PipelineStep:
    """One stage's run of a step's micro-batches on a schedule.

    ``forward(i, h)`` runs micro-batch i's stage forward from the received
    activations ``h`` (None on stage 0) and returns its output: the hidden
    states to send on, or on the last stage the scalar to differentiate.
    ``shape(i)`` is the activations' shape, ``dtype`` and ``device`` their
    type. The step receives, sends, and differentiates; ``in_flight`` is
    the most micro-batches it held at once."""

    def __init__(self, layout: StageLayout, transport, *,
                 schedule: str, dtype, device):
        self.layout, self.transport = layout, transport
        self.schedule, self.dtype, self.device = schedule, dtype, device
        self.in_flight = 0

    def run(self, microbatches: int, forward: Callable,
            shape: Callable[[int], Sequence[int]], *,
            train: bool = True) -> list:
        """Every micro-batch through this stage; returns the last stage's
        outputs in micro-batch order (empty elsewhere). ``train=False``
        runs the forwards alone, under the caller's grad mode."""
        lay, tr = self.layout, self.transport
        ops = (stage_schedule(self.schedule, lay.K, lay.index, microbatches)
               if train else [("F", i) for i in range(microbatches)])
        if train:
            self.in_flight = max(self.in_flight, max_in_flight(ops))
        saved: Dict[int, tuple] = {}
        outputs: Dict[int, object] = {}
        for kind, i in ops:
            if kind == "F":
                h = None
                if not lay.first:
                    h = tr.recv_forward(shape(i), self.dtype, self.device)
                    if train:
                        h.requires_grad_(True)
                y = forward(i, h)
                if not lay.last:
                    tr.send_forward(y)
                else:
                    outputs[i] = y
                if train:
                    saved[i] = (h, y)
                continue
            h, y = saved.pop(i)
            if lay.last:
                y.backward()
            else:
                y.backward(tr.recv_backward(shape(i), self.dtype,
                                            self.device))
            if not lay.first:
                tr.send_backward(h.grad)
        tr.drain()
        return [outputs[i] for i in sorted(outputs)]


def shape_tree(shapes: Mapping[str, Sequence[int]]) -> dict:
    """The flax-named tree of the port's parameter ``shapes`` (name ->
    tensor shape), each leaf a zero-stride f32 array of the flax shape: what
    :func:`stage_param_bytes` reads, with no parameter in memory."""
    from ..models.convert import jax_path
    from .sharding import flax_shape

    tree: dict = {}
    for name, shape in shapes.items():
        *parents, leaf = jax_path(name)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.broadcast_to(np.float32(0), flax_shape(name, shape))
    return tree
