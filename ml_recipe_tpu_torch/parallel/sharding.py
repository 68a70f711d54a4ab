"""ZeRO-1 layout and the sequence split of a batch (the port of the parts of
``ml_recipe_tpu/parallel/sharding.py`` that the optimizer, the checkpoints
and the trainer share).

The JAX package plans every optimizer-state leaf once
(:func:`_zero_leaf_plan`): the ``data`` axis lands on the largest dimension
that the axis size divides, or, when none does, on the largest dimension
zero-padded up to the next multiple; leaves below ``min_size`` elements
(and scalars) stay whole on every device. The stored state has the padded
shape, so a checkpoint written at ``data:N`` holds padded moments, and a
restore crops or zero-fills them onto the live layout. The pad region is
zeros by construction (padded gradients are zero there, so the moments
never leave zero) and never feeds a real element's update.

The plan reads flax shapes (``Dense.kernel`` is ``[in, out]``); the port's
``Linear.weight`` is ``[out, in]``, so :func:`zero1_param_plan` plans each
parameter on its flax shape and maps the axis onto the tensor.

``--zero1_overlap bucketed`` cuts the gradients into contiguous buckets
over the JAX package's leaf order (:func:`tree_order`, :func:`leaf_sizes`,
:func:`zero1_bucket_plan`).

Under a ``pipe`` axis with the stage layout (``--pipe_param_sharding
stage``) the plan runs within each stage's leaf set, as the JAX package's
``stage_pipe`` plan does: a stage-scope leaf (:data:`STAGE_SCOPE_RE`, the
embeddings and the encoder layers) gives its largest dimension that the
pipe size divides to ``pipe`` first (never padded), and ``data`` lands on
the remaining ones. The port stores a stage's leaves whole on the stage's
own ranks, so the ``pipe`` claim shapes the checkpoint's pieces
(``parallel/pipeline.py``) and keeps ``data`` off that dimension.

Under a ``model`` axis (tensor parallelism) the JAX package's
:data:`TP_RULES` split the query, key, value and MLP-intermediate kernels
and biases on their output dimension and the attention-output and
MLP-output kernels on their input dimension; every other leaf stays whole
on each rank. :func:`tp_param_dims` maps each rule onto the port's tensor
(``Linear.weight`` is ``[out, in]``: ``P(None, model)`` slices its rows,
``P(model, None)`` its columns, a sliced bias is ``P(model)``), and
:class:`ModelSplit` holds one rank's place: its slice of a whole leaf and
the gather of the group's slices back into it. The ZeRO-1 plan gives the
``model`` dimension its axis first, then ``data`` the largest remaining
dimension (the JAX package's order), so a rank's optimizer state is the
``data`` slice of its ``model`` slice, and its sharded-checkpoint pieces
(:meth:`Zero1.piece`) are bounded on both dimensions of the whole leaf.
With a ``pipe`` axis beside it (``pipe:2,model:2``) the chooser gives
``model``, then ``pipe``, then ``data`` their dimensions, as the JAX
``stage_param_specs`` and ``zero1_plan`` do, and a stage's pieces are a
rank's :class:`ModelSplit` (or :class:`Zero1`) pieces cut again along the
pipe dimension (``parallel/pipeline.py`` ``StageLayout.pieces``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS

MIN_SIZE = 16384

# tensor-parallel partition rules (the JAX package's TP_RULES): flax path
# regex -> the axis of each dimension of the flax leaf (kernels [in, out])
TP_RULES = [
    (r".*attention/(query|key|value)/kernel$", (None, MODEL_AXIS)),
    (r".*attention/(query|key|value)/bias$", (MODEL_AXIS,)),
    (r".*attention/output/kernel$", (MODEL_AXIS, None)),
    (r".*mlp/intermediate/kernel$", (None, MODEL_AXIS)),
    (r".*mlp/intermediate/bias$", (MODEL_AXIS,)),
    (r".*mlp/output/kernel$", (MODEL_AXIS, None)),
]

# flax paths of the leaves a pipeline stage owns alone: the embeddings
# (stage 0) and each encoder layer (its stage); the pooler and the heads
# are the last stage's, outside the stage scope (the JAX package's regex)
STAGE_SCOPE_RE = re.compile(r"(^|/)transformer/(embeddings|layer_\d+)(/|$)")


class ZeroLeafPlan(NamedTuple):
    """One leaf's ZeRO-1 placement: ``spec`` names the axis of every
    dimension (None or ``"data"``), ``axis``/``padded`` the dimension
    carrying ``data`` and its padded extent (``axis is None``: whole on
    every rank; ``padded == shape[axis]``: no padding)."""

    spec: Tuple[Optional[str], ...]
    axis: Optional[int]
    padded: Optional[int]


def _path_str(path) -> str:
    if path is None:
        return ""
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def tp_spec(path) -> Optional[Tuple[Optional[str], ...]]:
    """The :data:`TP_RULES` spec of the flax leaf at ``path`` (a tuple or an
    ``a/b/c`` string), or None where no rule matches (the leaf stays whole
    on every rank of a ``model`` group)."""
    path_s = _path_str(path)
    for pattern, spec in TP_RULES:
        if re.match(pattern, path_s):
            return spec
    return None


def _zero_leaf_plan(path, shape, *, data_size: int,
                    min_size: int = MIN_SIZE, pipe_size: int = 1,
                    model_size: int = 1) -> ZeroLeafPlan:
    """The one dimension chooser (the JAX package's ``_zero_leaf_plan``):
    with ``model_size > 1`` a leaf that :data:`TP_RULES` match (``path``, a
    flax path as a tuple or an ``a/b/c`` string) gives ``model`` its
    rule's dimension first; with ``pipe_size > 1`` a stage-scope leaf
    (:data:`STAGE_SCOPE_RE`) gives ``pipe`` its largest free dimension that
    ``pipe_size`` divides; then the largest remaining dimension
    ``data_size`` divides takes ``data``, else the largest remaining
    dimension (of at least 2) padded to the next multiple; ``data`` stays
    off below ``min_size`` elements (of the whole leaf) or at
    ``data_size`` 1."""
    shape = tuple(int(d) for d in shape)
    axes = [None] * len(shape)
    if model_size > 1:
        spec = tp_spec(path)
        if spec is not None:
            axes = list(spec) + [None] * (len(shape) - len(spec))
    if pipe_size > 1 and STAGE_SCOPE_RE.search(_path_str(path)):
        pipe_free = [(dim, i) for i, dim in enumerate(shape)
                     if axes[i] is None and dim % pipe_size == 0]
        if pipe_free:
            axes[max(pipe_free)[1]] = PIPE_AXIS
    if data_size <= 1 or int(np.prod(shape or (0,))) < min_size:
        return ZeroLeafPlan(tuple(axes), None, None)
    free = [(dim, i) for i, dim in enumerate(shape) if axes[i] is None]
    divisible = [(dim, i) for dim, i in free if dim % data_size == 0]
    if divisible:
        dim, i = max(divisible)
        padded = dim
    elif free and max(free)[0] >= 2:
        dim, i = max(free)
        padded = -(-dim // data_size) * data_size
    else:
        return ZeroLeafPlan(tuple(axes), None, None)
    axes[i] = DATA_AXIS
    return ZeroLeafPlan(tuple(axes), i, padded)


def _walk(tree: dict, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _walk(value, path)
        else:
            yield path, value


def _map(fn, tree: dict, *others):
    return {key: (_map(fn, value, *(o[key] for o in others))
                  if isinstance(value, dict)
                  else fn(value, *(o[key] for o in others)))
            for key, value in tree.items()}


def _map_with_path(fn, tree: dict, prefix=()):
    return {key: (_map_with_path(fn, value, prefix + (str(key),))
                  if isinstance(value, dict)
                  else fn(prefix + (str(key),), value))
            for key, value in tree.items()}


def zero1_plan(tree: dict, *, data_size: int,
               min_size: int = MIN_SIZE, pipe_size: int = 1,
               model_size: int = 1) -> dict:
    """One :class:`ZeroLeafPlan` per leaf of a nested dict of arrays (only
    ``.shape`` is read: whole leaves), in the tree's structure;
    ``pipe_size`` > 1: the stage layout's plan (the JAX package's
    ``stage_pipe``); ``model_size`` > 1: under the tensor-parallel
    rules."""
    return _map_with_path(lambda path, leaf: _zero_leaf_plan(
        path, np.shape(leaf), data_size=data_size, min_size=min_size,
        pipe_size=pipe_size, model_size=model_size), tree)


def _pad_leaf(x, z: ZeroLeafPlan):
    if z.axis is None or z.padded == x.shape[z.axis]:
        return x
    widths = [(0, 0)] * x.ndim
    widths[z.axis] = (0, z.padded - x.shape[z.axis])
    return np.pad(np.asarray(x), widths)


def zero_pad_tree(tree: dict, plan: dict) -> dict:
    """Zero-pad each leaf along its plan axis to the padded extent."""
    return _map(_pad_leaf, tree, plan)


def zero_unpad_tree(tree: dict, plan: dict, logical: dict) -> dict:
    """Slice padded leaves back to the shapes of ``logical``."""
    def unpad(x, z, ref):
        shape = tuple(np.shape(ref))
        if z.axis is None or tuple(x.shape) == shape:
            return x
        return x[tuple(slice(0, s) for s in shape)]
    return _map(unpad, tree, plan, logical)


def zero1_state_bytes(state_shapes: dict, *, data_size: int,
                      min_size: int = MIN_SIZE, pipe_size: int = 1) -> dict:
    """Modeled optimizer-state bytes per rank at ``data_size``: every leaf
    whole (``replicated_bytes``), each planned leaf's padded slice and the
    rest whole (``zero1_bytes``; with ``pipe_size`` > 1 each stage-scope
    leaf also divided over its ``pipe`` dimension, as the JAX package
    models it), and the whole bytes of the leaves that divide
    (``sharded_bytes``)."""
    data_size = max(1, int(data_size))
    pipe_size = max(1, int(pipe_size))
    full = zero1 = sharded = 0
    for path, leaf in _walk(state_shapes):
        shape = tuple(np.shape(leaf))
        size = np.dtype(getattr(leaf, "dtype", np.float32)).itemsize
        n = int(np.prod(shape or (1,), dtype=np.int64)) * size
        z = _zero_leaf_plan(path, shape, data_size=data_size,
                            min_size=min_size, pipe_size=pipe_size)
        full += n
        piece = [d // pipe_size if ax == PIPE_AXIS else d
                 for d, ax in zip(shape, z.spec)]
        if z.axis is None:
            m = int(np.prod(piece or [1], dtype=np.int64)) * size
            zero1 += m
            sharded += n if m < n else 0
            continue
        piece[z.axis] = z.padded // data_size
        zero1 += int(np.prod(piece, dtype=np.int64)) * size
        sharded += n
    return {"data_size": data_size, "replicated_bytes": full,
            "zero1_bytes": zero1, "sharded_bytes": sharded}


def opt_state_bytes_per_chip(optimizer) -> int:
    """Measured bytes of the optimizer state this rank holds: every moment
    tensor it keeps (under ZeRO-1 a planned leaf's slice)."""
    return int(sum(t.numel() * t.element_size()
                   for t in optimizer.state_tensors()))


class ParamSlice(NamedTuple):
    """A parameter's ZeRO-1 placement on the port's tensor: ``axis`` (None:
    whole) and ``padded`` are in the tensor's own orientation; ``plan`` is
    the JAX package's on the flax shape."""

    axis: Optional[int]
    padded: Optional[int]
    plan: ZeroLeafPlan


def flax_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The flax shape of the port's parameter ``name`` (a kernel is the
    transpose of ``Linear.weight``)."""
    shape = tuple(int(d) for d in shape)
    return shape[::-1] if _is_kernel(name) else shape


def _is_kernel(name: str) -> bool:
    from ..models.convert import jax_path   # models import this module

    return jax_path(name)[-1] == "kernel"


def zero1_param_plan(named_shapes: Iterable[Tuple[str, Sequence[int]]], *,
                     data_size: int, min_size: int = MIN_SIZE,
                     pipe_size: int = 1,
                     model_size: int = 1) -> Dict[str, ParamSlice]:
    """:func:`_zero_leaf_plan` of each parameter on its flax shape and path,
    mapped onto the port's tensor (a kernel's flax axis ``i`` is the
    weight's ``ndim - 1 - i``). ``named_shapes`` are whole shapes; under
    ``model_size`` > 1 a ``model``-split parameter's tensor is its slice,
    whose ``data`` dimension (another one) has the whole extent."""
    from ..models.convert import jax_path

    out = {}
    for name, shape in named_shapes:
        fshape = flax_shape(name, shape)
        z = _zero_leaf_plan(jax_path(name), fshape, data_size=data_size,
                            min_size=min_size, pipe_size=pipe_size,
                            model_size=model_size)
        axis = z.axis
        if axis is not None and _is_kernel(name):
            axis = len(fshape) - 1 - axis
        out[name] = ParamSlice(axis, z.padded, z)
    return out


def tree_order(names: Iterable[str]) -> list:
    """The port's parameter names in the JAX package's ``tree_leaves``
    order (flax dicts flatten with sorted keys, so the order of the flax
    paths, ``models/convert.py`` ``jax_path``)."""
    from ..models.convert import jax_path

    return sorted(names, key=jax_path)


def leaf_sizes(named_shapes: Iterable[Tuple[str, Sequence[int]]]) -> list:
    """Per-leaf element counts in :func:`tree_order` (the JAX package's
    ``leaf_sizes``: a scalar counts 1): the one flattened-gradient layout
    the bucket plan and the exchange share."""
    shapes = dict(named_shapes)
    return [int(np.prod(shapes[n])) if len(shapes[n]) else 1
            for n in tree_order(shapes)]


def zero1_bucket_plan(named_shapes: Iterable[Tuple[str, Sequence[int]]], *,
                      bucket_mb: float):
    """Size-targeted gradient buckets over the parameters' leaves in
    :func:`tree_order` (``--zero1_overlap bucketed``; the JAX package's
    ``zero1_bucket_plan``): each leaf contributes its f32 accumulation
    footprint, and contiguous runs close at ``bucket_mb``. The bucket count
    and each bucket's leaves equal the JAX package's."""
    from .collectives import plan_grad_buckets

    return plan_grad_buckets(
        leaf_sizes(named_shapes),
        bucket_bytes=max(1, int(float(bucket_mb) * 2**20)), itemsize=4)


def pad_to(t: torch.Tensor, axis: int, padded: int) -> torch.Tensor:
    """``t`` zero-padded along ``axis`` to ``padded`` (``t`` itself when it
    is that long already)."""
    extra = padded - t.shape[axis]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[axis] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def local_slice(t: torch.Tensor, z: ParamSlice, index: int,
                size: int) -> torch.Tensor:
    """Rank ``index``'s contiguous copy of ``t``'s padded slice (``t``
    itself for a whole leaf)."""
    if z.axis is None:
        return t
    chunk = z.padded // size
    return pad_to(t, z.axis, z.padded).narrow(
        z.axis, index * chunk, chunk).contiguous()


def seq_split(x: torch.Tensor, index: int, size: int,
              dim: int = 1) -> torch.Tensor:
    """Block ``index`` of ``size`` equal blocks of ``x`` along ``dim`` (the
    ``seq`` placement of a ``[B, L, ...]`` batch leaf, the JAX package's
    ``batch_pspec(shard_seq=True)``)."""
    if size <= 1:
        return x
    L = x.shape[dim]
    if L % size:
        raise ValueError(f"sequence length {L} does not split over a seq "
                         f"axis of {size}")
    return x.narrow(dim, index * (L // size), L // size)


def tp_param_dims(names: Iterable[str]) -> Dict[str, int]:
    """The port's parameters that :data:`TP_RULES` split, each with the
    dimension of its tensor the ``model`` axis takes (a kernel's flax axis
    ``i`` is the weight's ``1 - i``; a bias keeps its one dimension)."""
    from ..models.convert import jax_path

    out = {}
    for name in names:
        path = jax_path(name)
        spec = tp_spec(path)
        if spec is not None:
            i = spec.index(MODEL_AXIS)
            out[name] = len(spec) - 1 - i if path[-1] == "kernel" else i
    return out


class ModelSplit:
    """One rank's place in its ``model`` group (tensor parallelism):
    ``dims`` maps each split parameter (the port's name) to the dimension
    of its tensor the group divides (:func:`tp_param_dims`), ``index`` and
    ``size`` are the rank's place and the group's size, ``group`` its
    process group (None: the world), and ``owner`` says whether this rank
    writes its slices into sharded checkpoints (``data`` index 0)."""

    def __init__(self, dims: Dict[str, int], *, index: int, size: int,
                 group=None, owner: bool = True):
        self.dims, self.index, self.size = dict(dims), int(index), int(size)
        self.group, self.owner = group, bool(owner)

    def sharded(self, name: str) -> bool:
        return name in self.dims

    def local(self, name: str, whole: torch.Tensor,
              n: Optional[int] = None) -> torch.Tensor:
        """This rank's slice of the whole tensor of parameter ``name``
        (``whole`` itself for a leaf the rules keep whole); ``n``: the
        slice's extent, by default ``1/size`` of the whole's (a saved
        moment may be longer: a ZeRO-1 save padded it)."""
        if name not in self.dims:
            return whole
        dim = self.dims[name]
        n = whole.shape[dim] // self.size if n is None else int(n)
        return whole.narrow(dim, self.index * n, n).contiguous()

    def whole_shape(self, name: str, shape: Sequence[int]) -> tuple:
        """The whole shape of parameter ``name`` of this rank's ``shape``
        (a split dimension times the group's size)."""
        shape = list(shape)
        if name in self.dims:
            shape[self.dims[name]] *= self.size
        return tuple(shape)

    def local_state(self, state: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's slices of a whole model's state dict."""
        return {n: self.local(n, t) for n, t in state.items()}

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The group's slices of parameter ``name`` (this rank's is ``t``)
        as the whole, on ``t``'s device; ``t`` itself for a whole leaf.
        Every rank of the group calls it."""
        if name not in self.dims:
            return t
        from .collectives import all_gather_cat

        return all_gather_cat(t, self.group, dim=self.dims[name])

    def flax_dim(self, name: str, ndim: int) -> int:
        """The dimension the group divides in the flax orientation."""
        dim = self.dims[name]
        return ndim - 1 - dim if _is_kernel(name) else dim

    def piece(self, name: str, data: np.ndarray) -> "LocalPiece":
        """:class:`LocalPiece` of this rank's slice ``data`` (flax
        orientation) of the split leaf ``name`` (``shards``: the group's
        size)."""
        axis = self.flax_dim(name, data.ndim)
        n = data.shape[axis]
        shape = list(data.shape)
        shape[axis] = n * self.size
        bounds = tuple((self.index * n, (self.index + 1) * n) if i == axis
                       else (0, int(d)) for i, d in enumerate(shape))
        return LocalPiece(tuple(shape), bounds, data, self.size, self.owner)


class LocalPiece(NamedTuple):
    """This rank's piece of a ZeRO-1 leaf for a sharded checkpoint, in the
    flax orientation: the padded leaf's ``shape``, the piece's ``bounds``
    (``[start, stop]`` per dimension) and ``data``, the leaf's ``shards``
    count, and whether this rank writes it (``owner``: the first rank of
    its ``seq`` group; the others hold a replica)."""

    shape: Tuple[int, ...]
    bounds: Tuple[Tuple[int, int], ...]
    data: np.ndarray
    shards: int
    owner: bool


class Zero1:
    """The ZeRO-1 layout of one optimizer: each parameter's placement
    (:func:`zero1_param_plan`), this rank's ``index`` on the ``data`` axis
    of ``size`` ranks, the ``group`` the slices are gathered over, and
    whether this rank writes its pieces into sharded checkpoints
    (``owner``); ``tp``, under a ``model`` axis, the rank's
    :class:`ModelSplit` (its tensors are ``model`` slices, and a piece is
    bounded on both dimensions of the whole leaf)."""

    def __init__(self, plan: Dict[str, ParamSlice], *, index: int, size: int,
                 group=None, owner: bool = True,
                 tp: Optional[ModelSplit] = None):
        self.plan, self.index, self.size = dict(plan), int(index), int(size)
        self.group, self.owner, self.tp = group, bool(owner), tp

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (``t`` itself for a whole leaf)."""
        return local_slice(t, self.plan[name], self.index, self.size)

    def sharded(self, name: str) -> bool:
        return self.plan[name].axis is not None

    def gather(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        """Every rank's slice of a planned leaf, as the padded whole."""
        from .collectives import all_gather_cat

        return all_gather_cat(piece, self.group, dim=self.plan[name].axis)

    def unpad(self, name: str, padded: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
        z = self.plan[name]
        return padded.narrow(z.axis, 0, int(shape[z.axis]))

    def piece(self, name: str, data: np.ndarray) -> LocalPiece:
        """:class:`LocalPiece` of this rank's slice ``data`` (flax
        orientation) of the planned leaf ``name``."""
        z = self.plan[name].plan
        chunk = z.padded // self.size
        shards = self.size
        shape = list(data.shape)
        shape[z.axis] = z.padded
        bounds = [(self.index * chunk, (self.index + 1) * chunk)
                  if i == z.axis else (0, int(d))
                  for i, d in enumerate(shape)]
        owner = self.owner
        if self.tp is not None and self.tp.sharded(name):
            tp = self.tp.piece(name, data)
            axis = self.tp.flax_dim(name, data.ndim)
            shape[axis], bounds[axis] = tp.shape[axis], tp.bounds[axis]
            shards *= self.tp.size
        elif self.tp is not None:
            # a leaf the model group holds whole: its first rank writes
            owner = owner and self.tp.index == 0
        return LocalPiece(tuple(shape), tuple(bounds), data, shards, owner)
