"""Checkpoints in the JAX package's two layouts, read and written.

The JAX writer (``ml_recipe_tpu/train/checkpoint.py``) stores either one
flax-msgpack file (``persist_state``) or, with ``--sharded_checkpoint``, a
directory (``save_state_dict_sharded``). The port reads and writes both,
with its own msgpack codec (no ``flax``, no ``msgpack`` package). Either
layout holds:

- ``model``: the flax params tree (``models/convert.py`` maps it onto the
  modules name for name);
- ``optimizer``: the optax chain's state-dict layout (``train/optim.py``
  ``flax_state``), so the JAX ``Trainer.load_state_dict`` restores a
  port checkpoint and the port resumes a JAX one;
- ``loss_scale``, under ``--apex_loss_scale`` only: the scaling state as
  its own group (``train/loss_scale.py``), so a checkpoint stays loadable
  when the flag changes between save and resume;
- ``global_step``, ``scheduler`` ``{"last_step": step}`` and the trainer's
  ``extra`` topology record.

Each save is a snapshot, then a persist. The snapshot
(:func:`snapshot_state`, :func:`snapshot_state_sharded`) copies every
leaf to host buffers of its own: the optimizer updates the parameters and
moments in place, so a persist running later on a background thread
(``resilience/checkpoint_async.py``) must not read the live tensors. The
persist (:func:`persist_state`, :func:`persist_state_sharded`) serializes
and writes; the synchronous saves are the two run back to back.

The single file holds them as one dict, written atomically (a temporary
file, then a rename); with several processes rank 0 writes it. The sharded
directory is the JAX layout::

    path/
      manifest.msgpack     # format tag, step, process_count, groups:
                           # per-leaf shape, dtype, shard count and
                           # folded crc32
      shard-00000.msgpack  # {"global_step", "shards": {group: {leaf:
                           #   [{"bounds", "data", "crc32"}]}}}
      shard-00001.msgpack  # one per process; a replicated leaf is owned
      ...                  # by process 0 (the others hold
                           # {"global_step", "shards": {}})

Under ZeRO-1 (``train/optim.py``) the optimizer's planned leaves are
stored at their padded shape, as the JAX package stores them at the same
mesh: the single file holds the gathered whole, and in the directory every
``seq_index`` 0 process writes its own slice of each as one piece (the
leaf's ``shards`` is the data-axis size, the manifest's ``shards`` the
widest optimizer leaf's, and only leaves that process 0 writes whole carry
a folded crc32 in the manifest, as in the JAX writer). A restore crops or
zero-fills every moment onto the live layout.

Under a ``model`` axis (tensor parallelism) every leaf in either layout
is whole, as the JAX package writes it: the single file gathers the
``model`` group's slices (``parallel.sharding.ModelSplit``; every process
takes part, rank 0 writes), so it is the file one process writes; in the
directory each ``data`` index 0 rank writes its slice of every split
parameter and moment as a piece bounded in the whole leaf (``shards``
the group's size, and a ZeRO-1 moment's pieces, bounded on both
dimensions, D*T), the JAX writer's ``shards`` count and crc fold. A
restore reads whole leaves and keeps this rank's slices. Under ``pipe``
and ``model`` (``pipe:2,model:2``) each stage writes its leaves so
(``train/trainer.py`` ``_pipe_groups``), each piece cut again along the
JAX stage layout's pipe dimension (``shards`` K*T, D*K*T for a ZeRO-1
moment); a restore keeps the rank's stage's slices.

Leaves are keyed ``a/b/c``; an empty subtree (optax's ``EmptyState``) is an
``{"empty": True}`` leaf. The shard file is written first into
``path.saving``, the manifest last (its presence means the directory is
complete), then ``path.saving`` is swapped in for ``path`` through
``path.old``: an interruption leaves the previous checkpoint, and the next
reader rolls the swap forward or back. A read checks every piece's crc32,
the folded crc32 of every leaf and the shard file's step against the
manifest.

:func:`read_state` detects the layout, so ``--last`` resumes from either;
:func:`peek_global_step` reads only the step of either (the supervisor's
progress probe). The fault sites of ``resilience/faults.py`` sit where the
JAX writer has them: ``checkpoint.persist`` at the start of every persist
(on the background thread under ``--async_checkpoint``), ``ckpt.pre_write``
before the single file's write, ``ckpt.pre_shard_write``,
``ckpt.pre_manifest`` and ``ckpt.mid_swap`` in the sharded persist.
Serving needs ``state["model"]`` only (:func:`load_state_dict`); training
restores the optimizer too unless ``drop_optimizer``
(:func:`load_training_state`).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
from torch import nn

from ..models.convert import from_jax_params, jax_path, to_jax_params
from ..parallel.dist import barrier
from ..parallel.sharding import LocalPiece
from ..resilience.faults import fire as _fault
from ..utils.msgpack import packb, unpackb

logger = logging.getLogger(__name__)

MANIFEST = "manifest.msgpack"
SHARDED_FORMAT = "ml_recipe_tpu.sharded.v1"


class TornCheckpointError(RuntimeError):
    """A sharded checkpoint whose pieces fail their checks."""


def _shard_file(path: str, process: int) -> str:
    return os.path.join(path, f"shard-{process:05d}.msgpack")


def read_state(path) -> dict:
    """The whole decoded checkpoint dict of either layout: ``model``,
    ``optimizer`` (None when not saved), ``scheduler``, ``global_step`` and
    the ``extra`` keys."""
    path = os.fspath(path)
    if os.path.isdir(path):
        return _read_sharded(path)
    with open(path, "rb") as fh:
        state = unpackb(fh.read())
    if not isinstance(state, dict) or "model" not in state:
        raise ValueError(f"{path}: not a checkpoint (no 'model' entry)")
    return state


def load_params(path) -> Tuple[dict, int]:
    """``(state["model"] as a nested dict of numpy, global_step)``."""
    state = read_state(path)
    return state["model"], int(state.get("global_step") or 0)


def _resumable(path: str) -> bool:
    """Whether ``path`` holds a checkpoint to load, after rolling an
    interrupted sharded swap forward or back; logs why not."""
    if not os.path.exists(path):
        _recover_interrupted_swap(path, path + ".saving", path + ".old")
    if not os.path.exists(path):
        logger.warning("Checkpoint %s does not exist, so checkpoint was not "
                       "loaded.", path)
        return False
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, MANIFEST)):
        logger.warning("Checkpoint directory %s has no %s (interrupted first "
                       "sharded save?); checkpoint was not loaded.", path,
                       MANIFEST)
        return False
    return True


def _read_resumable(path: str) -> Optional[dict]:
    """:func:`read_state`, or None (logged) where the JAX reader warns and
    carries on: no checkpoint, or a torn sharded one."""
    if not _resumable(path):
        return None
    try:
        return read_state(path)
    except TornCheckpointError as exc:
        logger.warning("Checkpoint %s was not loaded: %s", path, exc)
        return None


def _model_split(model: nn.Module):
    """The model's ``ModelSplit`` under a ``model`` axis, else None."""
    split = getattr(model, "model_split", None)
    return split() if split is not None else None


def _weights(model: nn.Module, tree: dict) -> dict:
    """A flax params tree as ``model``'s state dict: this rank's slices of
    the leaves a ``model`` axis splits."""
    weights = from_jax_params(tree)
    split = _model_split(model)
    return weights if split is None else split.local_state(weights)


def load_state_dict(model: nn.Module, path) -> Optional[int]:
    """Load a checkpoint's model weights into ``model`` (cast to its dtype
    and device); returns the checkpoint's global step. A missing or torn
    checkpoint is logged and skipped, as the JAX reader does (returns
    None)."""
    state = _read_resumable(os.fspath(path))
    if state is None:
        return None
    model.load_state_dict(_weights(model, state["model"]), strict=True)
    logger.info("Model weights were loaded from %s checkpoint.", path)
    return int(state.get("global_step") or 0)


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)   # no torn checkpoint on interrupt


def _model_tree(model: nn.Module, *, copy: bool = False,
                local: bool = False) -> dict:
    """The model's flax params tree: under a ``model`` axis the group's
    slices gathered whole (every rank of the group calls it), or with
    ``local`` this rank's ``LocalPiece`` of each split leaf."""
    split = _model_split(model)
    state = model.state_dict()
    if split is None:
        return to_jax_params(state, copy=copy)
    if not local:
        return to_jax_params({n: split.gather(n, t) for n, t in
                              state.items()}, copy=copy)
    tree = to_jax_params(state, copy=copy)
    for name in split.dims:
        *parents, leaf = jax_path(name)
        node = tree
        for part in parents:
            node = node[part]
        node[leaf] = split.piece(name, node[leaf])
    return tree


def _training_groups(model: nn.Module, optimizer, loss_scale=None, *,
                     copy: bool = False, local: bool = False) -> dict:
    groups = {"model": _model_tree(model, copy=copy, local=local)}
    if optimizer is not None:
        groups["optimizer"] = optimizer.flax_state(copy=copy, local=local)
    if loss_scale is not None:
        groups["loss_scale"] = loss_scale.state_dict()
    return groups


def snapshot_state(*, model: nn.Module, optimizer=None, loss_scale=None,
                   global_step: int = 0, extra: Optional[dict] = None,
                   copy: bool = False) -> dict:
    """The single-file layout's dict (see the module docstring) on the
    host; ``copy``: no leaf shares memory with a live tensor (a persist
    deferred past the next step needs it)."""
    groups = _training_groups(model, optimizer, loss_scale, copy=copy)
    state = {
        "model": groups["model"],
        "optimizer": groups.get("optimizer"),
        "scheduler": {"last_step": int(global_step)},
        "global_step": int(global_step),
    }
    if "loss_scale" in groups:
        state["loss_scale"] = groups["loss_scale"]
    if extra:
        state.update(extra)
    return state


def _refuse_directory(path: str) -> None:
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory (a sharded checkpoint?); write it with "
            f"save_state_dict_sharded or pick another path")


def persist_state(path, state: dict) -> None:
    """Serialize a :func:`snapshot_state` dict and write it atomically (a
    temporary file, then a rename); touches no tensor."""
    _fault("checkpoint.persist")
    path = os.fspath(path)
    _refuse_directory(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic: a kill here leaves the previous checkpoint at path intact
    _fault("ckpt.pre_write")
    _atomic_write(path, packb(state))
    logger.info("State dict was saved to %s.", path)


def save_state_dict(path, *, model: nn.Module, optimizer=None,
                    loss_scale=None, global_step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Write one checkpoint file in the JAX single-file layout (see the
    module docstring): snapshot, then persist. ``optimizer`` is one of
    ``train.optim``'s chains or None, ``loss_scale`` a
    ``train.loss_scale.LossScaleState`` or None."""
    _refuse_directory(os.fspath(path))
    persist_state(path, snapshot_state(
        model=model, optimizer=optimizer, loss_scale=loss_scale,
        global_step=global_step, extra=extra))


class Restored(NamedTuple):
    global_step: int
    loss_scale: Optional[dict]   # the checkpoint's loss_scale group, if read


def load_training_state(path, *, model: nn.Module, optimizer=None,
                        drop_optimizer: bool = False,
                        only=None) -> Optional[Restored]:
    """Restore weights and, unless ``drop_optimizer``, the optimizer state
    (moments and counts) from a checkpoint of either package and either
    layout; returns its global step and, unless ``drop_optimizer``, its
    ``loss_scale`` group (None when it has none), or None (logged) when
    there is no checkpoint to load. ``only``: the parameter names to load
    (a pipeline stage's), the others left as they are."""
    state = _read_resumable(os.fspath(path))
    if state is None:
        return None
    weights = _weights(model, state["model"])
    if only is None:
        model.load_state_dict(weights, strict=True)
    else:
        missing = [n for n in only if n not in weights]
        if missing:
            raise ValueError(f"{path}: checkpoint lacks {missing[:3]}")
        model.load_state_dict({n: weights[n] for n in only}, strict=False)
    logger.info("Model weights were loaded from %s checkpoint.", path)
    if not drop_optimizer and optimizer is not None and \
            state.get("optimizer") is not None:
        optimizer.load_flax_state(state["optimizer"])
        logger.info("Optimizer and scheduler also were restored from %s "
                    "checkpoint.", path)
    return Restored(int(state.get("global_step") or 0),
                    None if drop_optimizer else state.get("loss_scale"))


# -- the sharded-directory layout ---------------------------------------------

_EMPTY = object()   # an empty subtree, stored as an {"empty": True} leaf


def _flatten(tree: dict, prefix: str = "") -> dict:
    """``{'a/b/c': leaf}``, empty dicts kept as :data:`_EMPTY` leaves (flax
    ``flatten_dict(..., keep_empty_nodes=True)``)."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            if value:
                flat.update(_flatten(value, name + "/"))
            else:
                flat[name] = _EMPTY
        else:
            flat[name] = value
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = {} if value is _EMPTY else value
    return tree


def _crc32_of(arr) -> int:
    """crc32 over an array's C-contiguous bytes (``_crc32_of``)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _fold_piece_crcs(pieces) -> int:
    """One leaf checksum from its ``(bounds, crc)`` pieces, folded in sorted
    bounds order (``_fold_piece_crcs``)."""
    crc = 0
    for bounds, piece_crc in sorted(
            (tuple(tuple(int(x) for x in b) for b in bounds), int(c))
            for bounds, c in pieces):
        crc = zlib.crc32(repr((bounds, piece_crc)).encode(), crc)
    return crc


def _recover_interrupted_swap(path: str, staging: str, old: str) -> None:
    """Finish a sharded save that died between its two renames (``path ->
    old``, then ``staging -> path``): roll forward to ``staging`` when its
    manifest says it is complete, else back to ``old``."""
    if os.path.exists(path):
        return
    if os.path.isdir(staging) and os.path.exists(os.path.join(staging,
                                                             MANIFEST)):
        os.rename(staging, path)
        logger.warning("Recovered interrupted sharded save: completed staged "
                       "checkpoint %s promoted to %s.", staging, path)
    elif os.path.exists(old):
        os.rename(old, path)
        logger.warning("Recovered interrupted sharded save: previous "
                       "checkpoint %s restored to %s.", old, path)


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def snapshot_state_sharded(*, model: nn.Module = None, optimizer=None,
                           loss_scale=None, global_step: int = 0,
                           extra: Optional[dict] = None,
                           process_index: int = 0, process_count: int = 1,
                           copy: bool = False,
                           groups: Optional[dict] = None) -> dict:
    """This process's part of a sharded save on the host: the manifest
    and the pieces it owns (a replicated leaf is owned by process 0,
    recorded with ``shards`` 1; a ZeRO-1 leaf's pieces by the processes
    holding them, see the module docstring). ``copy`` as in
    :func:`snapshot_state`. ``groups``: this process's groups as they
    are, instead of ``model``'s and ``optimizer``'s (a pipeline stage's,
    whose leaves are lists of :class:`LocalPiece`; the manifests are then
    merged, :func:`merge_manifests`)."""
    step = int(global_step)
    manifest = {"format": SHARDED_FORMAT, "global_step": step,
                "scheduler": {"last_step": step},
                "process_count": int(process_count), "groups": {}}
    if extra:
        manifest["extra"] = dict(extra)
    owned: dict = {}
    zero = getattr(optimizer, "zero", None) is not None
    split = model is not None and _model_split(model) is not None
    if groups is None and process_index == 0:
        groups = _training_groups(model, optimizer, loss_scale, copy=copy,
                                  local=zero or split)
    elif groups is None and split:
        # this rank's slices (the whole leaves are process 0's)
        groups = _training_groups(model, optimizer, copy=copy, local=True)
    elif groups is None:
        groups = ({"optimizer": optimizer.flax_state(copy=copy, local=True)}
                  if zero else {})
    for gname, tree in groups.items():
        leaves = manifest["groups"][gname] = {}
        for key, leaf in _flatten(tree).items():
            if leaf is _EMPTY:
                leaves[key] = {"empty": True}
                continue
            if isinstance(leaf, LocalPiece):
                leaf = [leaf]
            if isinstance(leaf, list):
                leaves[key] = {"shape": list(leaf[0].shape),
                               "dtype": str(leaf[0].data.dtype),
                               "shards": int(leaf[0].shards)}
                pieces = []
                for piece in leaf:
                    if piece.owner:
                        data = np.ascontiguousarray(piece.data).reshape(
                            np.shape(piece.data))
                        pieces.append({"bounds": [list(b) for b in
                                                  piece.bounds],
                                       "data": data,
                                       "crc32": _crc32_of(data)})
                if pieces:
                    owned.setdefault(gname, {})[key] = pieces
                continue
            if process_index != 0:
                continue
            arr = np.asarray(leaf)
            bounds = [[0, int(d)] for d in arr.shape]
            crc = _crc32_of(arr)
            owned.setdefault(gname, {})[key] = [
                {"bounds": bounds, "data": arr, "crc32": crc}]
            leaves[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                           "shards": 1,
                           "crc32": _fold_piece_crcs([(bounds, crc)])}
    manifest["shards"] = _widest_shards(manifest["groups"])
    return {"manifest": manifest, "owned": owned, "global_step": step,
            "process_index": int(process_index),
            "process_count": int(process_count)}


def _widest_shards(groups: dict) -> int:
    """The manifest's ``shards``: the widest optimizer leaf's piece count."""
    return max([int(m.get("shards", 1)) for m in
                groups.get("optimizer", {}).values()
                if not m.get("empty")] or [1])


def merge_manifests(snap: dict, manifest_groups) -> dict:
    """``snap`` (process 0's :func:`snapshot_state_sharded`) with its
    manifest's groups the union of every process's ``manifest_groups``
    (a pipeline's stages each describe their own leaves)."""
    merged: dict = {}
    for groups in manifest_groups:
        for gname, leaves in (groups or {}).items():
            merged.setdefault(gname, {}).update(leaves)
    snap["manifest"]["groups"] = merged
    snap["manifest"]["shards"] = _widest_shards(merged)
    return snap


def persist_state_sharded(path, snap: dict) -> None:
    """Write a :func:`snapshot_state_sharded` part as its process (every
    process calls it): the shard file into ``path.saving``, the manifest
    last, then the swap. Barriers go around the staging, the shard writes
    and the swap, as in the JAX writer."""
    _fault("checkpoint.persist")
    process_index, process_count = snap["process_index"], snap["process_count"]

    def sync(tag: str) -> None:
        if process_count > 1:
            barrier(tag)

    primary = process_index == 0
    path = os.fspath(path)
    if os.path.isdir(path) and os.listdir(path) and \
            not os.path.exists(os.path.join(path, MANIFEST)):
        raise IsADirectoryError(
            f"checkpoint path {path} is a non-empty directory that is not a "
            f"sharded checkpoint; refusing to write into it")
    staging, old = path + ".saving", path + ".old"
    if primary:
        _recover_interrupted_swap(path, staging, old)
        for leftover in (staging, old):   # debris of an interrupted save
            _remove(leftover)
    sync("sharded_ckpt_stage_clear")
    os.makedirs(staging, exist_ok=True)
    _fault("ckpt.pre_shard_write")
    _atomic_write(_shard_file(staging, process_index),
                  packb({"global_step": snap["global_step"],
                         "shards": snap["owned"]}))
    # every shard file lands before the manifest exists
    sync("sharded_ckpt_shards_written")
    if primary:
        # the drills' kill window: shards durable, manifest (the
        # completeness marker) not yet — the previous checkpoint survives
        _fault("ckpt.pre_manifest")
        # the manifest last: its presence marks the directory complete
        _atomic_write(os.path.join(staging, MANIFEST), packb(snap["manifest"]))
        if os.path.exists(path):   # a single file or a directory
            os.rename(path, old)
        _fault("ckpt.mid_swap")
        os.rename(staging, path)
        _remove(old)
    # the peers may act on the checkpoint once the swap has landed
    sync("sharded_ckpt_swapped")
    logger.info("Sharded state dict was saved to %s (process %d of %d).",
                path, process_index, process_count)


def save_state_dict_sharded(path, *, model: nn.Module, optimizer=None,
                            loss_scale=None, global_step: int = 0,
                            extra: Optional[dict] = None,
                            process_index: int = 0,
                            process_count: int = 1) -> None:
    """Write the sharded-directory layout (see the module docstring) as
    process ``process_index`` of ``process_count``: snapshot, then
    persist."""
    persist_state_sharded(path, snapshot_state_sharded(
        model=model, optimizer=optimizer, loss_scale=loss_scale,
        global_step=global_step, extra=extra, process_index=process_index,
        process_count=process_count))


def peek_global_step(path, *, retries: int = 0,
                     retry_delay: float = 0.05) -> Optional[int]:
    """``global_step`` of the checkpoint at ``path`` (either layout) without
    restoring any state, or None when there is no readable checkpoint
    there. The supervisor's progress probe: it rolls an interrupted swap
    forward or back first (as a load would) and treats any unreadable or
    torn checkpoint as absent rather than raising. ``retries`` re-probes
    after ``retry_delay`` when a read comes back None: an elastic
    supervisor peeks checkpoints a peer host may be swapping."""
    step = _peek_global_step_once(path)
    for _ in range(max(0, int(retries))):
        if step is not None:
            break
        time.sleep(retry_delay)
        step = _peek_global_step_once(path)
    return step


def peek_mesh_axes(path) -> Optional[dict]:
    """The ``mesh_axes`` a sharded directory's manifest records (the saver's
    mesh), or None for a single file, an absent or unreadable checkpoint,
    or a manifest without them. Reads only the manifest."""
    manifest_path = os.path.join(os.fspath(path), MANIFEST)
    if not os.path.isfile(manifest_path):
        return None
    try:
        with open(manifest_path, "rb") as fh:
            extra = unpackb(fh.read()).get("extra") or {}
    except Exception as e:  # noqa: BLE001 - a torn manifest names no mesh
        logger.warning(f"Could not peek mesh_axes from {path}: {e!r}")
        return None
    axes = extra.get("mesh_axes")
    return dict(axes) if axes else None


def peek_checkpoint_layout(path) -> Optional[dict]:
    """The layout of the checkpoint at ``path`` without loading a tensor of
    a sharded directory (the JAX package's ``peek_checkpoint_layout``):
    ``format``, ``global_step``, ``process_count``, ``shards`` (the widest
    optimizer leaf's piece count), ``opt_sharding``, ``mesh_axes``,
    ``pipe_schedule``, ``pipe_param_layout`` and ``groups`` (leaves per
    group). A single file is read whole. None when there is no readable
    checkpoint there."""
    path = os.fspath(path)
    if not os.path.exists(path):
        _recover_interrupted_swap(path, path + ".saving", path + ".old")
    if not os.path.exists(path):
        return None
    try:
        if os.path.isdir(path):
            manifest_path = os.path.join(path, MANIFEST)
            if not os.path.exists(manifest_path):
                return None
            with open(manifest_path, "rb") as fh:
                manifest = unpackb(fh.read())
            extra = manifest.get("extra") or {}
            return {"format": "sharded",
                    "global_step": int(manifest.get("global_step", 0)),
                    "process_count": int(manifest.get("process_count", 1)),
                    "shards": int(manifest.get("shards", 1)),
                    "opt_sharding": extra.get("opt_sharding"),
                    "mesh_axes": extra.get("mesh_axes"),
                    "pipe_schedule": extra.get("pipe_schedule"),
                    "pipe_param_layout": extra.get("pipe_param_layout"),
                    "groups": {g: len(leaves) for g, leaves in
                               manifest.get("groups", {}).items()}}
        with open(path, "rb") as fh:
            state = unpackb(fh.read())
        return {"format": "single_file",
                "global_step": int(state.get("global_step", 0)),
                "process_count": 1, "shards": 1,
                "opt_sharding": state.get("opt_sharding"),
                "mesh_axes": state.get("mesh_axes"),
                "pipe_schedule": state.get("pipe_schedule"),
                "pipe_param_layout": state.get("pipe_param_layout"),
                "groups": {g: len(_flatten(state[g]))
                           for g in ("model", "optimizer", "loss_scale")
                           if isinstance(state.get(g), dict)}}
    except Exception as e:  # noqa: BLE001 - torn/corrupt == not resumable
        logger.warning(f"Could not peek checkpoint layout from {path}: {e!r}")
        return None


def _peek_global_step_once(path) -> Optional[int]:
    path = os.fspath(path)
    if not os.path.exists(path):
        _recover_interrupted_swap(path, path + ".saving", path + ".old")
    if not os.path.exists(path):
        return None
    try:
        if os.path.isdir(path):
            manifest_path = os.path.join(path, MANIFEST)
            if not os.path.exists(manifest_path):
                return None
            with open(manifest_path, "rb") as fh:
                return int(unpackb(fh.read())["global_step"])
        with open(path, "rb") as fh:
            state = unpackb(fh.read())
        return int(state.get("global_step") or 0)
    except Exception as e:  # noqa: BLE001 - torn/corrupt == not resumable
        logger.warning(f"Could not peek global_step from {path}: {e!r}")
        return None


def _read_sharded(path: str) -> dict:
    """Assemble a sharded directory (any process count) into the
    single-file layout's dict, checking every piece."""
    manifest_path = os.path.join(path, MANIFEST)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"{path} is a directory without {MANIFEST}: not a complete "
            f"sharded checkpoint")
    with open(manifest_path, "rb") as fh:
        manifest = unpackb(fh.read())
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(f"{path}: sharded checkpoint format "
                         f"{manifest.get('format')!r}, expected "
                         f"{SHARDED_FORMAT!r}")
    step = int(manifest["global_step"])
    groups = manifest["groups"]
    assembled = {g: {} for g in groups}
    filled = {g: {} for g in groups}
    crcs = {g: {} for g in groups}
    for process in range(int(manifest.get("process_count", 1))):
        shard_path = _shard_file(path, process)
        if not os.path.exists(shard_path):
            raise TornCheckpointError(f"sharded checkpoint missing {shard_path}")
        with open(shard_path, "rb") as fh:
            shard = unpackb(fh.read())
        if int(shard["global_step"]) != step:
            raise TornCheckpointError(
                f"sharded checkpoint is torn: {shard_path} holds step "
                f"{shard['global_step']}, the manifest {step}")
        for gname, leaves in shard["shards"].items():
            for key, pieces in leaves.items():
                meta = groups[gname][key]
                buf = assembled[gname].get(key)
                if buf is None:
                    buf = assembled[gname][key] = np.empty(
                        tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]))
                    filled[gname][key] = 0
                for piece in pieces:
                    if "crc32" in piece:
                        if _crc32_of(piece["data"]) != int(piece["crc32"]):
                            raise TornCheckpointError(
                                f"sharded checkpoint corrupt: {gname}/{key} "
                                f"piece {piece['bounds']} in {shard_path} "
                                f"fails its crc32 check")
                        crcs[gname].setdefault(key, []).append(
                            (piece["bounds"], piece["crc32"]))
                    buf[tuple(slice(a, b) for a, b in piece["bounds"])] = \
                        piece["data"]
                    filled[gname][key] += int(np.prod(
                        [b - a for a, b in piece["bounds"]], dtype=np.int64))
    state: dict = {}
    for gname, leaves in groups.items():
        flat = {}
        for key, meta in leaves.items():
            if meta.get("empty"):
                flat[key] = _EMPTY
                continue
            want = int(np.prod(meta["shape"], dtype=np.int64))
            if filled[gname].get(key, 0) != want:
                raise TornCheckpointError(
                    f"sharded checkpoint incomplete: {gname}/{key} has "
                    f"{filled[gname].get(key, 0)} of {want} elements")
            if "crc32" in meta and _fold_piece_crcs(
                    crcs[gname].get(key, [])) != int(meta["crc32"]):
                raise TornCheckpointError(
                    f"sharded checkpoint corrupt: {gname}/{key} piece "
                    f"checksums do not match the manifest")
            flat[key] = assembled[gname][key]
        state[gname] = _unflatten(flat)
    state.setdefault("optimizer", None)
    state.setdefault("loss_scale", None)
    state["scheduler"] = manifest.get("scheduler", {"last_step": step})
    state["global_step"] = step
    state.update(manifest.get("extra") or {})
    return state
