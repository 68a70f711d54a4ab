"""Checkpoints in the JAX package's two layouts, read and written.

The JAX writer (``ml_recipe_tpu/train/checkpoint.py``) stores either one
flax-msgpack file (``persist_state``) or, with ``--sharded_checkpoint``, a
directory (``save_state_dict_sharded``). The port reads and writes both,
with its own msgpack codec (no ``flax``, no ``msgpack`` package). Either
layout holds:

- ``model``: the flax params tree (``models/convert.py`` maps it onto the
  modules name for name);
- ``optimizer``: the optax chain's state-dict layout (``train/optim.py``
  ``AdamW.flax_state``), so the JAX ``Trainer.load_state_dict`` restores a
  port checkpoint and the port resumes a JAX one;
- ``global_step``, ``scheduler`` ``{"last_step": step}`` and the trainer's
  ``extra`` topology record.

The single file holds them as one dict, written atomically (a temporary
file, then a rename). The sharded directory is the JAX layout as one
process writes it::

    path/
      manifest.msgpack     # format tag, step, groups: per-leaf shape,
                           # dtype, shard count and folded crc32
      shard-00000.msgpack  # {"global_step", "shards": {group: {leaf:
                           #   [{"bounds", "data", "crc32"}]}}}

Leaves are keyed ``a/b/c``; an empty subtree (optax's ``EmptyState``) is an
``{"empty": True}`` leaf. The shard file is written first into
``path.saving``, the manifest last (its presence means the directory is
complete), then ``path.saving`` is swapped in for ``path`` through
``path.old``: an interruption leaves the previous checkpoint, and the next
reader rolls the swap forward or back. A read checks every piece's crc32,
the folded crc32 of every leaf and the shard file's step against the
manifest.

:func:`read_state` detects the layout, so ``--last`` resumes from either.
Serving needs ``state["model"]`` only (:func:`load_state_dict`); training
restores the optimizer too unless ``drop_optimizer``
(:func:`load_training_state`).
"""

from __future__ import annotations

import logging
import os
import shutil
import zlib
from typing import Optional, Tuple

import numpy as np
from torch import nn

from ..models.convert import from_jax_params, to_jax_params
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


def load_state_dict(model: nn.Module, path) -> Optional[int]:
    """Load a checkpoint's model weights into ``model`` (cast to its dtype
    and device); returns the checkpoint's global step. A missing or torn
    checkpoint is logged and skipped, as the JAX reader does (returns
    None)."""
    state = _read_resumable(os.fspath(path))
    if state is None:
        return None
    model.load_state_dict(from_jax_params(state["model"]), strict=True)
    logger.info("Model weights were loaded from %s checkpoint.", path)
    return int(state.get("global_step") or 0)


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)   # no torn checkpoint on interrupt


def _training_groups(model: nn.Module, optimizer) -> dict:
    groups = {"model": to_jax_params(model.state_dict())}
    if optimizer is not None:
        groups["optimizer"] = optimizer.flax_state()
    return groups


def save_state_dict(path, *, model: nn.Module, optimizer=None,
                    global_step: int = 0, extra: Optional[dict] = None) -> None:
    """Write one checkpoint file in the JAX single-file layout (see the
    module docstring); ``optimizer`` is a ``train.optim.AdamW`` or None."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory (a sharded checkpoint?); write it with "
            f"save_state_dict_sharded or pick another path")
    groups = _training_groups(model, optimizer)
    state = {
        "model": groups["model"],
        "optimizer": groups.get("optimizer"),
        "scheduler": {"last_step": int(global_step)},
        "global_step": int(global_step),
    }
    if extra:
        state.update(extra)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_write(path, packb(state))
    logger.info("State dict was saved to %s.", path)


def load_training_state(path, *, model: nn.Module, optimizer=None,
                        drop_optimizer: bool = False) -> Optional[int]:
    """Restore weights and, unless ``drop_optimizer``, the optimizer state
    (moments and counts) from a checkpoint of either package and either
    layout; returns its global step, or None (logged) when there is no
    checkpoint to load."""
    state = _read_resumable(os.fspath(path))
    if state is None:
        return None
    model.load_state_dict(from_jax_params(state["model"]), strict=True)
    logger.info("Model weights were loaded from %s checkpoint.", path)
    if not drop_optimizer and optimizer is not None and \
            state.get("optimizer") is not None:
        optimizer.load_flax_state(state["optimizer"])
        logger.info("Optimizer and scheduler also were restored from %s "
                    "checkpoint.", path)
    return int(state.get("global_step") or 0)


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


def save_state_dict_sharded(path, *, model: nn.Module, optimizer=None,
                            global_step: int = 0,
                            extra: Optional[dict] = None) -> None:
    """Write the sharded-directory layout (see the module docstring) as one
    process of a one-device run: every leaf is one piece, and the manifest
    records ``shards`` 1 for it."""
    path = os.fspath(path)
    if os.path.isdir(path) and os.listdir(path) and \
            not os.path.exists(os.path.join(path, MANIFEST)):
        raise IsADirectoryError(
            f"checkpoint path {path} is a non-empty directory that is not a "
            f"sharded checkpoint; refusing to write into it")
    step = int(global_step)
    manifest = {"format": SHARDED_FORMAT, "global_step": step,
                "scheduler": {"last_step": step}, "process_count": 1,
                "groups": {}}
    if extra:
        manifest["extra"] = dict(extra)
    owned: dict = {}
    for gname, tree in _training_groups(model, optimizer).items():
        leaves = manifest["groups"][gname] = {}
        for key, leaf in _flatten(tree).items():
            if leaf is _EMPTY:
                leaves[key] = {"empty": True}
                continue
            arr = np.asarray(leaf)
            bounds = [[0, int(d)] for d in arr.shape]
            crc = _crc32_of(arr)
            owned.setdefault(gname, {})[key] = [
                {"bounds": bounds, "data": arr, "crc32": crc}]
            leaves[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                           "shards": 1,
                           "crc32": _fold_piece_crcs([(bounds, crc)])}
    manifest["shards"] = 1

    staging, old = path + ".saving", path + ".old"
    _recover_interrupted_swap(path, staging, old)
    for leftover in (staging, old):   # debris of an interrupted save
        _remove(leftover)
    os.makedirs(staging)
    _atomic_write(_shard_file(staging, 0),
                  packb({"global_step": step, "shards": owned}))
    # the manifest last: its presence marks the directory complete
    _atomic_write(os.path.join(staging, MANIFEST), packb(manifest))
    if os.path.exists(path):   # a single file or a directory
        os.rename(path, old)
    os.rename(staging, path)
    _remove(old)
    logger.info("Sharded state dict was saved to %s.", path)


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
    state["scheduler"] = manifest.get("scheduler", {"last_step": step})
    state["global_step"] = step
    state.update(manifest.get("extra") or {})
    return state
