"""Single-file checkpoints in the JAX package's layout, read and written.

The JAX writer (``ml_recipe_tpu/train/checkpoint.py`` ``persist_state``)
stores one flax-msgpack file holding ``{"model", "optimizer", "scheduler",
"global_step", ...}`` plus the trainer's ``extra`` topology record. The
port reads and writes exactly that, with its own msgpack codec (no
``flax``, no ``msgpack`` package):

- ``model``: the flax params tree (``models/convert.py`` maps it onto the
  modules name for name);
- ``optimizer``: the optax chain's state-dict layout (``train/optim.py``
  ``AdamW.flax_state``), so the JAX ``Trainer.load_state_dict`` restores a
  port checkpoint and the port resumes a JAX one;
- ``global_step`` and ``scheduler`` ``{"last_step": step}``.

Writes are atomic (a temporary file, then a rename). Serving needs
``state["model"]`` only (:func:`load_state_dict`); training restores the
optimizer too unless ``drop_optimizer`` (:func:`load_training_state`). The
sharded-directory layout is not ported (ROADMAP.md queue 1).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from torch import nn

from ..models.convert import from_jax_params, to_jax_params
from ..utils.msgpack import packb, unpackb

logger = logging.getLogger(__name__)


def read_state(path) -> dict:
    """The whole decoded checkpoint dict of a single-file checkpoint."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a sharded-directory checkpoint; the port reads the "
            f"single-file layout only (ROADMAP.md queue 1, 'Training: the parts still to port')")
    with open(path, "rb") as fh:
        state = unpackb(fh.read())
    if not isinstance(state, dict) or "model" not in state:
        raise ValueError(f"{path}: not a checkpoint (no 'model' entry)")
    return state


def load_params(path) -> Tuple[dict, int]:
    """``(state["model"] as a nested dict of numpy, global_step)``."""
    state = read_state(path)
    return state["model"], int(state.get("global_step") or 0)


def load_state_dict(model: nn.Module, path) -> Optional[int]:
    """Load a checkpoint's model weights into ``model`` (cast to its dtype
    and device); returns the checkpoint's global step. A missing file is
    logged and skipped, as the JAX reader does (returns None)."""
    if not os.path.exists(os.fspath(path)):
        logger.warning("Checkpoint %s does not exist, so checkpoint was not "
                       "loaded.", path)
        return None
    params, step = load_params(path)
    model.load_state_dict(from_jax_params(params), strict=True)
    logger.info("Model weights were loaded from %s checkpoint.", path)
    return step


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)   # no torn checkpoint on interrupt


def save_state_dict(path, *, model: nn.Module, optimizer=None,
                    global_step: int = 0, extra: Optional[dict] = None) -> None:
    """Write one checkpoint file in the JAX single-file layout (see the
    module docstring); ``optimizer`` is a ``train.optim.AdamW`` or None."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (a sharded checkpoint?); the port writes "
            f"the single-file layout only (ROADMAP.md queue 1, 'Training: the parts still to port')")
    state = {
        "model": to_jax_params(model.state_dict()),
        "optimizer": optimizer.flax_state() if optimizer is not None else None,
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
    (moments and counts) from a checkpoint of either package; returns its
    global step, or None (logged) when the file does not exist."""
    if not os.path.exists(os.fspath(path)):
        logger.warning("Checkpoint %s does not exist, so checkpoint was not "
                       "loaded.", path)
        return None
    state = read_state(path)
    model.load_state_dict(from_jax_params(state["model"]), strict=True)
    logger.info("Model weights were loaded from %s checkpoint.", path)
    if not drop_optimizer and optimizer is not None and \
            state.get("optimizer") is not None:
        optimizer.load_flax_state(state["optimizer"])
        logger.info("Optimizer and scheduler also were restored from %s "
                    "checkpoint.", path)
    return int(state.get("global_step") or 0)
