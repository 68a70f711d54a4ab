"""Read the JAX package's single-file checkpoints into the port's modules.

The JAX writer (``ml_recipe_tpu/train/checkpoint.py`` ``persist_state``)
stores one flax-msgpack file holding ``{"model", "optimizer", "scheduler",
"global_step", ...}``; serving needs ``state["model"]`` only, as the JAX
reader's ``load_state_dict`` does. The file is decoded by the port's own
msgpack reader (no ``flax``, no ``msgpack`` package) and mapped onto the
modules by ``models/convert.py``. Writing checkpoints, optimizer state and
the sharded-directory layout come with the training slice.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from torch import nn

from ..models.convert import from_jax_params
from ..utils.msgpack import unpackb

logger = logging.getLogger(__name__)


def read_state(path) -> dict:
    """The whole decoded checkpoint dict of a single-file checkpoint."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a sharded-directory checkpoint; the port reads the "
            f"single-file layout only (ROADMAP.md queue 1, 'Training')")
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
