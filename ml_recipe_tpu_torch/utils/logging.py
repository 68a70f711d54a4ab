"""Logging utilities (the port of ``ml_recipe_tpu/utils/logging.py``'s
``show_params``: the reference's ``modules/utils.py`` parameter block that
every CLI logs before it builds anything)."""

from __future__ import annotations

import logging
from typing import Optional


def show_params(params, name: str, logger: Optional[logging.Logger] = None) -> None:
    """Log every field of a config namespace/dataclass, sorted by name."""
    log = logger or logging.getLogger(__name__)
    log.info(f"Input {name} parameters:")
    fields = params.__dict__ if hasattr(params, "__dict__") else dict(params)
    for k in sorted(fields.keys()):
        log.info(f"\t\t{k}: {fields[k]}")
