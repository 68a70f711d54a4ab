"""Host RNG seeding (the port of ``ml_recipe_tpu/utils/seed.py``).

``set_seed(seed)`` seeds python's and numpy's global RNGs and returns an
:class:`RngPool` whose ``host_rng(purpose)`` numpy generators match the JAX
package's draw for draw (``SeedSequence([seed, purpose index, step])``), so
a dataset seeded from it holds the same items in both packages. Device
randomness (dropout) does not come from here: the trainer seeds explicit
``torch.Generator``s from ``(seed, step)``.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def set_seed(seed: Optional[int] = None) -> Optional["RngPool"]:
    """Seed the host RNGs; ``None`` leaves them unseeded and returns None."""
    if seed is None:
        return None
    random.seed(seed)
    np.random.seed(seed)
    logger.info(f"Random seed was set to {seed}.")
    return RngPool(seed)


@dataclass
class RngPool:
    seed: int
    _purposes: dict = field(default_factory=dict)

    def host_rng(self, purpose: str, step: int = 0) -> np.random.Generator:
        """Numpy generator for one host-side purpose."""
        if purpose not in self._purposes:
            self._purposes[purpose] = len(self._purposes) + 1
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self._purposes[purpose], step]))
