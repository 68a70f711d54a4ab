"""Loss scaling, apex AMP's (the port of ``ml_recipe_tpu/train/loss_scale.py``).

The reference trains under apex's O1 mixed precision with loss scaling
(``--apex_loss_scale``); bf16 shares f32's exponent range and needs none,
so this exists for parity and for the users who ask for it:

- a static scale (``--apex_loss_scale 128``): each micro-batch loss is
  multiplied by S before ``backward()`` and the gradients by 1/S after;
- a dynamic scale (``--apex_loss_scale dynamic``, from 2^15): doubled
  after ``growth_interval`` consecutive finite steps, halved on a step
  whose gradients are not all finite, which then leaves the parameters,
  the optimizer state and its counts as they were.

The state is three host values (the step reads the finite flag on the
host anyway, and the scale multiplies the loss as a Python float); its
checkpoint group is the JAX ``LossScaleState``'s state dict.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

INIT_DYNAMIC_SCALE = 2.0 ** 15


@dataclass(frozen=True)
class LossScaleState:
    scale: float         # the f32 multiplier
    growth_count: int    # consecutive finite steps
    dynamic: bool        # static scales never change

    def state_dict(self) -> dict:
        """The JAX ``LossScaleState``'s flax state dict."""
        return {"scale": np.asarray(self.scale, np.float32),
                "growth_count": np.asarray(self.growth_count, np.int32),
                "dynamic": np.asarray(self.dynamic, np.bool_)}

    @classmethod
    def from_state_dict(cls, state: dict) -> "LossScaleState":
        return cls(scale=float(np.float32(state["scale"])),
                   growth_count=int(np.asarray(state["growth_count"])),
                   dynamic=bool(np.asarray(state["dynamic"])))


def init_state(flag) -> LossScaleState:
    """The state ``--apex_loss_scale`` asks for: ``'dynamic'`` starts at
    2^15, a number is a static scale; a scale <= 0 raises (it would zero
    every loss and make the unscaled gradients NaN)."""
    dynamic = flag == "dynamic"
    scale = INIT_DYNAMIC_SCALE if dynamic else float(flag)
    if scale <= 0:
        raise ValueError(f"apex_loss_scale must be positive or 'dynamic', "
                         f"got {flag!r} (0 would zero every loss and NaN the "
                         f"unscaled grads).")
    return LossScaleState(scale=float(np.float32(scale)), growth_count=0,
                          dynamic=dynamic)


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale


@torch.no_grad()
def unscale_(grads: List[torch.Tensor], state: LossScaleState) -> None:
    """Multiply every gradient in place by the f32 ``1/scale``."""
    torch._foreach_mul_(grads, float(np.float32(1.0) / np.float32(state.scale)))


@torch.no_grad()
def all_finite(grads: List[torch.Tensor]) -> bool:
    """Whether every element of every gradient is finite (one host read)."""
    if not grads:
        return True
    return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def update_state(state: LossScaleState, finite: bool, *,
                 growth_interval: int = 2000, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, max_scale: float = 2.0 ** 16,
                 min_scale: float = 2.0 ** -14) -> LossScaleState:
    """Apex's schedule: halve on overflow (floored at ``min_scale``, so a
    run of non-finite steps never takes the scale to 0), double after
    ``growth_interval`` consecutive finite steps (capped at ``max_scale``).
    A static state never changes."""
    if not state.dynamic:
        return replace(state, growth_count=0)
    f32 = np.float32
    grew = state.growth_count + 1 >= growth_interval
    if finite:
        scale = (min(f32(state.scale) * f32(growth_factor), f32(max_scale))
                 if grew else f32(state.scale))
    else:
        scale = max(f32(state.scale) * f32(backoff_factor), f32(min_scale))
    return replace(state, scale=float(scale),
                   growth_count=state.growth_count + 1
                   if finite and not grew else 0)
