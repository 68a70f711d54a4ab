"""Optimizer, LR schedule and gradient clipping (the port of ``ml_recipe_tpu/train/optim.py``).

The JAX package builds one optax chain (``build_optimizer``, ``--optimizer
adam``): HF ``AdamW(correct_bias=False)`` moments with ``eps=1e-6``, then
``add_decayed_weights`` under ``no_decay_mask``, then
``scale_by_learning_rate(linear_warmup_schedule)``. :class:`AdamW` is that
chain over a dict of f32 parameters, updated in place with
``torch._foreach_*`` ops in the chain's order and rounding:

    mu = b1*mu + (1-b1)*g;  nu = b2*nu + ((1-b2)*g)*g;  u = mu/(sqrt(nu)+eps)
    u = u + wd*p   (decaying leaves only);  p = p + u*(-lr)

with ``lr = schedule(count)`` read BEFORE the count advances, so step 0
trains at ``schedule(0)`` (0 under warmup). ``torch.optim.AdamW`` is not a
substitute: it always bias-corrects and decays as ``p *= 1 - lr*wd``.

:func:`clip_by_global_norm_` is the train step's clip, ``g * c / max(norm,
c)`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``).

:meth:`AdamW.flax_state` / :meth:`AdamW.load_flax_state` read and write the
optax chain's state-dict layout, so checkpoints cross between the packages.
``--optimizer adamod`` and fine-tune masks (``--finetune``) are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from ..models.convert import from_jax_params, to_jax_params


def linear_warmup_schedule(lr: float, num_warmup_steps: int,
                           num_training_steps: int) -> Callable[[int], float]:
    """LR(step): step/warmup * lr, then linear decay to 0 (HF semantics),
    in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < num_warmup_steps:
            factor = s / f32(max(num_warmup_steps, 1))
        else:
            factor = max((f32(num_training_steps) - s)
                         / f32(max(num_training_steps - num_warmup_steps, 1)),
                         f32(0.0))
        return float(f32(lr) * f32(factor))

    return schedule


def constant_schedule(lr: float) -> Callable[[int], float]:
    value = float(np.float32(lr))
    return lambda step: value


def no_decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True where weight decay applies: everything except biases and any
    parameter under a ``layer_norm`` module (reference init.py:125-129)."""
    mask = {}
    for name in names:
        parts = name.split(".")
        mask[name] = not (parts[-1] == "bias"
                          or any("layer_norm" in p for p in parts))
    return mask


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``
    (optax ``clip_by_global_norm``); returns the f32 global norm. No host
    synchronisation."""
    norms = torch._foreach_norm(grads)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


class AdamW:
    """``build_optimizer``'s ``adam`` chain over named f32 parameters."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], *,
                 schedule: Callable[[int], float], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
        self.params = dict(params)
        for name, p in self.params.items():
            if p.dtype != torch.float32:
                raise ValueError(f"{name}: the optimizer updates f32 master "
                                 f"weights; got {p.dtype}")
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decay = no_decay_mask(self.params)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0           # ScaleByAdamState.count
        self.schedule_count = 0  # ScaleByScheduleState.count

    def lr(self) -> float:
        """The learning rate the next :meth:`step` applies."""
        return self.schedule(self.schedule_count)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> float:
        """Apply one update from ``grads`` (f32, by name); returns the lr
        it applied."""
        lr = self.lr()
        names = list(self.params)
        ps = [self.params[n] for n in names]
        gs = [grads[n] for n in names]
        mus = [self.mu[n] for n in names]
        nus = [self.nu[n] for n in names]

        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - self.b1))
        sq = torch._foreach_mul(gs, 1.0 - self.b2)
        torch._foreach_mul_(sq, gs)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, sq)
        den = torch._foreach_sqrt(nus)
        torch._foreach_add_(den, self.eps)
        updates = torch._foreach_div(mus, den)

        decaying = [i for i, n in enumerate(names) if self.decay[n]]
        if self.weight_decay and decaying:
            torch._foreach_add_(
                [updates[i] for i in decaying],
                torch._foreach_mul([ps[i] for i in decaying],
                                   self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(ps, updates)
        self.count += 1
        self.schedule_count += 1
        return lr

    # -- the optax chain's state-dict layout ---------------------------------

    def flax_state(self) -> dict:
        """``flax.serialization.to_state_dict`` of the JAX optimizer state:
        ``chain(scale_by_adam, masked(add_decayed_weights),
        scale_by_schedule)`` wrapped in the outer one-element chain."""
        return {"0": {
            "0": {"count": np.asarray(self.count, np.int32),
                  "mu": to_jax_params(self.mu),
                  "nu": to_jax_params(self.nu)},
            "1": {"inner_state": {}},
            "2": {"count": np.asarray(self.schedule_count, np.int32)},
        }}

    @torch.no_grad()
    def load_flax_state(self, state: dict) -> None:
        """Restore from :meth:`flax_state`'s layout (a JAX checkpoint's
        ``optimizer`` entry); raises on a different chain."""
        try:
            core = state["0"]
            adam, sched = core["0"], core["2"]
            mu, nu = from_jax_params(adam["mu"]), from_jax_params(adam["nu"])
        except (KeyError, TypeError) as exc:
            raise ValueError(
                f"checkpoint optimizer state is not the adam chain's layout "
                f"({exc!r}); adamod and fine-tune chains are not ported") from exc
        if set(mu) != set(self.params) or set(nu) != set(self.params):
            raise ValueError("checkpoint optimizer moments do not match the "
                             "model's parameters")
        for name, p in self.params.items():
            if mu[name].shape != p.shape or nu[name].shape != p.shape:
                raise ValueError(f"{name}: moment shape {tuple(mu[name].shape)}"
                                 f" != parameter shape {tuple(p.shape)}")
            self.mu[name].copy_(mu[name])
            self.nu[name].copy_(nu[name])
        self.count = int(np.asarray(adam["count"]))
        self.schedule_count = int(np.asarray(sched["count"]))


def build_optimizer(trainer_params, params: Dict[str, torch.nn.Parameter], *,
                    num_training_steps: int, warmup_coef=None) -> AdamW:
    """Optimizer + schedule (reference init.py:134-145, trainer.py:116-126).
    ``warmup_coef``, when given, overrides ``trainer_params.warmup_coef``."""
    if getattr(trainer_params, "optimizer", "adam") != "adam":
        raise NotImplementedError(
            f"--optimizer {trainer_params.optimizer} is not ported to "
            f"ml_recipe_tpu_torch yet (ROADMAP.md queue 1, 'Training: the parts still to port')")
    if getattr(trainer_params, "finetune", False):
        raise NotImplementedError(
            "--finetune (trainable masks) is not ported to ml_recipe_tpu_torch "
            "yet (ROADMAP.md queue 1, 'Training: the parts still to port')")
    if warmup_coef is None:
        warmup_coef = getattr(trainer_params, "warmup_coef", 0.0)
    lr = trainer_params.lr
    if warmup_coef and warmup_coef > 0:
        schedule = linear_warmup_schedule(
            lr, int(num_training_steps * warmup_coef), num_training_steps)
    else:
        schedule = constant_schedule(lr)
    return AdamW(params, schedule=schedule,
                 weight_decay=trainer_params.weight_decay)
