"""Loss zoo in PyTorch (the port of ``ml_recipe_tpu/losses/losses.py``).

The same functions, on torch tensors, with the JAX package's arithmetic:

- ``cross_entropy_with_ignore``: mean NLL over rows whose target is not
  ``ignore_index``; optional per-class weights with torch
  ``CrossEntropyLoss(weight=...)``'s weighted-mean denominator;
- ``label_smoothing_loss``: KLDiv ``batchmean`` against the smoothed target
  distribution when ``smoothing > 0`` (the smoothing mass split over
  ``n_classes - num_ignore`` classes, ``num_ignore = 1 + (0 <= ignore_index
  < n_classes)``, and ``0 * log 0 := 0``), plain NLL otherwise;
- ``binary_focal_loss``, ``focal_loss`` (focal reweighting inside the NLL
  pick, with ignore-index masking) and ``mse_loss``;
- ``WeightedLoss``: the per-head aggregator returning ``(total, values)``
  with the unweighted per-head losses and ``values["loss"]``;
- ``build_loss``: the head table of ``init_loss`` (``--loss ce | focal |
  smooth``).

All losses take f32 logits (the model promotes) and integer/float targets.
``PackedWeightedLoss`` waits for sequence packing (ROADMAP.md queue 1).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits.float(), dim=-1)


def _pick(x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, targets.long()[..., None])[..., 0]


def cross_entropy_with_ignore(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    ignore_index: int = -1,
    class_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean NLL over rows whose target != ignore_index.

    With ``class_weights`` the mean is weighted by the target's class
    weight (torch ``CrossEntropyLoss(weight=...)`` denominator semantics)."""
    log_probs = _log_softmax(logits)
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets))
    nll = -_pick(log_probs, safe_targets)
    if class_weights is not None:
        w = class_weights.to(nll.device)[safe_targets.long()] * valid
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)
    valid_f = valid.float()
    return torch.sum(nll * valid_f) / torch.clamp(torch.sum(valid_f), min=1.0)


def label_smoothing_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    n_classes: int,
    smoothing: float = 0.0,
    ignore_index: int = -100,
) -> torch.Tensor:
    assert 0 <= smoothing <= 1
    log_probs = _log_softmax(logits)
    if smoothing <= 0:
        return cross_entropy_with_ignore(logits, targets,
                                         ignore_index=ignore_index)

    num_ignore = 1 + (0 <= ignore_index < n_classes)
    fill_value = smoothing / (n_classes - num_ignore)
    confidence = 1.0 - smoothing

    target_dist = torch.full((targets.shape[0], n_classes), fill_value,
                             dtype=torch.float32, device=log_probs.device)
    # jnp's `.at[rows, targets].set`: a negative target counts from the
    # end, one out of range is dropped (that row keeps the bare fill)
    t = targets.long()
    t = torch.where(t < 0, t + n_classes, t)
    hit = (t >= 0) & (t < n_classes)
    rows = torch.arange(targets.shape[0], device=t.device)
    target_dist[rows[hit], t[hit]] = confidence
    if 0 <= ignore_index < n_classes:
        target_dist[:, ignore_index] = 0.0

    # KLDivLoss(reduction='batchmean'): sum over classes of t*(log t - log p),
    # averaged over the batch; 0*log(0) := 0
    t_log_t = torch.where(target_dist > 0,
                          target_dist * torch.log(target_dist),
                          torch.zeros_like(target_dist))
    kl = torch.sum(t_log_t - target_dist * log_probs, dim=-1)
    return torch.mean(kl)


def binary_focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                      alpha: float = 1.0, gamma: float = 2.0) -> torch.Tensor:
    logits = logits.float()
    targets = targets.float()
    # stable BCE-with-logits
    bce = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    probs = torch.exp(-bce)
    return torch.mean(alpha * (1 - probs) ** gamma * bce)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
               alpha: float = 1.0, gamma: float = 2.0,
               ignore_index: int = -1) -> torch.Tensor:
    log_probs = _log_softmax(logits)
    probs = torch.exp(log_probs)
    weighted = alpha * (1 - probs) ** gamma * log_probs
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets))
    picked = -_pick(weighted, safe_targets)
    valid_f = valid.float()
    return torch.sum(picked * valid_f) / torch.clamp(torch.sum(valid_f), min=1.0)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((preds.float() - targets.float()) ** 2)


class WeightedLoss:
    """Weighted sum of per-head losses (reference loss.py:74-106).

    ``losses`` maps head name -> (loss_fn, weight). ``__call__`` returns
    ``(total_loss, {head: value})``; per-head values are the *unweighted*
    losses, and ``values["loss"]`` is the total."""

    def __init__(self, losses: Dict[str, Tuple[Callable, float]]):
        self._losses = losses

    @property
    def keys(self):
        return self._losses.keys()

    def __call__(self, preds: dict, targets: dict) -> Tuple[torch.Tensor, dict]:
        assert set(preds.keys()) >= set(self._losses.keys())
        assert set(targets.keys()) >= set(self._losses.keys())
        values = {}
        full_loss = 0.0
        for key, (loss_f, weight) in self._losses.items():
            loss = loss_f(preds[key], targets[key])
            values[key] = loss
            full_loss = full_loss + weight * loss
        values["loss"] = full_loss
        return full_loss, values


def build_loss(params, train_weights: Optional[dict] = None) -> WeightedLoss:
    """Select the classification loss + per-head weights (init.py:18-40)."""
    label_weights = None
    if train_weights is not None and train_weights.get("label_weights") is not None:
        label_weights = torch.as_tensor(train_weights["label_weights"],
                                        dtype=torch.float32)

    n_classes = 5
    if params.loss == "ce":
        class_loss = functools.partial(
            cross_entropy_with_ignore, ignore_index=-100,
            class_weights=label_weights)
    elif params.loss == "focal":
        # reference FocalLossWithLogits defaults to ignore_index=-1
        class_loss = functools.partial(
            focal_loss, alpha=params.focal_alpha, gamma=params.focal_gamma,
            ignore_index=-1)
    elif params.loss == "smooth":
        class_loss = functools.partial(
            label_smoothing_loss, n_classes=n_classes,
            smoothing=params.smooth_alpha)
    else:
        raise NotImplementedError(f"Unknown loss {params.loss}")

    def _wght(name):
        return getattr(params, name, 1)

    span_ce = functools.partial(cross_entropy_with_ignore, ignore_index=-1)
    return WeightedLoss({
        "start_class": (span_ce, _wght("w_start")),
        "end_class": (span_ce, _wght("w_end")),
        "start_reg": (mse_loss, _wght("w_start_reg")),
        "end_reg": (mse_loss, _wght("w_end_reg")),
        "cls": (class_loss, _wght("w_cls")),
    })
