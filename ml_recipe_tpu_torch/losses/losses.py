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

Global denominators (data parallelism): each loss divides a sum over its
rows by a denominator (valid rows, class-weight sums or rows), which
:func:`loss_denominator` computes unclamped from the targets alone. A
process holding some of a global micro-batch's rows passes the
denominator summed over every process as ``denominator``; the loss clamps
it and divides its own rows' sum by it, so the processes' losses (and
gradients) sum to the loss over the whole micro-batch. Without
``denominator`` every loss computes what it computed before, bit for bit.
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


def _ce_row_weights(targets: torch.Tensor, ignore_index: int,
                    class_weights: Optional[torch.Tensor]):
    """``(safe targets, per-row weight)``: the weight is the target's class
    weight (or 1), 0 where the target is ``ignore_index``."""
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, torch.zeros_like(targets))
    if class_weights is not None:
        w = class_weights.to(targets.device)[safe_targets.long()] * valid
        return safe_targets, w
    return safe_targets, valid.float()


def _ce_denominator(targets: torch.Tensor, *, ignore_index: int = -1,
                    class_weights: Optional[torch.Tensor] = None,
                    **_) -> torch.Tensor:
    return torch.sum(_ce_row_weights(targets, ignore_index, class_weights)[1])


def cross_entropy_with_ignore(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    ignore_index: int = -1,
    class_weights: Optional[torch.Tensor] = None,
    denominator: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean NLL over rows whose target != ignore_index.

    With ``class_weights`` the mean is weighted by the target's class
    weight (torch ``CrossEntropyLoss(weight=...)`` denominator semantics).
    ``denominator``: the global unclamped denominator (module docstring)."""
    log_probs = _log_softmax(logits)
    safe_targets, w = _ce_row_weights(targets, ignore_index, class_weights)
    nll = -_pick(log_probs, safe_targets)
    den = torch.sum(w) if denominator is None else denominator
    return torch.sum(nll * w) / torch.clamp(
        den, min=1e-12 if class_weights is not None else 1.0)


def label_smoothing_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    n_classes: int,
    smoothing: float = 0.0,
    ignore_index: int = -100,
    denominator: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    assert 0 <= smoothing <= 1
    log_probs = _log_softmax(logits)
    if smoothing <= 0:
        return cross_entropy_with_ignore(logits, targets,
                                         ignore_index=ignore_index,
                                         denominator=denominator)

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
    return _mean(kl, denominator)


def _mean(x: torch.Tensor, denominator: Optional[torch.Tensor]) -> torch.Tensor:
    """``torch.mean(x)``, or ``x``'s sum over a global element count."""
    return torch.mean(x) if denominator is None else torch.sum(x) / denominator


def _numel_denominator(targets: torch.Tensor, **_) -> torch.Tensor:
    return torch.tensor(float(targets.numel()), device=targets.device)


def _smoothing_denominator(targets: torch.Tensor, *, smoothing: float = 0.0,
                           ignore_index: int = -100, **_) -> torch.Tensor:
    if smoothing <= 0:
        return _ce_denominator(targets, ignore_index=ignore_index)
    return _numel_denominator(targets)


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
               ignore_index: int = -1,
               denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    log_probs = _log_softmax(logits)
    probs = torch.exp(log_probs)
    weighted = alpha * (1 - probs) ** gamma * log_probs
    safe_targets, valid_f = _ce_row_weights(targets, ignore_index, None)
    picked = -_pick(weighted, safe_targets)
    den = torch.sum(valid_f) if denominator is None else denominator
    return torch.sum(picked * valid_f) / torch.clamp(den, min=1.0)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor, *,
             denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _mean((preds.float() - targets.float()) ** 2, denominator)


_DENOMINATORS = {
    cross_entropy_with_ignore: _ce_denominator,
    label_smoothing_loss: _smoothing_denominator,
    focal_loss: _ce_denominator,
    mse_loss: _numel_denominator,
}


def loss_denominator(loss_f: Callable, targets: torch.Tensor) -> torch.Tensor:
    """The unclamped f32 denominator ``loss_f`` (a loss of this module, or a
    ``functools.partial`` of one) divides its sum by over ``targets``'s
    rows."""
    func, kw = ((loss_f.func, loss_f.keywords)
                if isinstance(loss_f, functools.partial) else (loss_f, {}))
    if func not in _DENOMINATORS:
        raise TypeError(f"no denominator is known for loss {func!r}")
    return _DENOMINATORS[func](targets, **kw).float()


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

    def denominators(self, targets: dict) -> torch.Tensor:
        """The heads' unclamped denominators over ``targets``, a ``[heads]``
        f32 tensor in :attr:`keys` order (:func:`loss_denominator`)."""
        return torch.stack([loss_denominator(loss_f, targets[key])
                            for key, (loss_f, _) in self._losses.items()])

    def __call__(self, preds: dict, targets: dict,
                 denominators: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
        """``denominators``: the global ``[heads]`` denominators (summed
        :meth:`denominators` of every process's rows), or None for the
        rows given."""
        assert set(preds.keys()) >= set(self._losses.keys())
        assert set(targets.keys()) >= set(self._losses.keys())
        values = {}
        full_loss = 0.0
        for i, (key, (loss_f, weight)) in enumerate(self._losses.items()):
            if denominators is None:
                loss = loss_f(preds[key], targets[key])
            else:
                loss = loss_f(preds[key], targets[key],
                              denominator=denominators[i])
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
