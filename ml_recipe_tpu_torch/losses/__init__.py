"""Losses of the QA heads (the port of ``ml_recipe_tpu/losses``)."""

from .losses import (
    PackedWeightedLoss,
    WeightedLoss,
    binary_focal_loss,
    build_loss,
    cross_entropy_with_ignore,
    focal_loss,
    label_smoothing_loss,
    loss_denominator,
    masked_mse_loss,
    mse_loss,
)

__all__ = [
    "PackedWeightedLoss", "WeightedLoss", "binary_focal_loss", "build_loss",
    "cross_entropy_with_ignore", "focal_loss", "label_smoothing_loss",
    "loss_denominator", "masked_mse_loss", "mse_loss",
]
