"""Losses of the QA heads (the port of ``ml_recipe_tpu/losses``)."""

from .losses import (
    WeightedLoss,
    binary_focal_loss,
    build_loss,
    cross_entropy_with_ignore,
    focal_loss,
    label_smoothing_loss,
    mse_loss,
)

__all__ = [
    "WeightedLoss", "binary_focal_loss", "build_loss",
    "cross_entropy_with_ignore", "focal_loss", "label_smoothing_loss",
    "mse_loss",
]
