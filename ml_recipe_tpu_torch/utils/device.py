"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``torch.device`` for an entry point: ``cuda`` when ``device`` is None.
    A CUDA device without CUDA raises; the port never carries on on the CPU
    unless the caller passed ``cpu`` itself."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested, but torch.cuda.is_available() "
            f"is False (no CUDA device or a CPU-only PyTorch build); pass "
            f"--device cpu (device='cpu') to run on the CPU on purpose")
    return dev
