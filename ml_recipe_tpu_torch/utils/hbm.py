"""Device-memory byte arithmetic shared by the memory pre-flight planners
(the port of ``ml_recipe_tpu/utils/hbm.py``).

One definition of "projected per-device bytes" for both planners:
``Trainer.preflight_train_step`` / ``preflight_bucket_steps`` (raise
``batch_split`` instead of running out of memory in a train step) and
``QAEngine.preflight_predict_step`` (shrink the serving bucket grid instead
of running out of memory mid-traffic). Lives in utils so the serving
request path does not import the training stack.

The JAX package reads XLA's ``memory_analysis()`` of a compiled program.
The port has no compiled program to ask, so :func:`measure` runs the step
once at its shape and reads the CUDA caching allocator: the bytes of the
tensors the step reads (``argument``), the bytes it leaves allocated
(``output``) and the peak above that during the step (``temp``). The four
sizes carry the JAX names, so :func:`preflight_bytes` is the same sum.

A step that runs out of memory while it is measured is the verdict the
planners exist for, not a missing analysis: :func:`measure` returns an
analysis marked ``out_of_memory`` whose sizes are a lower bound (the peak
reached and the allocation refused), and :func:`exceeds` says that it does
not fit whatever the limit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch


@dataclass
class MemoryAnalysis:
    """A measured step's bytes, under the names of XLA's
    ``CompiledMemoryStats``. ``temp_size_in_bytes`` is None where the device
    has no allocator statistics (the CPU): the planners then stand down.
    ``out_of_memory``: the step ran out of device memory while measured
    (the sizes are then a lower bound)."""

    argument_size_in_bytes: int
    output_size_in_bytes: Optional[int]
    temp_size_in_bytes: Optional[int]
    alias_size_in_bytes: int = 0
    out_of_memory: bool = False


def device_hbm_bytes(device: Optional[torch.device] = None) -> Optional[int]:
    """The card's memory in bytes, or ``None`` without CUDA (the CPU): the
    planners then stand down rather than guess."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    try:
        index = (torch.device(device).index if device is not None else None)
        props = torch.cuda.get_device_properties(
            index if index is not None else torch.cuda.current_device())
    except Exception:  # noqa: BLE001 - no properties = no limit knowledge
        return None
    total = int(getattr(props, "total_memory", 0) or 0)
    return total or None


def preflight_bytes(memory_analysis) -> Optional[int]:
    """Projected per-device requirement of a step: arguments + outputs +
    temporaries, minus the aliased bytes. ``None`` when the analysis is
    unavailable or malformed: the planner then stands down instead of acting
    on garbage."""
    if memory_analysis is None:
        return None
    try:
        need = (
            int(memory_analysis.argument_size_in_bytes)
            + int(memory_analysis.output_size_in_bytes)
            + int(memory_analysis.temp_size_in_bytes)
            - int(getattr(memory_analysis, "alias_size_in_bytes", 0))
        )
    except (AttributeError, TypeError, ValueError):
        return None
    return need if need > 0 else None


def exceeds(memory_analysis, need: int, limit: int) -> bool:
    """The step does not fit: its need is over the limit, or it ran out of
    memory while it was measured."""
    return need > limit or bool(getattr(memory_analysis, "out_of_memory",
                                        False))


_UNITS = {"B": 1, "KiB": 1 << 10, "MiB": 1 << 20, "GiB": 1 << 30,
          "TiB": 1 << 40}


def refused_bytes(message: str) -> int:
    """The allocation an out-of-memory error refused (``Tried to allocate
    2.00 GiB``), 0 when the message does not say."""
    match = re.search(r"Tried to allocate ([\d.]+) (B|KiB|MiB|GiB|TiB)",
                      message)
    return int(float(match.group(1)) * _UNITS[match.group(2)]) if match else 0


def tensor_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the given tensors' elements."""
    return int(sum(t.numel() * t.element_size() for t in tensors))


def measure(fn: Callable[[], object], device: torch.device, *,
            argument_bytes: int) -> Tuple[object, MemoryAnalysis]:
    """Run ``fn()`` once on ``device`` and return ``(its result, the
    analysis)``. On CUDA: ``output`` is what the call left allocated (its
    result and anything it keeps), ``temp`` the allocator's peak above that
    during the call, from ``torch.cuda.reset_peak_memory_stats``. Other
    processes' and earlier allocations cancel out of both. When the call
    runs out of memory the result is None and the analysis is marked
    ``out_of_memory``: ``temp`` is the peak it reached above the start and
    the allocation refused, and the allocator's cache is emptied. On the
    CPU ``fn`` runs and both are None."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn(), MemoryAnalysis(int(argument_bytes), None, None)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    refused = None
    try:
        result = fn()
    except torch.cuda.OutOfMemoryError as e:
        refused = refused_bytes(str(e))
    if refused is not None:
        # out of the except block: the traceback's frames, which held the
        # step's tensors, are gone, so the cache can be handed back
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()
        return None, MemoryAnalysis(
            argument_size_in_bytes=int(argument_bytes),
            output_size_in_bytes=0,
            temp_size_in_bytes=max(0, int(peak - before)) + refused,
            out_of_memory=True)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    after = torch.cuda.memory_allocated(device)
    return result, MemoryAnalysis(
        argument_size_in_bytes=int(argument_bytes),
        output_size_in_bytes=max(0, int(after - before)),
        temp_size_in_bytes=max(0, int(peak - max(after, before))))
