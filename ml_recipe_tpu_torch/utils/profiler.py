"""Profiling hooks (the port of ``ml_recipe_tpu/utils/profiler.py``).

:class:`StepTimer` times steps honestly under CUDA's asynchronous
launches: it synchronizes the devices of the step's result before it reads
the clock, where the JAX package blocks until the result is ready.
:func:`device_trace` is a ``torch.profiler`` capture of a block, the
trainer's ``--trace`` window (``metrics.trace.ProfilerWindow``) over one
step. The wall-time decorator ``time_profiler`` lives in
``metrics/trace.py``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from ..metrics.trace import ProfilerWindow


def _cuda_devices(tree) -> set:
    """The CUDA devices of every tensor in a nested dict/list/tuple."""
    found = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return found


class StepTimer:
    """Per-step timing that is honest under asynchronous launches.

    ``stop(result)`` synchronizes every CUDA device that holds a tensor of
    ``result`` before it reads the clock, so the interval covers the
    device's execution, not just the launches. Keeps a running mean that
    skips the first ``warmup`` steps (kernel-library loads, allocator
    growth).
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            for device in _cuda_devices(result):
                torch.cuda.synchronize(device)
        assert self._t0 is not None, "StepTimer.stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return dt

    def mean(self) -> float:
        steady = self.count - self.warmup
        return self.total / steady if steady > 0 else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], *, device="cpu"):
    """``torch.profiler`` capture of the block, exported as a Chrome trace
    (``profile_p0_steps0-0.json``) into ``log_dir``; no-op when
    ``log_dir`` is None. On a CUDA ``device`` a capture without CUDA
    activity raises instead of writing a CPU-only trace."""
    if log_dir is None:
        yield
        return
    window = ProfilerWindow(log_dir, start=0, steps=1, device=device,
                            captures=1)
    window.on_step_start()
    try:
        yield
    finally:
        window.finish()
