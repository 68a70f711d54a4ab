"""The exit-code contract of ``ml_recipe_tpu/resilience/supervisor.py``:
``CLEAN`` and ``classify_exit``, which the fleet manager applies to its
engine children. The training supervisor itself (``--supervise``) is not
ported (ROADMAP.md queue 1, 'Runtime subsystems')."""

from __future__ import annotations

import signal

__all__ = ["CLEAN", "CRASH", "HANG", "PREEMPTED", "classify_exit"]

# the JAX package's watchdog abort code (resilience/watchdog.py)
WATCHDOG_EXIT_CODE = 87
# a supervised child that caught SIGTERM/SIGINT and unwound cleanly
# (EX_TEMPFAIL): a preemption is a reason to resume, not to stop
PREEMPT_EXIT_CODE = 75

CLEAN = "clean"
PREEMPTED = "preempted"
HANG = "hang"
CRASH = "crash"


def classify_exit(returncode: int) -> str:
    """Map a child return code onto an exit class."""
    if returncode == 0:
        return CLEAN
    if returncode == WATCHDOG_EXIT_CODE:
        return HANG
    if returncode == PREEMPT_EXIT_CODE:
        return PREEMPTED
    # Popen reports death-by-signal as -signum; platform evictions that
    # skip the SIGTERM hook surface as SIGKILL/SIGTERM here. 128+signum
    # covers shells that re-encode it.
    for sig in (signal.SIGTERM, signal.SIGKILL, signal.SIGHUP):
        if returncode in (-int(sig), 128 + int(sig)):
            return PREEMPTED
    return CRASH
