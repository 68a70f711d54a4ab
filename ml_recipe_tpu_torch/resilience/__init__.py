"""Runtime resilience (the port of ``ml_recipe_tpu/resilience/``):

- :mod:`.supervisor` — the bounded-retry loop of ``--supervise``: classifies
  child exits (clean / preempted / hang / crash), resumes from the newest
  checkpoint, aborts a crash-loop with a diagnosis;
- :mod:`.watchdog` — a deadline monitor armed around steps, evals, saves
  and barriers; a missed deadline dumps every thread's stack and exits 87;
- :mod:`.faults` — the deterministic ``--fault_plan`` drills, with their
  sites threaded through the checkpoint writer, the loaders, the process
  world, the trainer and the serving engine;
- :mod:`.checkpoint_async` — the background checkpoint persist.

The elastic supervisor and its coordination plane are not ported
(ROADMAP.md queue 1, 'Runtime subsystems').
"""

from .faults import HOST_ENV, FaultError, FaultPlan, current_host, fire, install_plan
from .supervisor import (
    PREEMPT_EXIT_CODE,
    STATE_FILENAME,
    Attempt,
    RetryPolicy,
    Supervisor,
    SupervisorResult,
    classify_exit,
    peek_supervisor_state,
    write_supervisor_state,
)
from .watchdog import WATCHDOG_EXIT_CODE, Watchdog

__all__ = [
    "Attempt",
    "FaultError",
    "FaultPlan",
    "HOST_ENV",
    "PREEMPT_EXIT_CODE",
    "RetryPolicy",
    "STATE_FILENAME",
    "Supervisor",
    "SupervisorResult",
    "WATCHDOG_EXIT_CODE",
    "Watchdog",
    "classify_exit",
    "current_host",
    "fire",
    "install_plan",
    "peek_supervisor_state",
    "write_supervisor_state",
]
