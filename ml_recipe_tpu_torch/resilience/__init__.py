"""Runtime resilience (the port of ``ml_recipe_tpu/resilience/``):

- :mod:`.supervisor` — the bounded-retry loop of ``--supervise``: classifies
  child exits (clean / preempted / hang / crash), resumes from the newest
  checkpoint, aborts a crash-loop with a diagnosis;
- :mod:`.watchdog` — a deadline monitor armed around steps, evals, saves
  and barriers; a missed deadline dumps every thread's stack and exits 87;
- :mod:`.faults` — the deterministic ``--fault_plan`` drills, with their
  sites threaded through the checkpoint writer, the loaders, the process
  world, the trainer and the serving engine;
- :mod:`.checkpoint_async` — the background checkpoint persist;
- :mod:`.coordination` — the elastic pod's plane: per-host heartbeat
  files under ``<exp_dir>/pod/``, published and read by one
  ``ElasticSupervisor`` per host (``--elastic on``).
"""

from .coordination import (
    COORD_DIRNAME,
    ELASTIC_WORLD_ENV,
    CoordinationSchemaError,
    PodCoordinator,
    read_coordination_json,
    write_child_heartbeat,
)
from .faults import HOST_ENV, FaultError, FaultPlan, current_host, fire, install_plan
from .supervisor import (
    PREEMPT_EXIT_CODE,
    STATE_FILENAME,
    Attempt,
    ElasticSupervisor,
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
    "COORD_DIRNAME",
    "CoordinationSchemaError",
    "ELASTIC_WORLD_ENV",
    "ElasticSupervisor",
    "FaultError",
    "FaultPlan",
    "HOST_ENV",
    "PREEMPT_EXIT_CODE",
    "PodCoordinator",
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
    "read_coordination_json",
    "write_child_heartbeat",
    "write_supervisor_state",
]
