"""Auto-resume supervisor: the local analogue of an elastic agent (the port
of ``ml_recipe_tpu/resilience/supervisor.py``'s fixed-world supervision).

Wraps the training entrypoint in a bounded-retry loop (``--supervise`` on
the train CLI). Each attempt is a child process; on exit the supervisor

1. classifies the exit — clean / preempted / hang (watchdog abort) /
   crash — from the return code,
2. measures progress by peeking ``global_step`` out of the newest on-disk
   checkpoint (no cooperation from the child needed: a hard-killed child
   reports through what it durably saved, which is the only truth anyway),
3. restarts with ``--last <newest checkpoint>`` after an exponential
   backoff with seeded jitter (deterministic: drills replay identically),
4. aborts with a diagnosis once ``crash_loop_window`` consecutive failed
   attempts made NO checkpoint progress — a crash-loop restarted forever
   is strictly worse than a loud early exit with the failure classified.

The supervisor deliberately knows nothing about torch: it manages a
process and a checkpoint directory. ``classify_exit`` is also the fleet
manager's contract for its engine children. The elastic, cross-host
supervisor (``--elastic``) and its coordination plane are not ported
(ROADMAP.md queue 1, 'Runtime subsystems'): ``--elastic`` is refused.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import subprocess
import sys
import time
from datetime import datetime, timezone
from typing import Callable, List, Optional, Sequence

from .watchdog import WATCHDOG_EXIT_CODE

logger = logging.getLogger(__name__)

__all__ = [
    "CLEAN", "CRASH", "HANG", "PREEMPTED", "PREEMPT_EXIT_CODE",
    "STATE_FILENAME", "SUPERVISED_ENV", "Attempt", "RetryPolicy",
    "Supervisor", "SupervisorResult", "build_child_argv", "classify_exit",
    "newest_checkpoint", "peek_supervisor_state", "supervise_cli",
    "write_supervisor_state",
]

# JSON sidecar the supervisor keeps current next to the checkpoints, so the
# training exporter (and humans) read restart counts / exit classifications
# / backoff state without parsing logs. Written atomically (tmp + rename):
# a reader never sees a torn document.
STATE_FILENAME = "supervisor_state.json"

# the sidecar's schema, the JAX package's coordination schema version: a
# sidecar written by an incompatible build is rejected, never acted on
SCHEMA_VERSION = 1


class SidecarSchemaError(RuntimeError):
    """A sidecar document carries a different (or missing) schema version."""


def write_supervisor_state(path, state: dict) -> None:
    """Atomically persist the supervisor's observable state (stamped with
    :data:`SCHEMA_VERSION`)."""
    path = os.fspath(path)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    doc = dict(state)
    doc.setdefault("schema", SCHEMA_VERSION)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2)
    os.replace(tmp, path)


def read_sidecar_json(path, *, retries: int = 3, base_delay: float = 0.05,
                      factor: float = 2.0, sleep=time.sleep) -> Optional[dict]:
    """The guarded read of a sidecar (the JAX package's
    ``read_coordination_json``): an absent file is None at once; torn or
    unparsable content is retried with bounded backoff, then None with a
    warning; a schema mismatch raises :class:`SidecarSchemaError`."""
    path = os.fspath(path)
    delay = base_delay
    for attempt in range(retries + 1):
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            if attempt == retries:
                logger.warning(
                    f"SUPERVISOR: sidecar unreadable after {retries + 1} "
                    f"attempt(s): {path}: {e!r}; treating as absent.")
                return None
            logger.warning(
                f"SUPERVISOR: torn read of {path} (attempt {attempt + 1}/"
                f"{retries + 1}): {e!r}; retrying in {delay:.2f}s.")
            sleep(delay)
            delay *= factor
            continue
        if not isinstance(doc, dict):
            logger.warning(f"SUPERVISOR: non-object document in {path}; "
                           f"ignoring.")
            return None
        schema = doc.get("schema")
        if schema != SCHEMA_VERSION:
            raise SidecarSchemaError(
                f"{path} carries schema {schema!r}, this build requires "
                f"{SCHEMA_VERSION} — written by an incompatible (older?) "
                f"build; refusing to interpret it.")
        return doc
    return None


def peek_supervisor_state(path) -> Optional[dict]:
    """Best-effort read of the sidecar; None when absent or unreadable
    (an exporter scrape must never crash on a mid-replace race or a
    corrupt file); a sidecar written by an incompatible build is rejected
    loudly."""
    try:
        return read_sidecar_json(path)
    except SidecarSchemaError as e:
        logger.error(f"SUPERVISOR: rejecting sidecar: {e}")
        return None

# A supervised child that caught SIGTERM/SIGINT, saved interrupt.ch and
# unwound cleanly exits with this (EX_TEMPFAIL) instead of 0, so the
# supervisor restarts it — a preemption is a reason to resume, not to stop.
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
    # covers shells that re-encode it. An injected drill kill
    # (KILL_EXIT_CODE) stays a crash: mid-write kills are the scenario
    # being tested, not an infra event to blame.
    for sig in (signal.SIGTERM, signal.SIGKILL, signal.SIGHUP):
        if returncode in (-int(sig), 128 + int(sig)):
            return PREEMPTED
    return CRASH


@dataclasses.dataclass
class RetryPolicy:
    # Restarts chargeable AFTER the first attempt. Only failures WITHOUT
    # checkpoint progress consume the budget: on preemptible pools a
    # healthy multi-day run is preempted far more than any fixed budget,
    # and a preemption that resumed and advanced global_step is the system
    # WORKING, not failing. Pathological progress-making crash cycles are
    # still bounded by the crash-loop detector the moment progress stops.
    max_restarts: int = 5
    backoff_base: float = 1.0      # seconds before restart #1
    backoff_factor: float = 2.0
    backoff_max: float = 30.0
    jitter: float = 0.1            # +-10% seeded jitter (thundering herd)
    crash_loop_window: int = 3     # consecutive no-progress failures -> abort
    seed: int = 0


@dataclasses.dataclass
class Attempt:
    index: int
    returncode: int
    outcome: str
    step_before: Optional[int]
    step_after: Optional[int]
    backoff: float = 0.0           # sleep AFTER this attempt (0 = none)

    @property
    def progressed(self) -> bool:
        if self.step_after is None:
            return False
        return self.step_before is None or self.step_after > self.step_before


@dataclasses.dataclass
class SupervisorResult:
    status: str        # 'clean' | 'crash-loop' | 'retries-exhausted' | 'terminated'
    attempts: List[Attempt]
    diagnosis: str = ""
    signum: Optional[int] = None   # set when status == 'terminated'

    @property
    def exit_code(self) -> int:
        if self.signum is not None:
            return 128 + int(self.signum)  # shell convention: died by signal
        return {"clean": 0, "crash-loop": 1}.get(self.status, 2)

    def outcomes(self) -> List[str]:
        return [a.outcome for a in self.attempts]


class Supervisor:
    """Bounded-retry loop around a launchable child.

    ``launch(attempt_index)`` returns either a ``Popen``-like object (with
    ``wait``/``send_signal``) or a bare int return code (tests). ``progress()``
    returns the newest durable ``global_step`` (or None) — called before
    and after every attempt. ``sleep`` is injectable so drills don't
    actually wait out the backoff.
    """

    def __init__(
        self,
        launch: Callable[[int], object],
        *,
        progress: Callable[[], Optional[int]],
        policy: Optional[RetryPolicy] = None,
        sleep: Callable[[float], None] = time.sleep,
        state_path=None,
        ledger_path=None,
        flight_dir=None,
    ):
        self.launch = launch
        self.progress = progress
        self.policy = policy or RetryPolicy()
        self.sleep = sleep
        self.state_path = os.fspath(state_path) if state_path else None
        # goodput ledger (metrics/goodput.py): attempt boundaries appended
        # here partition restart downtime out of the run's wall-clock
        self.ledger_path = os.fspath(ledger_path) if ledger_path else None
        # flight-recorder dumps (metrics/flightrec.py) live here; the exit
        # classifier reads the newest one back into its diagnoses
        self.flight_dir = os.fspath(flight_dir) if flight_dir else None
        self._rng = random.Random(self.policy.seed)
        self._child = None
        self._terminate_signum: Optional[int] = None

    def _ledger_event(self, ev: str, **fields) -> None:
        """Append an attempt-boundary event to the goodput ledger; a
        failure degrades accounting, never supervision (same contract as
        the sidecar)."""
        if self.ledger_path is None:
            return
        from ..metrics.goodput import append_event

        try:
            append_event(self.ledger_path, ev, pid=os.getpid(), **fields)
        except OSError as e:
            logger.warning(
                f"SUPERVISOR: could not append {ev} to the goodput ledger "
                f"{self.ledger_path}: {e}"
            )

    def _flight_timeline(self) -> str:
        """The newest flight-record dump's last-K-step timeline, rendered
        for a diagnosis ('' when no recorder ran or nothing is readable)."""
        if self.flight_dir is None:
            return ""
        from ..metrics.flightrec import newest_flight_record, timeline_lines

        found = newest_flight_record(self.flight_dir)
        if found is None:
            return ""
        path, doc = found
        lines = timeline_lines(doc, last=8)
        if not lines:
            return ""
        return (
            f"\nFlight recorder ({os.path.basename(path)}, dumped on "
            f"{doc.get('reason', '?')}): last {len(lines)} event(s):\n"
            + "\n".join(lines)
        )

    def _persist_state(
        self,
        status: str,
        attempts: List["Attempt"],
        *,
        restarts_used: int = 0,
        no_progress_streak: int = 0,
    ) -> None:
        """Keep the JSON sidecar current; failures degrade observability,
        never the supervision loop itself."""
        if self.state_path is None:
            return
        last = attempts[-1] if attempts else None
        state = {
            "pid": os.getpid(),
            "status": status,
            "attempts": len(attempts),
            "restarts_used": restarts_used,
            "max_restarts": self.policy.max_restarts,
            "no_progress_streak": no_progress_streak,
            "crash_loop_window": self.policy.crash_loop_window,
            "outcomes": [a.outcome for a in attempts],
            "last_returncode": last.returncode if last else None,
            "last_outcome": last.outcome if last else None,
            "step": last.step_after if last else None,
            "last_backoff_s": last.backoff if last else 0.0,
            # wall-clock EVENT stamp (not an interval measurement): humans
            # and dashboards correlate this with logs and scrape times
            "updated_at": datetime.now(timezone.utc).isoformat(),
        }
        try:
            write_supervisor_state(self.state_path, state)
        except OSError as e:
            logger.warning(
                f"SUPERVISOR: could not persist state to "
                f"{self.state_path}: {e}"
            )

    # -- supervisor-level signals ----------------------------------------------

    def _forward_signal(self, signum, frame) -> None:
        """SIGTERM/SIGINT on the SUPERVISOR: forward to the live child (so
        it takes its own save-and-exit path) and stop supervising after it
        exits — never orphan a training process that would race the next
        submission's child on the checkpoint directory."""
        self._terminate_signum = int(signum)
        child = self._child
        if child is not None and hasattr(child, "send_signal"):
            try:
                child.send_signal(signum)
            except OSError:  # child already gone
                pass

    def _install_signal_handlers(self):
        import threading

        if threading.current_thread() is not threading.main_thread():
            return None  # signal.signal raises off the main thread
        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, self._forward_signal)
        return prev

    def _backoff(self, no_progress_streak: int) -> float:
        """Backoff grows with CONSECUTIVE no-progress failures (a persistent
        fault deserves widening gaps); a restart after a progressing
        failure — a resumed preemption — waits only the base."""
        p = self.policy
        base = min(
            p.backoff_base * (p.backoff_factor ** max(no_progress_streak - 1, 0)),
            p.backoff_max,
        )
        return base * (1.0 + p.jitter * self._rng.uniform(-1.0, 1.0))

    # -- the loop --------------------------------------------------------------

    def run(self) -> SupervisorResult:
        prev_handlers = self._install_signal_handlers()
        try:
            return self._run()
        finally:
            if prev_handlers:
                for sig, handler in prev_handlers.items():
                    signal.signal(sig, handler)

    def _run(self) -> SupervisorResult:
        p = self.policy
        attempts: List[Attempt] = []
        no_progress_streak = 0
        restarts_used = 0  # only no-progress failures consume the budget

        def persist(status: str) -> None:
            self._persist_state(
                status, attempts,
                restarts_used=restarts_used,
                no_progress_streak=no_progress_streak,
            )

        def terminated(step) -> SupervisorResult:
            diagnosis = (
                f"SUPERVISOR: terminated by signal {self._terminate_signum} "
                f"(checkpoint step {step}); standing down without restart."
            )
            logger.error(diagnosis)
            sys.stderr.write(diagnosis + "\n")
            sys.stderr.flush()
            persist("terminated")
            return SupervisorResult(
                "terminated", attempts, diagnosis, signum=self._terminate_signum
            )

        persist("running")
        attempt_i = 0
        while True:
            step_before = self.progress()
            if self._terminate_signum is not None:
                # signal arrived between attempts (e.g. during backoff):
                # do not launch another child
                return terminated(step_before)
            logger.warning(
                f"SUPERVISOR: attempt {attempt_i + 1} (restart budget "
                f"{restarts_used}/{p.max_restarts} used; resume step: "
                f"{step_before if step_before is not None else 'fresh'})."
            )
            self._ledger_event(
                "attempt_start", attempt=attempt_i, resume_step=step_before
            )
            self._child = child = self.launch(attempt_i)
            try:
                # each child's own watchdog bounds a hang inside it
                rc = child if isinstance(child, int) else child.wait()
            finally:
                self._child = None
            outcome = classify_exit(rc)
            step_after = self.progress()
            self._ledger_event(
                "attempt_end", attempt=attempt_i, returncode=rc,
                outcome=outcome, step=step_after,
            )
            attempt = Attempt(attempt_i, rc, outcome, step_before, step_after)
            attempts.append(attempt)
            attempt_i += 1

            if outcome == CLEAN:
                logger.warning(
                    f"SUPERVISOR: clean exit after {len(attempts)} attempt(s) "
                    f"(final step: {step_after})."
                )
                persist(CLEAN)
                return SupervisorResult(CLEAN, attempts)

            if self._terminate_signum is not None:
                # the supervisor itself was told to stop; the child already
                # received the forwarded signal and has now exited — report
                # and stand down instead of restarting
                return terminated(step_after)

            if attempt.progressed:
                no_progress_streak = 0
            else:
                no_progress_streak += 1
                restarts_used += 1
            persist("running")
            logger.error(
                f"SUPERVISOR: attempt {attempt_i} exited {rc} "
                f"[{outcome}]; checkpoint step {step_before} -> {step_after} "
                f"({'progress' if attempt.progressed else 'NO progress'}, "
                f"streak {no_progress_streak}/{p.crash_loop_window})."
            )

            if no_progress_streak >= p.crash_loop_window:
                diagnosis = (
                    f"SUPERVISOR: crash-loop: no global_step progress across "
                    f"{no_progress_streak} consecutive failed attempts "
                    f"(last exit {rc} [{outcome}], stuck at step "
                    f"{step_after if step_after is not None else 'none'}); "
                    f"aborting — restarting further would burn the retry "
                    f"budget without converging."
                    + self._flight_timeline()
                )
                logger.error(diagnosis)
                sys.stderr.write(diagnosis + "\n")
                sys.stderr.flush()
                persist("crash-loop")
                return SupervisorResult("crash-loop", attempts, diagnosis)

            if restarts_used > p.max_restarts:
                break
            attempt.backoff = self._backoff(no_progress_streak)
            logger.warning(
                f"SUPERVISOR: restarting [{outcome}] in {attempt.backoff:.2f}s."
            )
            self.sleep(attempt.backoff)

        diagnosis = (
            f"SUPERVISOR: retry budget exhausted after "
            f"{len(attempts)} attempts (outcomes: "
            f"{', '.join(a.outcome for a in attempts)})."
            + self._flight_timeline()
        )
        logger.error(diagnosis)
        sys.stderr.write(diagnosis + "\n")
        sys.stderr.flush()
        persist("retries-exhausted")
        return SupervisorResult("retries-exhausted", attempts, diagnosis)


# -- checkpoint progress probing ----------------------------------------------


def newest_checkpoint(candidates: Sequence) -> tuple:
    """``(path, step)`` of the candidate with the highest peekable
    ``global_step`` (``(None, None)`` when none is loadable). Imports the
    checkpoint module lazily: the supervisor itself must not pay (or
    depend on) the torch import."""
    from ..train.checkpoint import peek_global_step

    best, best_step = None, None
    for cand in candidates:
        step = peek_global_step(cand)
        if step is not None and (best_step is None or step > best_step):
            best, best_step = cand, step
    return best, best_step


# -- CLI wiring ----------------------------------------------------------------

# Set in every supervised child: (a) lets the train CLI turn a caught
# preemption into PREEMPT_EXIT_CODE, (b) breaks --supervise recursion even
# when the flag comes from a config file the child re-reads.
SUPERVISED_ENV = "MLRT_SUPERVISED"


def build_child_argv(
    argv: Sequence[str], *, resume: Optional[str] = None
) -> List[str]:
    """Strip supervisor-only flags from ``argv`` and re-point ``--last``."""
    out: List[str] = []
    skip_value = False
    for arg in argv:
        if skip_value:
            skip_value = False
            continue
        if arg == "--supervise" or arg.startswith("--supervise="):
            continue
        if resume is not None:
            if arg == "--last":
                skip_value = True
                continue
            if arg.startswith("--last="):
                continue
        out.append(arg)
    if resume is not None:
        out.extend(["--last", resume])
    return out


def _policy_from_params(params) -> RetryPolicy:
    return RetryPolicy(
        max_restarts=getattr(params, "max_restarts", 5),
        backoff_base=getattr(params, "backoff_base", 1.0),
        backoff_max=getattr(params, "backoff_max", 30.0),
        crash_loop_window=getattr(params, "crash_loop_window", 3),
        seed=getattr(params, "seed", None) or 0,
    )


def supervise_cli(params, argv: Sequence[str]) -> int:
    """Drive ``python -m ml_recipe_tpu_torch.cli.train`` under supervision.

    Resumes each attempt from the newest of ``interrupt.ch`` / ``last.ch``
    in the experiment directory (emergency checkpoints win when they are
    ahead, which they are after a mid-epoch preemption). Each child
    inherits the argv minus ``--supervise`` (``--device`` included) and
    ``MLRT_SUPERVISED=1``. ``--elastic`` is refused before this runs
    (``config.parser.check_train_flags``).
    """
    exp_dir = os.path.join(os.fspath(params.dump_dir), params.experiment_name)
    candidates = [
        os.path.join(exp_dir, "interrupt.ch"),
        os.path.join(exp_dir, "last.ch"),
    ]

    def progress() -> Optional[int]:
        return newest_checkpoint(candidates)[1]

    def launch(attempt_i: int):
        resume, step = newest_checkpoint(candidates)
        child_argv = build_child_argv(argv, resume=resume)
        env = dict(os.environ)
        env[SUPERVISED_ENV] = "1"
        logger.warning(
            f"SUPERVISOR: launching attempt {attempt_i + 1}"
            + (f" resuming {resume} (step {step})" if resume else " fresh")
            + "."
        )
        return subprocess.Popen(
            [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train", *child_argv],
            env=env,
        )

    from ..metrics.goodput import GOODPUT_FILENAME

    result = Supervisor(
        launch, progress=progress, policy=_policy_from_params(params),
        state_path=os.path.join(exp_dir, STATE_FILENAME),
        # attempt boundaries land in the same ledger the child feeds, so
        # restart downtime is partitioned out of the run wall-clock
        ledger_path=(
            os.path.join(exp_dir, GOODPUT_FILENAME)
            if getattr(params, "goodput_ledger", False) else None
        ),
        # crash-loop diagnoses read the newest flight-record dump back
        flight_dir=(
            exp_dir if getattr(params, "flight_recorder", False) else None
        ),
    ).run()
    return result.exit_code
