"""Auto-resume supervisor: the local analogue of an elastic agent (the port
of ``ml_recipe_tpu/resilience/supervisor.py``).

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
manager's contract for its engine children. With ``--elastic on`` one
:class:`ElasticSupervisor` runs per host and the hosts coordinate through
``resilience/coordination.py``: a dead host's peers restart on a smaller
``data`` axis (:func:`_supervise_elastic`).
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

from ..metrics.artifacts import wall_now
from .coordination import (
    COORD_DIRNAME,
    COORD_SCHEMA_VERSION,
    ELASTIC_WORLD_ENV,
    CoordinationSchemaError,
    PodCoordinator,
    read_coordination_json,
)
from .faults import HOST_ENV
from .watchdog import WATCHDOG_EXIT_CODE

logger = logging.getLogger(__name__)

__all__ = [
    "CLEAN", "CRASH", "HANG", "HOST_LOST", "POD_RESTART", "PREEMPTED",
    "PREEMPT_EXIT_CODE", "STATE_FILENAME", "SUPERVISED_ENV", "Attempt",
    "ElasticSupervisor", "RetryPolicy", "Supervisor", "SupervisorResult",
    "build_child_argv", "classify_exit", "newest_checkpoint",
    "peek_supervisor_state", "supervise_cli", "write_supervisor_state",
]

# JSON sidecar the supervisor keeps current next to the checkpoints, so the
# training exporter (and humans) read restart counts / exit classifications
# / backoff state without parsing logs. Written atomically (tmp + rename):
# a reader never sees a torn document.
STATE_FILENAME = "supervisor_state.json"


def write_supervisor_state(path, state: dict) -> None:
    """Atomically persist the supervisor's observable state (schema-stamped:
    the elastic coordination plane reads these cross-host, and an old
    sidecar must be rejectable — see resilience/coordination.py)."""
    path = os.fspath(path)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    doc = dict(state)
    doc.setdefault("schema", COORD_SCHEMA_VERSION)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2)
    os.replace(tmp, path)


def peek_supervisor_state(path) -> Optional[dict]:
    """Best-effort read of the sidecar; None when absent or unreadable
    (an exporter scrape must never crash on a mid-replace race or a
    corrupt file). Routed through the guarded coordination reader: a
    TRANSIENT torn read (shared-FS mid-replace window) is retried with
    bounded backoff instead of being misreported as absent, and a sidecar
    written by an incompatible build is rejected loudly."""
    try:
        return read_coordination_json(path)
    except CoordinationSchemaError as e:
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
# elastic-only outcomes: the SUPERVISOR killed its (healthy) child because
# the pod had to re-form — a peer bumped the restart generation
# (POD_RESTART) or a peer host's heartbeat went stale / it self-reported
# failed (HOST_LOST). Neither is this host failing, so neither consumes
# the restart budget (the at-fault host's own supervisor bounds ITS loop).
POD_RESTART = "pod-restart"
HOST_LOST = "host-lost"

# coordinated-restart outcomes: retryable, but exempt from the no-progress
# budget/crash-loop accounting (see above)
_COORDINATED = (POD_RESTART, HOST_LOST)


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
    ``wait``/``kill``/``send_signal``) or a bare int return code (tests). ``progress()``
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

    # -- one attempt -----------------------------------------------------------

    def _wait(self, child) -> int:
        # each child's own watchdog bounds a hang inside it
        return child if isinstance(child, int) else child.wait()

    # -- elastic hook points (no-ops for the fixed-world supervisor) -----------

    def _pre_attempt(self, attempt_i: int):
        """Return ``(status, diagnosis)`` to abort supervision before
        launching attempt ``attempt_i``; None to proceed. The elastic
        subclass enforces the min-world floor here."""
        return None

    def _classify_outcome(self, rc: int) -> str:
        """Map a child return code onto an outcome. The elastic subclass
        overrides the classification when IT killed the child for a
        coordinated pod restart (the raw rc would read as 'preempted')."""
        return classify_exit(rc)

    def _post_attempt(self, attempt: "Attempt") -> None:
        """Called once per finished attempt, before retry/abort decisions.
        The elastic subclass publishes coordination state (and bumps the
        pod generation when this host's own child failed)."""

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
            abort = self._pre_attempt(attempt_i)
            if abort is not None:
                status, diagnosis = abort
                logger.error(diagnosis)
                sys.stderr.write(diagnosis + "\n")
                sys.stderr.flush()
                persist(status)
                return SupervisorResult(status, attempts, diagnosis)
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
            self._child = self.launch(attempt_i)
            try:
                rc = self._wait(self._child)
            finally:
                self._child = None
            outcome = self._classify_outcome(rc)
            step_after = self.progress()
            self._ledger_event(
                "attempt_end", attempt=attempt_i, returncode=rc,
                outcome=outcome, step=step_after,
            )
            attempt = Attempt(attempt_i, rc, outcome, step_before, step_after)
            attempts.append(attempt)
            attempt_i += 1
            self._post_attempt(attempt)

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
            elif outcome in _COORDINATED:
                # a coordinated pod restart is not THIS host failing:
                # exempt from the budget AND the crash-loop streak — a
                # crash-looping peer is bounded by its OWN supervisor,
                # which aborts and publishes 'failed' (then HOST_LOST
                # shrinks the world here instead of looping forever)
                pass
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


# -- elastic (cross-host) supervision ------------------------------------------


class ElasticSupervisor(Supervisor):
    """Cross-host elastic supervision (``--elastic on``).

    One ElasticSupervisor runs per host; they coordinate through per-host
    heartbeat files (:class:`~.coordination.PodCoordinator`) instead of a
    control channel. The base retry loop is unchanged — this subclass
    replaces the blocking child wait with a polling wait that, every
    ``poll_interval`` seconds:

    1. publishes this host's heartbeat (status, generation, attempt, the
       child's last reported step);
    2. reads every live peer's document: a peer at a HIGHER generation
       means the pod is restarting -> kill our (wedged) child now instead
       of letting it wait out the collective timeout; a peer whose
       heartbeat is stale past ``host_timeout`` (or that published status
       'failed' — its own supervisor gave up on a crash-loop) is declared
       LOST -> drop it from the live set, bump the generation and restart
       on the shrunk world.

    The launch callback reads :attr:`world` for the CURRENT live world
    (hosts, size, this host's rank, generation) so each attempt's child is
    told the topology it is actually joining; a shrunk child re-derives
    its mesh via ``ParallelPlan.elastic_from_spec``. When this host's own
    child fails, the generation is bumped BEFORE the backoff so every
    surviving peer restarts immediately. Host death vs crash-loop is
    classified explicitly: a self-reported 'failed' status is a peer
    crash-loop, a silent stale heartbeat is a dead host — both shrink the
    world, but the diagnosis (and the flight-recorder event) names which.

    One difference from the JAX package: a child's collective does not
    always wedge when a peer dies. Gloo raises within seconds once the dead
    peer's sockets close, so this host's child may exit as a crash before
    the peer's heartbeat is stale. Relaunching then would spend an attempt
    rendezvousing with a dead host. So after this host's own child fails,
    :meth:`_await_peers` holds the relaunch until every live peer is either
    fresh (its supervisor published a poll interval after the failure) or
    declared lost,
    and a peer lost during that hold makes the attempt's outcome
    ``host-lost``, as the JAX supervisor classifies the wedged child it
    kills: the drill's outcomes are ``["host-lost", "clean"]`` in both
    packages.
    """

    def __init__(
        self,
        launch: Callable[[int], object],
        *,
        coordinator: PodCoordinator,
        host_timeout: float = 60.0,
        poll_interval: float = 2.0,
        min_world: int = 1,
        kill_grace: float = 5.0,
        **kwargs,
    ):
        super().__init__(launch, **kwargs)
        self.coordinator = coordinator
        self.host_timeout = float(host_timeout)
        self.poll_interval = float(poll_interval)
        self.min_world = max(1, int(min_world))
        self.kill_grace = float(kill_grace)
        self.generation = 0
        self._attempt_i = 0
        self._dead_hosts: set = set()
        self._done_hosts: set = set()
        self._lost_why: dict = {}          # host -> classification text
        self._kill_reason = None           # (outcome, peer host) | None
        self._last_good: dict = {}         # host -> monotonic of last good read
        self._started = time.monotonic()
        self._flight = None
        if self.flight_dir is not None:
            from ..metrics.flightrec import FlightRecorder

            # the supervisor keeps its OWN bounded event ring: elastic
            # transitions (host_lost / pod_restart) land in a dump the
            # crash-loop diagnosis reads back, explaining topology changes
            self._flight = FlightRecorder.open_in(
                self.flight_dir, process_index=coordinator.host,
                capacity=64,
            )

    # -- live-world bookkeeping ------------------------------------------------

    def live_hosts(self) -> List[int]:
        return [
            h for h in range(self.coordinator.n_hosts)
            if h not in self._dead_hosts
        ]

    @property
    def world(self) -> dict:
        """The CURRENT live world, for the launch callback: surviving
        hosts in id order, the shrunk world size, this host's rank within
        it, and the pod generation."""
        live = self.live_hosts()
        return {
            "hosts": live,
            "size": len(live),
            "rank": live.index(self.coordinator.host),
            "generation": self.generation,
        }

    def _note_elastic(self, kind: str, **fields) -> None:
        """An elastic transition: goodput-ledger event + flight-recorder
        event (dumped immediately — transitions are rare and must survive
        whatever happens next)."""
        self._ledger_event(kind, host=self.coordinator.host, **fields)
        if self._flight is not None:
            self._flight.record(kind, **fields)
            self._flight.dump("elastic", transition=kind)

    def _heartbeat(self, status: str = "running") -> None:
        self.coordinator.publish(
            status,
            generation=self.generation,
            attempt=self._attempt_i,
            step=self.coordinator.child_step(self.coordinator.host),
            live_hosts=self.live_hosts(),
        )

    # -- peer policy -----------------------------------------------------------

    def _declare_host_lost(self, host: int, *, why: str):
        self._dead_hosts.add(host)
        self._lost_why[host] = why
        self.generation += 1
        last_step = self.coordinator.child_step(host)
        logger.error(
            f"SUPERVISOR[elastic h{self.coordinator.host}]: host {host} "
            f"LOST ({why}; last reported step "
            f"{last_step if last_step is not None else 'none'}); live "
            f"hosts now {self.live_hosts()}; restarting the pod at "
            f"generation {self.generation}."
        )
        self._note_elastic(
            "host_lost", lost=host, why=why, generation=self.generation,
            last_step=last_step, live_hosts=self.live_hosts(),
        )
        return (HOST_LOST, host)

    def _check_peers(self):
        """One coordination sweep. Returns ``(outcome, peer)`` when the
        live child must be killed for a coordinated restart, else None."""
        now = time.monotonic()
        for h in self.live_hosts():
            if h == self.coordinator.host or h in self._done_hosts:
                continue
            doc = self.coordinator.peer_state(h)
            if doc is not None:
                self._last_good[h] = now
                status = doc.get("status")
                if status == "done":
                    self._done_hosts.add(h)
                    continue
                if status == "failed":
                    # the peer's OWN supervisor gave up (crash-loop /
                    # retries-exhausted): a classified failure, not a
                    # silent death — but the pod shrinks either way
                    return self._declare_host_lost(
                        h, why="its supervisor reported 'failed' "
                               "(peer crash-loop)",
                    )
                gen = int(doc.get("generation", 0))
                if gen > self.generation:
                    self.generation = gen
                    logger.warning(
                        f"SUPERVISOR[elastic h{self.coordinator.host}]: "
                        f"host {h} published generation {gen}; joining the "
                        f"pod restart."
                    )
                    self._note_elastic(
                        "pod_restart", origin=h, generation=gen,
                    )
                    return (POD_RESTART, h)
                # heartbeat age from the WALL stamp (hosts are NTP-synced
                # at coarse, multi-second granularity): catches a dead
                # supervisor whose file corpse remains readable
                age = wall_now() - float(doc.get("heartbeat", 0.0))
            else:
                # unreadable/absent even after the bounded retry: age from
                # the last GOOD read (never from one torn read — that is
                # the misclassification the retry exists to prevent)
                age = now - self._last_good.get(h, self._started)
            if age > self.host_timeout:
                return self._declare_host_lost(
                    h, why=f"heartbeat stale for {age:.1f}s "
                           f"(> {self.host_timeout:g}s; host death)",
                )
        return None

    # -- overridden loop pieces ------------------------------------------------

    def _pre_attempt(self, attempt_i: int):
        self._attempt_i = attempt_i
        live = self.live_hosts()
        if len(live) < self.min_world:
            detail = "; ".join(
                f"host {h}: {why}" for h, why in sorted(self._lost_why.items())
            )
            return (
                "world-floor",
                f"SUPERVISOR[elastic h{self.coordinator.host}]: only "
                f"{len(live)} live host(s) remain ({detail}) — below the "
                f"--min_world floor of {self.min_world}; aborting instead "
                f"of training degenerately narrow." + self._flight_timeline(),
            )
        if 0 in self._dead_hosts and len(live) > 1:
            detail = self._lost_why.get(0, "lost")
            return (
                "coordinator-lost",
                f"SUPERVISOR[elastic h{self.coordinator.host}]: host 0 was "
                f"lost ({detail}) and {len(live)} hosts remain — the "
                f"rendezvous coordinator address lives on host 0, so the "
                f"shrunk pod cannot re-form; aborting. (A single surviving "
                f"host would have continued solo.)" + self._flight_timeline(),
            )
        self._heartbeat("running")
        return None

    def _wait(self, child) -> int:
        if isinstance(child, int):
            # scripted attempts (unit tests): still run one coordination
            # sweep so peer-driven outcomes are drivable without a process
            self._kill_reason = self._check_peers()
            return child
        self._kill_reason = None
        while True:
            try:
                return child.wait(timeout=self.poll_interval)
            except subprocess.TimeoutExpired:
                pass
            if self._terminate_signum is not None:
                # operator shutdown: the signal was already forwarded to
                # the child; keep waiting for it to unwind (no peer logic)
                continue
            self._heartbeat("running")
            reason = self._check_peers()
            if reason is not None:
                self._kill_reason = reason
                return self._stop_child(child)

    def _stop_child(self, child) -> int:
        """Coordinated kill: SIGTERM first (the child's interrupt-
        checkpoint path gets ``kill_grace`` seconds to save), then
        SIGKILL. The collective the child is wedged in never returns on
        its own — that is the whole point of killing it."""
        try:
            child.terminate()
        except OSError:
            pass
        try:
            return child.wait(timeout=self.kill_grace)
        except subprocess.TimeoutExpired:
            child.kill()
            return child.wait()

    def _classify_outcome(self, rc: int) -> str:
        if self._kill_reason is not None:
            outcome, _peer = self._kill_reason
            return outcome
        outcome = classify_exit(rc)
        if outcome != CLEAN and self._terminate_signum is None:
            lost = self._await_peers(wall_now())
            if lost is not None:
                self._kill_reason = lost
                return lost[0]
        return outcome

    def _await_peers(self, since: float):
        """Hold after this host's own child failed at wall time ``since``
        until every live peer is fresh or lost, publishing this host's
        heartbeat each ``poll_interval``. Fresh: its document is stamped a
        full ``poll_interval`` after ``since``, so its supervisor outlived
        the failure (a host that died with the collective publishes at most
        once more). Lost: stale past ``host_timeout``, or it published
        'failed'. Returns the ``(HOST_LOST, host)`` of the first peer
        declared lost, else None. The pod generation is not adopted here:
        every host whose child failed moves one past the generation it ran
        at (:meth:`_post_attempt`), so hosts that failed together meet at
        the same generation."""
        fresh_from = since + self.poll_interval
        lost = None
        while self._terminate_signum is None:
            self._heartbeat("running")
            pending = False
            now = time.monotonic()
            for h in self.live_hosts():
                if h == self.coordinator.host or h in self._done_hosts:
                    continue
                doc = self.coordinator.peer_state(h)
                if doc is not None:
                    self._last_good[h] = now
                    status = doc.get("status")
                    if status == "done":
                        self._done_hosts.add(h)
                        continue
                    if status == "failed":
                        reason = self._declare_host_lost(
                            h, why="its supervisor reported 'failed' "
                                   "(peer crash-loop)")
                        lost = lost or reason
                        continue
                    stamp = float(doc.get("heartbeat", 0.0))
                    if stamp >= fresh_from:
                        continue
                    age = wall_now() - stamp
                else:
                    age = now - self._last_good.get(h, self._started)
                if age > self.host_timeout:
                    reason = self._declare_host_lost(
                        h, why=f"heartbeat stale for {age:.1f}s "
                               f"(> {self.host_timeout:g}s; host death)")
                    lost = lost or reason
                else:
                    pending = True
            if not pending:
                break
            time.sleep(self.poll_interval)
        return lost

    def _post_attempt(self, attempt: Attempt) -> None:
        if attempt.outcome == CLEAN:
            self._heartbeat("done")
        elif attempt.outcome in _COORDINATED:
            # generation already adopted/bumped by the sweep that killed
            # the child; just make the restart visible to peers
            self._heartbeat("restarting")
        else:
            # this host's OWN child failed (crash/hang/preempt): peers'
            # children are wedged in collectives waiting for us — bump the
            # generation so every surviving supervisor restarts NOW
            # instead of waiting out the rendezvous/collective timeout
            self.generation += 1
            self._note_elastic(
                "pod_restart", origin=self.coordinator.host,
                generation=self.generation, returncode=attempt.returncode,
                outcome=attempt.outcome,
            )
            self._heartbeat("restarting")

    def _persist_state(self, status, attempts, **kwargs) -> None:
        super()._persist_state(status, attempts, **kwargs)
        # terminal supervisor states double as coordination signals: a
        # peer that reads 'failed' classifies us as a crash-loop (not a
        # host death) and shrinks the pod without waiting for staleness
        if status in ("crash-loop", "retries-exhausted", "terminated",
                      "world-floor", "coordinator-lost"):
            self._heartbeat("failed")
        elif status == CLEAN:
            self._heartbeat("done")


# -- checkpoint progress probing ----------------------------------------------


def newest_checkpoint(candidates: Sequence, *, retries: int = 0) -> tuple:
    """``(path, step)`` of the candidate with the highest peekable
    ``global_step`` (``(None, None)`` when none is loadable). Imports the
    checkpoint module lazily: the supervisor itself must not pay (or
    depend on) the torch import. ``retries`` re-probes an unreadable
    candidate (elastic supervisors probe checkpoints a PEER may be
    mid-swap on; a fixed-world supervisor only reads its own)."""
    from ..train.checkpoint import peek_global_step

    best, best_step = None, None
    for cand in candidates:
        step = peek_global_step(cand, retries=retries)
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
    ahead, which they are after a mid-epoch preemption). With
    ``--elastic on`` this becomes one host's member of a coordinated pod
    (see :class:`ElasticSupervisor`); the default path is byte-identical
    to fixed-world supervision and never touches the coordination dir.
    """
    exp_dir = os.path.join(os.fspath(params.dump_dir), params.experiment_name)
    candidates = [
        os.path.join(exp_dir, "interrupt.ch"),
        os.path.join(exp_dir, "last.ch"),
    ]
    if getattr(params, "elastic", "off") != "off":
        return _supervise_elastic(params, argv, exp_dir, candidates)

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
            [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train",
             *child_argv],
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


def _supervise_elastic(
    params, argv: Sequence[str], exp_dir: str, candidates: Sequence[str]
) -> int:
    """One host's member of the coordinated elastic pod (``--elastic on``).

    Differences from fixed-world supervision, and nothing else:

    - a :class:`~.coordination.PodCoordinator` under ``<exp_dir>/pod/``
      publishes this host's heartbeat and reads the peers';
    - every child is launched with ``MLRT_HOST`` (host-scoped fault specs)
      and ``MLRT_ELASTIC_WORLD=<size>:<rank>`` for the CURRENT live world,
      so after a host loss the survivors re-form a smaller pod and the
      child re-derives its mesh from the live processes
      (``ParallelPlan.elastic_from_spec``);
    - checkpoint probes retry a couple of times: a PEER host may be
      mid-swap on the shared checkpoint this host is peeking at;
    - only host 0 appends supervisor events to the goodput ledger (same
      process-0-only discipline as the training-side ledger writer), and
      each host keeps its own sidecar (host 0 owns the canonical name).
    """
    host = max(int(getattr(params, "local_rank", 0) or 0), 0)
    n_hosts = max(int(getattr(params, "dist_world_size", 1) or 1), 1)
    coordinator = PodCoordinator(
        os.path.join(exp_dir, COORD_DIRNAME), host=host, n_hosts=n_hosts
    )

    def progress() -> Optional[int]:
        return newest_checkpoint(candidates, retries=2)[1]

    sup_holder: List[ElasticSupervisor] = []

    def launch(attempt_i: int):
        world = sup_holder[0].world
        resume, step = newest_checkpoint(candidates, retries=2)
        child_argv = build_child_argv(argv, resume=resume)
        env = dict(os.environ)
        env[SUPERVISED_ENV] = "1"
        env[HOST_ENV] = str(host)
        env[ELASTIC_WORLD_ENV] = f"{world['size']}:{world['rank']}"
        logger.warning(
            f"SUPERVISOR[elastic h{host}]: launching attempt {attempt_i + 1} "
            f"generation {world['generation']} as rank {world['rank']}/"
            f"{world['size']} (live hosts {world['hosts']})"
            + (f", resuming {resume} (step {step})" if resume else ", fresh")
            + "."
        )
        return subprocess.Popen(
            [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train",
             *child_argv],
            env=env,
        )

    from ..metrics.goodput import GOODPUT_FILENAME

    state_name = (
        STATE_FILENAME if host == 0 else f"supervisor_state_h{host}.json"
    )
    sup = ElasticSupervisor(
        launch,
        coordinator=coordinator,
        host_timeout=getattr(params, "host_timeout", 60.0),
        poll_interval=getattr(params, "coord_poll", 2.0),
        min_world=getattr(params, "min_world", 1),
        progress=progress,
        policy=_policy_from_params(params),
        state_path=os.path.join(exp_dir, state_name),
        ledger_path=(
            os.path.join(exp_dir, GOODPUT_FILENAME)
            if host == 0 and getattr(params, "goodput_ledger", False)
            else None
        ),
        flight_dir=(
            exp_dir if getattr(params, "flight_recorder", False) else None
        ),
    )
    sup_holder.append(sup)
    return sup.run().exit_code
