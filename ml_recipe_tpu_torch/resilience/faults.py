"""Deterministic fault-injection registry (``FaultPlan``): the port of
``ml_recipe_tpu/resilience/faults.py``, the same grammar, sites and exit code.

Every recovery path in the codebase — torn-save rollback, loader retries,
watchdog abort + supervised restart — is only trustworthy if it can be
driven on demand. A :class:`FaultPlan` names WHERE a fault fires (a site
threaded through the real code path), WHAT it does (kill / raise / stall /
slow) and WHEN (the nth arrival at the site), so a whole kill-restart-resume
scenario replays identically run after run: no randomness, no timing races.

Spec grammar (semicolon-separated entries)::

    site:kind[@hit][xcount][~seconds][!once][%hostN]

- ``site``   one of :data:`KNOWN_SITES` (typos are a hard error — a drill
  that silently never fires is worse than no drill).
- ``kind``   ``kill``  — ``os._exit(KILL_EXIT_CODE)``: a hard kill, no
  atexit/finally, exactly what preemption or an OOM kill looks like;
  ``raise`` — raise :class:`FaultError` (an ``OSError``, so transient-IO
  retry paths see it as the real thing); ``stall`` — block ``~seconds``
  (default 3600: long enough that only a watchdog ends it); ``slow`` —
  sleep ``~seconds`` (default 0.05) and continue.
- ``@hit``   1-based arrival index at which the fault starts firing
  (default 1).
- ``xcount`` number of consecutive arrivals that fire (default 1;
  ``x*`` = every arrival from ``@hit`` on).
- ``!once``  fire at most once across PROCESS RESTARTS, tracked via a
  marker file under ``$MLRT_FAULT_STATE`` — the knob that makes
  kill-then-recover drills converge instead of crash-looping (without the
  env var, ``!once`` is per-process only). Markers are keyed per host, so
  a shared state dir never cross-suppresses hosts.
- ``%hostN`` scope the spec to the process whose ``$MLRT_HOST`` equals N
  (the fleet manager stamps every engine with its index) — what
  makes multi-process chaos drills deterministic: ``trainer.step:kill@4%host1``
  kills exactly host 1's child on its 4th step, nobody else's. A
  malformed scope (``%h1``, ``%host``) is a hard parse error: a drill
  that silently never fires is worse than no drill. Arrival counters
  still advance on every host — only the ACTION is scoped.

Plans come from ``--fault_plan`` (config/CLI) or the ``MLRT_FAULTS`` env
var (read lazily on first :func:`fire`, so supervised child processes and
shell drills need no code changes). Example::

    MLRT_FAULTS='ckpt.pre_manifest:kill@2!once;loader.read:raise@1x3'
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

FAULT_ENV = "MLRT_FAULTS"
FAULT_STATE_ENV = "MLRT_FAULT_STATE"

# This process's host id in a multi-host pod (the elastic supervisor sets
# it on every child). Read lazily at fire time: %hostN scoping and the
# per-host !once marker key both resolve against it; unset means host 0.
HOST_ENV = "MLRT_HOST"


def current_host() -> int:
    """This process's pod host id (``$MLRT_HOST``, default 0)."""
    raw = os.environ.get(HOST_ENV, "")
    try:
        return int(raw) if raw else 0
    except ValueError:
        logger.warning(f"Ignoring malformed ${HOST_ENV}={raw!r}; using host 0.")
        return 0

# Exit code of an injected `kill` — distinct from the watchdog's so the
# supervisor's classification (and test assertions) can tell a drill kill
# from a hang abort.
KILL_EXIT_CODE = 89

# The injection sites threaded through the codebase. A FaultPlan naming
# anything else fails at parse time.
KNOWN_SITES = (
    "ckpt.pre_write",        # single-file save: before the atomic write
    "ckpt.pre_shard_write",  # sharded save: before this host's shard file
    "ckpt.pre_manifest",     # sharded save: shards landed, manifest not yet
    "ckpt.mid_swap",         # sharded save: between the swap's two renames
    "checkpoint.persist",    # persist leg (serialize+write) of any save —
                             # on the BACKGROUND thread under
                             # --async_checkpoint, so a kill here is the
                             # canonical crash-mid-persist drill
    "loader.read",           # every dataset item read (both loaders)
    "loader.prefetch",       # device-prefetch thread, per staged batch
    "dist.rendezvous",       # before torch.distributed.init_process_group
    "dist.barrier",          # inside every named cross-process barrier
    "trainer.step",          # host side of each train step
    "trainer.eval_step",     # host side of each eval step
    "fleet.engine",          # serving engine, per admitted /v1/qa request
                             # (fleet chaos drills: kill one engine of a
                             # router tier mid-load; scope with %hostN —
                             # the fleet manager stamps MLRT_HOST with the
                             # engine index)
)

_KINDS = ("kill", "raise", "stall", "slow")

_DEFAULT_SECONDS = {"stall": 3600.0, "slow": 0.05}


class FaultError(OSError):
    """An injected fault. Subclasses ``OSError`` on purpose: transient-IO
    retry paths must treat a drill exactly like the failure it simulates."""


@dataclasses.dataclass
class FaultSpec:
    site: str
    kind: str
    hit: int = 1
    count: int = 1          # -1 = every arrival from `hit` on
    seconds: Optional[float] = None
    once: bool = False
    host: Optional[int] = None   # %hostN scope; None = every host

    def active_at(self, n: int) -> bool:
        if n < self.hit:
            return False
        return self.count < 0 or n < self.hit + self.count


_SPEC_RE = re.compile(
    r"^(?P<site>[\w.]+):(?P<kind>\w+)(?P<rest>(?:@\d+|x(?:\d+|\*)|~[\d.]+|!once|%\w+)*)$"
)
_TOKEN_RE = re.compile(r"@\d+|x(?:\d+|\*)|~[\d.]+|!once|%\w+")
_HOST_SCOPE_RE = re.compile(r"^%host(\d+)$")


def _parse_entry(entry: str) -> FaultSpec:
    m = _SPEC_RE.match(entry.strip())
    if m is None:
        raise ValueError(
            f"malformed fault spec {entry!r}; expected "
            f"'site:kind[@hit][xcount][~seconds][!once][%hostN]'"
        )
    site, kind, rest = m.group("site"), m.group("kind"), m.group("rest")
    if site not in KNOWN_SITES:
        raise ValueError(
            f"unknown fault site {site!r}; known sites: {', '.join(KNOWN_SITES)}"
        )
    if kind not in _KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {entry!r}; known kinds: "
            f"{', '.join(_KINDS)}"
        )
    spec = FaultSpec(site=site, kind=kind)
    for tok in _TOKEN_RE.findall(rest):
        if tok.startswith("@"):
            spec.hit = int(tok[1:])
        elif tok.startswith("x"):
            spec.count = -1 if tok[1:] == "*" else int(tok[1:])
        elif tok.startswith("~"):
            spec.seconds = float(tok[1:])
        elif tok == "!once":
            spec.once = True
        elif tok.startswith("%"):
            scope = _HOST_SCOPE_RE.match(tok)
            if scope is None:
                raise ValueError(
                    f"malformed host scope {tok!r} in fault spec {entry!r}; "
                    f"expected '%host<N>' as the LAST token (e.g. "
                    f"'trainer.step:kill@4%host1')"
                )
            spec.host = int(scope.group(1))
    if spec.hit < 1:
        raise ValueError(f"fault spec {entry!r}: @hit is 1-based")
    return spec


class FaultPlan:
    """A parsed set of :class:`FaultSpec` with per-site arrival counters.

    Counters are plain per-process integers (thread-safe), so a plan is
    deterministic by construction: the nth arrival at a site is the nth
    arrival, every run. ``!once`` specs additionally consult a marker file
    under ``state_dir`` so they stay fired across supervised restarts.
    """

    def __init__(
        self, specs: List[FaultSpec], *, state_dir: Optional[str] = None
    ):
        self.specs = list(specs)
        self.state_dir = state_dir
        self._by_site: Dict[str, List[Tuple[int, FaultSpec]]] = {}
        for i, spec in enumerate(self.specs):
            self._by_site.setdefault(spec.site, []).append((i, spec))
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, *, state_dir: Optional[str] = None) -> "FaultPlan":
        entries = [e for e in (text or "").split(";") if e.strip()]
        return cls([_parse_entry(e) for e in entries], state_dir=state_dir)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        text = os.environ.get(FAULT_ENV)
        if not text:
            return None
        return cls.parse(text, state_dir=os.environ.get(FAULT_STATE_ENV))

    def __bool__(self) -> bool:
        return bool(self.specs)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._counters.get(site, 0)

    # -- !once cross-restart state -------------------------------------------

    def _marker(self, index: int, spec: FaultSpec) -> Optional[str]:
        if self.state_dir is None:
            return None
        # keyed per host: elastic drills share one state dir across the
        # whole pod, and host 0's kill must not suppress host 1's
        return os.path.join(
            self.state_dir,
            f"fired-{index:02d}-{spec.site}.{spec.kind}.h{current_host()}",
        )

    def _already_fired(self, index: int, spec: FaultSpec) -> bool:
        marker = self._marker(index, spec)
        return marker is not None and os.path.exists(marker)

    def _record_fired(self, index: int, spec: FaultSpec) -> None:
        marker = self._marker(index, spec)
        if marker is None:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        # write BEFORE acting: a `kill` never returns, and the whole point
        # of !once is that the restarted process does not re-fire it
        with open(marker, "w") as fh:
            fh.write(f"hit={self._counters.get(spec.site, 0)}\n")

    # -- firing ---------------------------------------------------------------

    def fire(self, site: str) -> None:
        """Arrival at ``site``: bump the counter and act on any armed spec.

        The !once check-and-record happens under the plan lock: concurrent
        loader threads arriving inside the active window must resolve to
        exactly ONE firing (the determinism contract), not one each.
        """
        armed = self._by_site.get(site)
        if not armed:
            return
        host = current_host()
        with self._lock:
            n = self._counters.get(site, 0) + 1
            self._counters[site] = n
            to_fire = []
            for index, spec in armed:
                if spec.host is not None and spec.host != host:
                    continue  # scoped to another host; counter still advanced
                if not spec.active_at(n):
                    continue
                if spec.once:
                    if self._already_fired(index, spec):
                        continue
                    self._record_fired(index, spec)
                to_fire.append(spec)
        # act OUTSIDE the lock: stall/raise/kill must not wedge other
        # threads' (non-firing) site arrivals behind the mutex
        for spec in to_fire:
            self._act(spec, n)

    def _act(self, spec: FaultSpec, n: int) -> None:
        note = f"FAULT: {spec.kind} at {spec.site} (arrival {n})"
        if spec.kind == "kill":
            # bypass logging: mimic a hard kill as closely as a self-
            # inflicted one can — the only courtesy is one stderr line so
            # drill logs show what happened
            sys.stderr.write(note + f" -> os._exit({KILL_EXIT_CODE})\n")
            sys.stderr.flush()
            os._exit(KILL_EXIT_CODE)
        if spec.kind == "raise":
            logger.warning(note)
            raise FaultError(f"injected fault at {spec.site} (arrival {n})")
        seconds = (
            spec.seconds if spec.seconds is not None
            else _DEFAULT_SECONDS[spec.kind]
        )
        logger.warning(f"{note} for {seconds:g}s")
        time.sleep(seconds)


# -- process-global plan -------------------------------------------------------

_plan: Optional[FaultPlan] = None
_env_checked = False


def install_plan(plan) -> Optional[FaultPlan]:
    """Install the process-global plan: a :class:`FaultPlan`, a spec string,
    or ``None`` to disarm (also stops the lazy env-var lookup)."""
    global _plan, _env_checked
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan, state_dir=os.environ.get(FAULT_STATE_ENV))
    _plan = plan
    _env_checked = True
    if _plan:
        logger.warning(
            f"Fault plan armed: {len(_plan.specs)} spec(s) at sites "
            f"{sorted({s.site for s in _plan.specs})}."
        )
    return _plan


def active_plan() -> Optional[FaultPlan]:
    global _plan, _env_checked
    if not _env_checked:
        _env_checked = True
        _plan = FaultPlan.from_env()
        if _plan:
            logger.warning(f"Fault plan armed from ${FAULT_ENV}.")
    return _plan


def fire(site: str) -> None:
    """Hot-path entry: a no-op (one None check) unless a plan is armed."""
    plan = active_plan()
    if plan is not None:
        plan.fire(site)


# -- shared transient-retry helper ---------------------------------------------


def retry_transient(
    fn: Callable,
    *,
    retries: int = 3,
    base_delay: float = 0.05,
    factor: float = 2.0,
    exceptions: tuple = (OSError,),
    what: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``fn()`` with bounded retry + exponential backoff on transient
    errors. ``retries`` counts RE-tries: the last failure (attempt
    ``retries + 1``) propagates to the caller with its original traceback.
    """
    delay = base_delay
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt == retries:
                raise
            logger.warning(
                f"Transient failure in {what} (attempt {attempt + 1}/"
                f"{retries + 1}): {e!r}; retrying in {delay:.2f}s."
            )
            sleep(delay)
            delay *= factor
