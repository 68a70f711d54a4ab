"""Shared pod coordination for elastic supervision (the port of
``ml_recipe_tpu/resilience/coordination.py``, the same file schema, so
each package reads the other's host and child documents).

One supervisor per host is blind: when a PEER host dies, every surviving
child either wedges inside a collective (NCCL) or fails it (gloo), and
nothing tells the survivors' supervisors why. This module is the
cross-host signal plane that fixes that: per-host JSON files written
atomically (tmp + rename, so a reader never sees a torn document on a
local filesystem) in ONE shared directory under the experiment dir.

Protocol (one file per host, ``pod/host-<N>.json``):

- every supervisor periodically ``publish()``-es its own file: schema
  version, status (``running`` / ``restarting`` / ``done`` / ``failed``),
  the pod ``generation``, its attempt index, a wall-clock heartbeat stamp
  and the child's last reported step (the straggler signal);
- the child (trainer) side beats through ``write_child_heartbeat``
  (wired off the step watchdog), so a host's published step advances at
  training cadence, not just supervisor-poll cadence;
- supervisors read every peer file with :func:`read_coordination_json`,
  the one guarded reader: absence is a protocol signal returned
  immediately, a torn/unparsable read is retried with bounded backoff
  (shared filesystems expose mid-replace windows) and only then degraded
  to None, and a schema mismatch raises: an old sidecar must be rejected
  loudly, never misread quietly.

Generation protocol: the pod generation is a monotonically increasing
restart epoch. Any supervisor that decides the pod must restart (its own
child crashed, or it declared a peer host dead) bumps the generation and
publishes it; every other supervisor that observes a generation above its
own kills its child immediately and restarts at the new generation. That
single rule is what turns N independent retry loops into one coordinated
elastic pod: no leader, no extra channel.

Everything here is stdlib-only: the supervisor must not pay the torch
import (the same contract as :mod:`.supervisor` and
:mod:`..metrics.goodput`).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional, Sequence

from ..metrics.artifacts import atomic_write_json, wall_now

logger = logging.getLogger(__name__)

# Directory (under the experiment dir) holding the per-host files.
COORD_DIRNAME = "pod"

# Bump on ANY incompatible change to the documents below. A reader that
# meets another version raises CoordinationSchemaError: a pod where half
# the hosts run an older build must fail loudly at the first read, not
# half-coordinate.
COORD_SCHEMA_VERSION = 1

_HOST_FILE = "host-{host:03d}.json"
_CHILD_FILE = "child-{host:03d}.json"

# Environment override the elastic supervisor sets in every child:
# "<world_size>:<process_id>" for the CURRENT live world, so a shrunk pod
# re-forms without argv rewrites (parallel/dist.py honors it before the
# params-derived topology). Defined here, not in parallel.dist, so the
# supervisor can import it without paying the torch import.
ELASTIC_WORLD_ENV = "MLRT_ELASTIC_WORLD"


class CoordinationSchemaError(RuntimeError):
    """A coordination/sidecar document carries a different (or missing)
    schema version — written by an incompatible build."""


def read_coordination_json(
    path,
    *,
    retries: int = 3,
    base_delay: float = 0.05,
    factor: float = 2.0,
    sleep=time.sleep,
) -> Optional[dict]:
    """THE guarded read for supervisor/coordination JSON.

    - Absent file -> ``None`` immediately: absence is a protocol state (a
      host that has not published yet), not an error to retry.
    - Torn or unparsable content -> bounded retry with exponential
      backoff. Writers are atomic, but shared filesystems (NFS close-to-
      open, object-store gateways) still expose transient windows; a
      transient torn read must NOT be reported as a dead host. After the
      budget it degrades to ``None`` with a warning.
    - Schema mismatch (missing or different ``schema`` field) -> raises
      :class:`CoordinationSchemaError`. An old sidecar is a deployment
      error to surface, never data to act on.
    """
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
                    f"COORD: unreadable after {retries + 1} attempt(s): "
                    f"{path}: {e!r}; treating as absent."
                )
                return None
            logger.warning(
                f"COORD: torn read of {path} (attempt {attempt + 1}/"
                f"{retries + 1}): {e!r}; retrying in {delay:.2f}s."
            )
            sleep(delay)
            delay *= factor
            continue
        if not isinstance(doc, dict):
            logger.warning(f"COORD: non-object document in {path}; ignoring.")
            return None
        schema = doc.get("schema")
        if schema != COORD_SCHEMA_VERSION:
            raise CoordinationSchemaError(
                f"{path} carries schema {schema!r}, this build requires "
                f"{COORD_SCHEMA_VERSION} — written by an incompatible "
                f"(older?) build; refusing to interpret it."
            )
        return doc
    return None


def write_child_heartbeat(coord_dir, host: int, *, step: Optional[int]) -> None:
    """The trainer-side beat (wired off the watchdog's ``add_on_beat``):
    the child's last completed step plus a wall stamp. Failures degrade
    heartbeating, never training."""
    path = os.path.join(os.fspath(coord_dir), _CHILD_FILE.format(host=int(host)))
    doc = {
        "schema": COORD_SCHEMA_VERSION,
        "host": int(host),
        "pid": os.getpid(),
        "step": None if step is None else int(step),
        "heartbeat": wall_now(),
    }
    try:
        atomic_write_json(path, doc)
    except OSError as e:
        logger.warning(f"COORD: could not write child heartbeat {path}: {e}")


class PodCoordinator:
    """This host's handle on the shared coordination directory.

    Thin by design: it publishes THIS host's document atomically and reads
    peers' documents through the guarded reader. All policy — staleness
    thresholds, generation adoption, who restarts whom — lives in the
    :class:`~.supervisor.ElasticSupervisor`, where it is unit-testable
    against hand-written peer files.
    """

    def __init__(self, coord_dir, *, host: int, n_hosts: int,
                 read_retries: int = 3, sleep=time.sleep):
        self.coord_dir = os.fspath(coord_dir)
        self.host = int(host)
        self.n_hosts = max(1, int(n_hosts))
        self.read_retries = int(read_retries)
        self._sleep = sleep

    # -- paths -----------------------------------------------------------------

    def host_path(self, host: int) -> str:
        return os.path.join(self.coord_dir, _HOST_FILE.format(host=int(host)))

    def child_path(self, host: int) -> str:
        return os.path.join(self.coord_dir, _CHILD_FILE.format(host=int(host)))

    # -- writes ----------------------------------------------------------------

    def publish(
        self,
        status: str,
        *,
        generation: int,
        attempt: int,
        step: Optional[int] = None,
        exit_class: Optional[str] = None,
        live_hosts: Optional[Sequence[int]] = None,
    ) -> None:
        """Atomically publish this host's document. A publish failure is
        logged and swallowed: a transient FS error must not kill the
        supervisor — peers only misread us if it PERSISTS, which is
        exactly the host-lost signal."""
        doc = {
            "schema": COORD_SCHEMA_VERSION,
            "host": self.host,
            "pid": os.getpid(),
            "status": str(status),
            "generation": int(generation),
            "attempt": int(attempt),
            "step": None if step is None else int(step),
            "exit_class": exit_class,
            "live_hosts": None if live_hosts is None else list(live_hosts),
            "heartbeat": wall_now(),
        }
        try:
            atomic_write_json(self.host_path(self.host), doc)
        except OSError as e:
            logger.warning(
                f"COORD: host {self.host} could not publish "
                f"{self.host_path(self.host)}: {e}"
            )

    # -- reads -----------------------------------------------------------------

    def peer_state(self, host: int) -> Optional[dict]:
        """One peer's document through the guarded reader (None when the
        peer has not published / the file degraded to unreadable).
        Schema mismatches propagate: see :func:`read_coordination_json`."""
        return read_coordination_json(
            self.host_path(host), retries=self.read_retries, sleep=self._sleep
        )

    def child_step(self, host: int) -> Optional[int]:
        """The child-side heartbeat step for ``host`` (None when the child
        never beat, or the file degraded)."""
        try:
            doc = read_coordination_json(
                self.child_path(host), retries=self.read_retries,
                sleep=self._sleep,
            )
        except CoordinationSchemaError as e:
            logger.error(f"COORD: rejecting child heartbeat: {e}")
            return None
        if doc is None:
            return None
        step = doc.get("step")
        return int(step) if isinstance(step, (int, float)) else None

    def peer_states(self) -> Dict[int, Optional[dict]]:
        """Every OTHER host's document, keyed by host id."""
        return {
            h: self.peer_state(h)
            for h in range(self.n_hosts)
            if h != self.host
        }
