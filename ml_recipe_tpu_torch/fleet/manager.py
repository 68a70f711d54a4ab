"""Fleet supervisor: N engine child processes + rolling restarts (the port
of ``ml_recipe_tpu/fleet/manager.py``).

One manager owns N ``ml_recipe_tpu_torch.cli.serve`` subprocesses (one QA
engine each, ephemeral ports, ready-file handshake) and applies the
``resilience/`` process-supervision contract to every child:

- exits are classified with ``resilience.supervisor.classify_exit`` (0 =
  clean drain, 87 = watchdog hang abort, 75/SIGTERM-death = preempted,
  else crash);
- shutdown is the serve drain contract: SIGTERM, admitted requests flush
  to real 200s, exit 0 (``serve/server.py``);
- a crashed child is relaunched with a bounded per-engine budget
  (``max_restarts``), loading the kernel libraries the checkout has built.

**Rolling restart** is the first-class verb: one engine at a time is
cordoned on the router (no new traffic; its ring keys spill to the
successor), drained via SIGTERM (in-flight work answers normally),
relaunched, asserted to have started with ZERO kernel builds
(``qa_aot_cache_misses_total == 0`` and ``qa_kernel_build_misses_total ==
0`` on the replacement: every library came from the store the engines
share, ``ops/aot.py``; ``config/fleet.cfg`` names it with ``aot_cache``),
then re-admitted to the ring before the next engine is touched. The tier
never loses more than one engine of capacity and never pays a build. A
replacement captures its buckets' CUDA graphs again: a capture is not a
compile, and graphs do not outlive their process.

Multi-checkpoint routing: ``checkpoints`` assigns one checkpoint per
engine (A/B serving in one tier). The weights-fingerprint cache keys
already isolate cached results per checkpoint, so the ring simply pins
each document to one engine, whichever checkpoint it serves.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..metrics.aggregator import parse_prometheus_text
from ..resilience.supervisor import CLEAN, classify_exit
from .router import EngineEndpoint, FleetRouter

logger = logging.getLogger(__name__)

__all__ = ["EngineHandle", "FleetError", "FleetManager"]


class FleetError(RuntimeError):
    """A fleet lifecycle step failed (launch, drain, zero-build check)."""


class EngineHandle:
    """One supervised engine child."""

    def __init__(self, index: int, argv: List[str], ready_file: Path,
                 log_path: Path, checkpoint: Optional[str]):
        self.index = index
        self.node_id = f"engine{index}"
        self.argv = argv
        self.ready_file = ready_file
        self.log_path = log_path
        self.checkpoint = checkpoint
        self.proc: Optional[subprocess.Popen] = None
        self.host = ""
        self.port = 0
        self.restarts = 0

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def log_tail(self, n: int = 4000) -> str:
        try:
            return self.log_path.read_text(errors="replace")[-n:]
        except OSError as e:
            return f"<no log: {e}>"


class FleetManager:
    """Launches, drains, restarts, and classifies N engine children."""

    def __init__(
        self,
        engine_argv: Sequence[str],
        *,
        n_engines: int = 2,
        run_dir: Path,
        checkpoints: Optional[Sequence[Optional[str]]] = None,
        env: Optional[Dict[str, str]] = None,
        ready_timeout_s: float = 600.0,
        drain_timeout_s: float = 30.0,
        kill_grace_s: float = 10.0,
        max_restarts: int = 2,
        router: Optional[FleetRouter] = None,
    ):
        if n_engines < 1:
            raise ValueError(f"n_engines must be >= 1, got {n_engines}")
        if checkpoints is not None and len(checkpoints) not in (1, n_engines):
            raise ValueError(
                f"checkpoints must have 1 or {n_engines} entries, "
                f"got {len(checkpoints)}")
        self.engine_argv = list(engine_argv)
        self.n_engines = int(n_engines)
        self.run_dir = Path(run_dir)
        self.ready_timeout_s = float(ready_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.kill_grace_s = float(kill_grace_s)
        self.max_restarts = int(max_restarts)
        self.router = router
        self._env = dict(env if env is not None else os.environ)
        self._lock = threading.Lock()

        self.engines: List[EngineHandle] = []
        for i in range(self.n_engines):
            ckpt = None
            if checkpoints:
                ckpt = checkpoints[i] if len(checkpoints) > 1 else checkpoints[0]
            self.engines.append(EngineHandle(
                index=i,
                argv=list(self.engine_argv)
                + (["--checkpoint", str(ckpt)] if ckpt else []),
                ready_file=self.run_dir / f"engine{i}.ready.json",
                log_path=self.run_dir / f"engine{i}.log",
                checkpoint=str(ckpt) if ckpt else None,
            ))

    # -- launch ----------------------------------------------------------------

    def _launch(self, handle: EngineHandle) -> None:
        self.run_dir.mkdir(parents=True, exist_ok=True)
        handle.ready_file.unlink(missing_ok=True)
        env = dict(self._env)
        # per-engine host id, as the JAX package stamps its children (the
        # fault grammar's %hostN scope there)
        env["MLRT_HOST"] = str(handle.index)
        argv = [
            sys.executable, "-m", "ml_recipe_tpu_torch.cli.serve",
            *handle.argv,
            "--port", "0",
            "--ready_file", str(handle.ready_file),
        ]
        with open(handle.log_path, "ab") as log:
            handle.proc = subprocess.Popen(
                argv, env=env, stdout=log, stderr=subprocess.STDOUT,
            )
        logger.info("launched %s pid=%d", handle.node_id, handle.proc.pid)

    def _wait_ready(self, handle: EngineHandle) -> None:
        deadline = time.monotonic() + self.ready_timeout_s
        while not handle.ready_file.exists():
            rc = handle.proc.poll() if handle.proc is not None else None
            if rc is not None:
                raise FleetError(
                    f"{handle.node_id} exited rc={rc} "
                    f"({classify_exit(rc)}) before ready:\n"
                    f"{handle.log_tail()}")
            if time.monotonic() > deadline:
                raise FleetError(
                    f"{handle.node_id} not ready within "
                    f"{self.ready_timeout_s:.0f}s:\n{handle.log_tail()}")
            time.sleep(0.2)
        info = json.loads(handle.ready_file.read_text())
        handle.host, handle.port = info["host"], int(info["port"])

    def start(self) -> List[EngineEndpoint]:
        """Launch every engine, wait until all are ready (buckets warmed),
        and return their endpoints (registering them on the attached
        router)."""
        with self._lock:
            for handle in self.engines:
                self._launch(handle)
            for handle in self.engines:
                self._wait_ready(handle)
            endpoints = [
                EngineEndpoint(h.node_id, h.host, h.port, h.checkpoint)
                for h in self.engines
            ]
            if self.router is not None:
                for ep in endpoints:
                    self.router.add_engine(ep)
            return endpoints

    # -- drain / stop ----------------------------------------------------------

    def _drain_child(self, handle: EngineHandle) -> int:
        """SIGTERM one child and wait for the drain to finish; returns the
        exit code (kills on a blown drain budget)."""
        assert handle.proc is not None
        handle.proc.send_signal(signal.SIGTERM)
        try:
            return handle.proc.wait(
                timeout=self.drain_timeout_s + self.kill_grace_s)
        except subprocess.TimeoutExpired:
            logger.warning("%s blew the drain budget; killing",
                           handle.node_id)
            handle.proc.kill()
            return handle.proc.wait(timeout=self.kill_grace_s)

    def stop(self) -> Dict[str, str]:
        """Drain every live child; returns {node_id: exit class}."""
        with self._lock:
            outcome: Dict[str, str] = {}
            for handle in self.engines:
                if handle.proc is None or handle.proc.poll() is not None:
                    continue
                rc = self._drain_child(handle)
                outcome[handle.node_id] = classify_exit(rc)
            return outcome

    # -- rolling restart -------------------------------------------------------

    def rolling_restart(self, *, require_zero_builds: bool = True) -> List[dict]:
        """Drain + relaunch each engine in turn, one at a time.

        Per engine: cordon on the router (keys spill to the ring
        successor, nothing new is routed here) -> SIGTERM drain (admitted
        requests flush to 200s, exit 0 asserted) -> relaunch -> assert the
        replacement started with zero kernel builds and zero store misses
        -> re-admit to the
        ring. Returns one report dict per engine.
        """
        reports = []
        for handle in self.engines:
            with self._lock:
                if self.router is not None:
                    self.router.cordon(handle.node_id)
                old_port = handle.port
                rc = self._drain_child(handle)
                exit_class = classify_exit(rc)
                if exit_class != CLEAN:
                    raise FleetError(
                        f"rolling restart: {handle.node_id} drain exited "
                        f"rc={rc} ({exit_class}), expected clean:\n"
                        f"{handle.log_tail()}")
                t0 = time.monotonic()
                self._launch(handle)
                self._wait_ready(handle)
                ready_s = time.monotonic() - t0
                builds = self._build_counters(handle)
                if require_zero_builds and (builds["misses"] != 0
                                            or builds["aot_misses"] != 0):
                    raise FleetError(
                        f"rolling restart: {handle.node_id} built "
                        f"{builds['misses']} kernel library(ies) "
                        f"({builds['aot_misses']} store misses); the shared "
                        f"library store should have made it zero")
                if self.router is not None:
                    self.router.replace_engine(
                        handle.node_id, handle.host, handle.port)
                    self.router.readmit(handle.node_id)
                reports.append({
                    "node": handle.node_id,
                    "old_port": old_port,
                    "new_port": handle.port,
                    "drain_exit": exit_class,
                    "ready_seconds": round(ready_s, 3),
                    "build_hits": builds["hits"],
                    "build_misses": builds["misses"],
                    "aot_hits": builds["aot_hits"],
                    "aot_misses": builds["aot_misses"],
                })
                logger.info("rolling restart: %s done (%s)",
                            handle.node_id, reports[-1])
        return reports

    def _build_counters(self, handle: EngineHandle) -> Dict[str, int]:
        """Scrape qa_kernel_build_{hits,misses}_total and
        qa_aot_cache_{hits,misses}_total off one engine."""
        url = f"http://{handle.host}:{handle.port}/metrics"
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                text = resp.read().decode("utf-8", errors="replace")
        except OSError as e:
            raise FleetError(
                f"cannot scrape {handle.node_id} warmup metrics: {e}"
            ) from e
        _, samples = parse_prometheus_text(text)
        counters = {name: value for name, _, value in samples}
        for name in ("qa_kernel_build_misses_total",
                     "qa_aot_cache_misses_total"):
            if name not in counters:
                raise FleetError(
                    f"{handle.node_id}'s /metrics has no {name}")
        return {
            "hits": int(counters.get("qa_kernel_build_hits_total", 0)),
            "misses": int(counters["qa_kernel_build_misses_total"]),
            "aot_hits": int(counters.get("qa_aot_cache_hits_total", 0)),
            "aot_misses": int(counters["qa_aot_cache_misses_total"]),
        }

    # -- crash supervision -----------------------------------------------------

    def reap(self, *, restart: bool = True) -> List[dict]:
        """Classify children that exited unexpectedly; relaunch crashed
        ones within the per-engine ``max_restarts`` budget. The attached
        router's health poll ejects a dead engine on its own — this hook
        restores capacity behind it."""
        events = []
        with self._lock:
            for handle in self.engines:
                if handle.proc is None:
                    continue
                rc = handle.proc.poll()
                if rc is None:
                    continue
                exit_class = classify_exit(rc)
                event = {"node": handle.node_id, "rc": rc,
                         "class": exit_class, "relaunched": False}
                if restart and exit_class != CLEAN \
                        and handle.restarts < self.max_restarts:
                    handle.restarts += 1
                    self._launch(handle)
                    self._wait_ready(handle)
                    if self.router is not None:
                        self.router.replace_engine(
                            handle.node_id, handle.host, handle.port)
                        self.router.readmit(handle.node_id)
                    event["relaunched"] = True
                else:
                    handle.proc = None  # spent: stop re-reporting it
                events.append(event)
                logger.warning("reaped %s", event)
        return events
