"""The tuning cache's cost plane (the port of ``ml_recipe_tpu/ops/autotune.py``).

The serving engine records one measured cost per bucket PROGRAM (the
scoring forward at one ``(batch, seq)`` shape) and the micro-batcher ranks
deadline flushes by it (``serve/batcher.py``). Costs persist in a JSON file
per device kind under ``artifacts/tuning/`` (``--autotune_cache`` or
``MLRT_AUTOTUNE_CACHE`` overrides the directory), with the JAX package's
discipline:

- the file names its ``toolchain`` (torch, CUDA and ``nvcc`` versions in
  place of jax and jaxlib): a file another toolchain wrote is ignored, with
  a warning, and rewritten;
- a corrupt file degrades to an empty cache, never to a crash;
- writes merge what is on disk first (another process may share the
  directory) and replace the file atomically;
- ``MLRT_AUTOTUNE`` ``0``/``false``/``off`` (or ``--autotune false``)
  disables it: nothing is recorded or read.

A cost is measured, never modeled: ``{"est_seconds": s, "source":
"measured"}``, where ``s`` is the median of a few CUDA-graph replays timed
by CUDA events on the card, or of the eager forward timed by
``perf_counter`` on the CPU (``serve/engine.py``). The files are named
``<device kind>.torch.json``, so the JAX package's files in a shared
directory are neither read nor overwritten.

The geometry selector of the JAX module (``select``) is not ported: every
kernel of the port has one compiled geometry, so it would have no caller
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_CACHE_VERSION = 1
# env override for the cache directory
ENV_CACHE_DIR = "MLRT_AUTOTUNE_CACHE"
# "0"/"false"/"off" disables the tuning cache process-wide
ENV_ENABLED = "MLRT_AUTOTUNE"


def default_cache_dir() -> Path:
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "artifacts" / "tuning"


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


def _toolchain() -> str:
    """Cache invalidation key: a cost measured under one torch / CUDA /
    ``nvcc`` set must not outlive it."""
    try:
        import torch

        from .cuda_build import nvcc_version

        return (f"torch-{torch.__version__}+cuda-{torch.version.cuda}"
                f"+nvcc-{nvcc_version()}")
    except Exception:  # noqa: BLE001 - no version = never match = re-measure
        return "unknown"


def _device_kind() -> str:
    """Cache partition key: the card's name (a cost measured on one card
    must never rank flushes on another), ``cpu`` without CUDA."""
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name(torch.cuda.current_device())
        return "cpu"
    except Exception:  # noqa: BLE001 - no device = no persistent verdicts
        return "unknown"


def _sanitize(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", kind.strip()) or "unknown"


class CostTuner:
    """Process-wide tuning cache of measured program costs.

    ``probe_count`` counts the measurements taken this session (a warm
    restart takes none); ``hits``/``misses`` count ``lookup_cost`` calls
    that found, or did not find, a cost."""

    def __init__(self, cache_dir: Optional[Path] = None,
                 enabled: Optional[bool] = None):
        self.enabled = _env_enabled() if enabled is None else enabled
        self._cache_dir = Path(cache_dir) if cache_dir else None
        self.probe_count = 0
        self.hits = 0
        self.misses = 0
        self._entries: Dict[str, Dict[str, dict]] = {}  # kind -> key -> entry
        self._loaded: set = set()
        self._session: List[dict] = []
        self._lock = threading.RLock()

    # -- configuration -------------------------------------------------------

    @property
    def cache_dir(self) -> Path:
        # resolved lazily so an env override set after import still applies
        return self._cache_dir if self._cache_dir else default_cache_dir()

    def set_cache_dir(self, cache_dir) -> None:
        with self._lock:
            self._cache_dir = Path(cache_dir) if cache_dir else None
            self._entries.clear()
            self._loaded.clear()

    # -- persistence -----------------------------------------------------------

    def _cache_file(self, kind: str) -> Path:
        return self.cache_dir / f"{_sanitize(kind)}.torch.json"

    @staticmethod
    def _valid_entry(value) -> bool:
        return isinstance(value, dict) and "geometry" in value

    def _read(self, path: Path) -> Dict[str, dict]:
        """The valid entries of ``path`` when its version and toolchain are
        this process's; raises what reading or parsing raises."""
        raw = json.loads(path.read_text())
        if raw.get("version") != _CACHE_VERSION:
            raise ValueError(f"version {raw.get('version')!r}, want "
                             f"{_CACHE_VERSION}")
        if raw.get("toolchain") != _toolchain():
            raise LookupError(raw.get("toolchain"))
        return {k: v for k, v in (raw.get("entries") or {}).items()
                if self._valid_entry(v)}

    def _load(self, kind: str) -> None:
        if kind in self._loaded:
            return
        self._loaded.add(kind)
        path = self._cache_file(kind)
        entries: Dict[str, dict] = {}
        try:
            entries = self._read(path)
        except FileNotFoundError:
            pass
        except LookupError as e:
            logger.warning(
                "autotune: tuning cache %s was written by toolchain %r "
                "(running %r); ignoring it and measuring again",
                path, e.args[0], _toolchain())
        except (OSError, ValueError, KeyError, AttributeError, TypeError) as e:
            # corrupt cache: degrade to measuring again, never to a crash;
            # the next record rewrites the file whole
            logger.warning(
                "autotune: corrupt tuning cache %s (%s: %s); starting fresh",
                path, type(e).__name__, e)
        self._entries.setdefault(kind, {}).update(entries)

    def _persist(self, kind: str) -> None:
        path = self._cache_file(kind)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            # merge-before-write: another process sharing the directory may
            # have persisted keys since our lazy _load
            try:
                disk = self._read(path)
            except (OSError, ValueError, LookupError, KeyError,
                    AttributeError, TypeError):
                disk = {}   # unreadable or foreign file: ours replace it
            payload = {
                "version": _CACHE_VERSION,
                "device_kind": kind,
                "toolchain": _toolchain(),
                "entries": {**disk, **self._entries.get(kind, {})},
            }
            tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
            tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("autotune: could not persist tuning cache %s: %s",
                           path, e)

    # -- whole-program costs (serving flush ranking) ----------------------------

    def record_cost(self, key: str, est: dict) -> None:
        """Persist one whole-program cost (``{"est_seconds": s, "source":
        "measured", ...}``) under ``key``; counts one measurement."""
        if not self.enabled:
            return
        with self._lock:
            kind = _device_kind()
            self._load(kind)
            self.probe_count += 1
            self._entries.setdefault(kind, {})[key] = {
                "geometry": None,
                "source": "cost",
                "cost_estimates": {"program": dict(est)},
            }
            self._persist(kind)
            self._session.append({"key": key, "outcome": "miss",
                                  "source": est.get("source", "measured")})

    def lookup_cost(self, key: str) -> Optional[dict]:
        """The persisted whole-program cost for ``key``, or None."""
        if not self.enabled:
            return None
        with self._lock:
            kind = _device_kind()
            self._load(kind)
            ent = self._entries.get(kind, {}).get(key)
            est = ((ent.get("cost_estimates") or {}).get("program")
                   if isinstance(ent, dict) else None)
            if not isinstance(est, dict) or "est_seconds" not in est:
                self.misses += 1
                return None
            self.hits += 1
            self._session.append({"key": key, "outcome": "hit",
                                  "source": "cache"})
            return dict(est)

    # -- session provenance ----------------------------------------------------

    def session_summary(self) -> dict:
        """The JAX summary's keys: the overall outcome (``hit`` only when
        every decision came from the cache), the measurement and lookup
        counters, and each decided key's outcome and source."""
        with self._lock:
            if not self.enabled:
                overall = "disabled"
            elif not self._session:
                overall = "unused"
            elif any(d["outcome"] == "miss" for d in self._session):
                overall = "miss"
            else:
                overall = "hit"
            decisions = {d["key"]: {"regime": "serve-step", "geometry": None,
                                    "outcome": d["outcome"],
                                    "source": d["source"]}
                         for d in self._session}
            return {
                "cache": overall,
                "probes": self.probe_count,
                "hits": self.hits,
                "misses": self.misses,
                "decisions": decisions,
            }


_instance: Optional[CostTuner] = None


def get() -> CostTuner:
    """The process-wide tuning cache (created on first use)."""
    global _instance
    if _instance is None:
        _instance = CostTuner()
    return _instance


def configure(*, enabled: Optional[bool] = None,
              cache_dir=None) -> CostTuner:
    """(Re)configure the process-wide tuning cache: the CLI wiring for
    ``--autotune`` / ``--autotune_cache``."""
    inst = get()
    if enabled is not None:
        inst.enabled = enabled
    if cache_dir is not None:
        inst.set_cache_dir(cache_dir)
    return inst


def reset() -> CostTuner:
    """Drop the process-wide tuning cache and return a fresh one (tests)."""
    global _instance
    _instance = None
    return get()
