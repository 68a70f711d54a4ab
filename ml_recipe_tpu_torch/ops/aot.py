"""The store of built kernel libraries: zero-build warm restarts (the port
of ``ml_recipe_tpu/ops/aot.py``).

The JAX package stores compiled XLA programs, so that a restarted trainer
or a serving replica of a rolling restart deserializes them instead of
compiling. On CUDA the compiled artifacts are the ``nvcc``-built kernel
libraries of ``csrc/`` (``ops/cuda_build.py`` builds and loads every one
through this store); a serving bucket's "program" is a CUDA graph captured
at warm-up, which is not a compile and is captured again by every process
(``serve/engine.py``).

Artifact anatomy (one file per library under ``<cache_dir>/<device
kind>/``):

- filename = ``<name>.ptaot``: the LOOKUP key is the library's name and
  the card's name (the directory); the target architecture is part of the
  fingerprint;
- content = the magic ``MLRTPTAOT1`` + one JSON header line + the shared
  library's bytes. The header carries the VALIDITY fingerprint: ``code`` (a
  hash of the source, the shared headers and the ``nvcc`` flags, mixed with
  ``MLRT_AOT_SALT``), the ``torch`` and ``cuda`` versions, the ``nvcc``
  version and the ``arch``; and the blob's length and sha256.

A stale fingerprint misses loudly (one log line naming each changed
component) and rebuilds; a corrupt or truncated blob is deleted and
rebuilt; writes go through a temporary file and a rename, so a process
warming up beside another never reads a torn blob. ``--aot_cache_bytes``
(``MLRT_AOT_CACHE_BYTES``) bounds the store: the oldest artifacts go first
after each write. With the store off (``--aot_cache off``, ``MLRT_AOT=0``)
every library is built by this process (outcome ``bypass``) and nothing is
written.

The store's directory is ``ml_recipe_tpu_torch/csrc/build/`` (git-ignored),
or ``MLRT_AOT_CACHE``, or ``--aot_cache DIR``. The magic and the suffix
differ from the JAX package's (``MLRTAOT1``, ``.aot``), so the two
packages' tools never read each other's files in a shared directory.

The inspection tool is stdlib-only (it imports neither torch nor anything
else of the package) and keeps the JAX tool's output and exit codes::

    python -m ml_recipe_tpu_torch.ops.aot --list
    python -m ml_recipe_tpu_torch.ops.aot --verify
    python -m ml_recipe_tpu_torch.ops.aot --evict --aot_cache_bytes 512M
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

_MAGIC = b"MLRTPTAOT1\n"
_SUFFIX = ".ptaot"
_STORE_VERSION = 1

# "0"/"false"/"off" disables the store process-wide (every library built)
ENV_ENABLED = "MLRT_AOT"
# the store's directory
ENV_CACHE_DIR = "MLRT_AOT_CACHE"
# byte budget for the store (K/M/G suffixes); unset/0 = unbounded
ENV_CACHE_BYTES = "MLRT_AOT_CACHE_BYTES"
# extra fingerprint salt: a fleet-wide invalidation lever that needs no
# source change
ENV_SALT = "MLRT_AOT_SALT"

# validity components, compared in this order on lookup
FINGERPRINT_COMPONENTS = ("code", "torch", "cuda", "nvcc", "arch")


def default_cache_dir() -> Path:
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[1] / "csrc" / "build"


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


def parse_bytes(text) -> Optional[int]:
    """``'512M'`` -> 536870912. None/''/0 -> None (unbounded). Accepts
    K/M/G suffixes (binary units) and plain byte counts."""
    if text is None:
        return None
    if isinstance(text, (int, float)):
        value = int(text)
        return value if value > 0 else None
    text = str(text).strip()
    if not text:
        return None
    match = re.fullmatch(r"(\d+)\s*([kKmMgG]?)[bB]?", text)
    if not match:
        raise ValueError(
            f"unparseable byte budget {text!r} (want e.g. 512M, 2G, 1048576)"
        )
    value = int(match.group(1))
    scale = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[
        match.group(2).lower()
    ]
    value *= scale
    return value if value > 0 else None


def _device_kind() -> str:
    """Store partition key: the card's name, the tuning cache's discipline
    (a library built for one card is never loaded on another)."""
    from . import autotune

    return autotune._device_kind()


def _toolchain_versions() -> Dict[str, str]:
    """The ``torch``, ``cuda`` and ``nvcc`` components of the fingerprint."""
    try:
        import torch

        from .cuda_build import nvcc_version

        return {"torch": str(torch.__version__),
                "cuda": str(torch.version.cuda),
                "nvcc": nvcc_version()}
    except Exception:  # noqa: BLE001 - no version = never match = rebuild
        return {"torch": "unknown", "cuda": "unknown", "nvcc": "unknown"}


def _salted(code: str) -> str:
    """``code`` mixed with ``MLRT_AOT_SALT`` (read per call, so an operator
    or a test can flip it without a new process)."""
    salt = os.environ.get(ENV_SALT, "")
    if salt:
        return hashlib.sha256(f"{code}+{salt}".encode()).hexdigest()[:16]
    return code


def _sanitize_part(part) -> str:
    """Filename-safe key component."""
    return re.sub(r"[^A-Za-z0-9._-]+", "_", str(part))


# -- artifact file I/O ---------------------------------------------------------

def _read_artifact(path: Path):
    """``(header, blob, problem)``: problem is None when the artifact is
    structurally sound, ``'absent'`` when missing, else a human-readable
    corruption verdict (the ``--verify`` tool prints these verbatim)."""
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return None, None, "absent"
    except OSError as e:
        return None, None, f"unreadable ({e})"
    if not raw.startswith(_MAGIC):
        return None, None, "corrupt (bad magic)"
    try:
        end = raw.index(b"\n", len(_MAGIC))
        header = json.loads(raw[len(_MAGIC):end])
    except ValueError:
        return None, None, "corrupt (torn header)"
    if not isinstance(header, dict):
        return None, None, "corrupt (header is not an object)"
    blob = raw[end + 1:]
    want = header.get("blob_bytes")
    if want != len(blob):
        return None, None, (
            f"corrupt (truncated: {len(blob)} of {want} blob bytes)"
        )
    if header.get("blob_sha256") != hashlib.sha256(blob).hexdigest():
        return None, None, "corrupt (blob checksum mismatch)"
    return header, blob, None


def _iter_artifacts(cache_dir) -> Iterator[Tuple[Path, Optional[dict],
                                                 Optional[str]]]:
    """Every artifact under the store, with its parsed header (or the
    corruption verdict)."""
    root = Path(cache_dir)
    if not root.is_dir():
        return
    for path in sorted(root.rglob(f"*{_SUFFIX}")):
        header, _, problem = _read_artifact(path)
        yield path, header, problem


def evict_to_budget(cache_dir, budget_bytes: Optional[int]) -> List[Path]:
    """Prune oldest-first (mtime) until the store's artifacts total fits
    ``budget_bytes``; returns the removed paths. No-op when unbounded."""
    if not budget_bytes or budget_bytes <= 0:
        return []
    root = Path(cache_dir)
    if not root.is_dir():
        return []
    entries = []
    for path in root.rglob(f"*{_SUFFIX}"):
        try:
            st = path.stat()
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, path))
    total = sum(size for _, size, _ in entries)
    removed: List[Path] = []
    for _, size, path in sorted(entries):
        if total <= budget_bytes:
            break
        try:
            path.unlink()
        except OSError:
            continue
        total -= size
        removed.append(path)
    if removed:
        logger.info(
            "AOT: evicted %d artifact(s) to fit the %d-byte budget "
            "(store now %d bytes).", len(removed), budget_bytes, total,
        )
    return removed


def verify_store(cache_dir) -> List[dict]:
    """``--verify``'s engine: one report row per artifact. Corrupt blobs are
    REPORTED (status carries the verdict), never deleted here."""
    rows = []
    for path, header, problem in _iter_artifacts(cache_dir):
        try:
            size = path.stat().st_size
        except OSError:
            size = None
        rows.append({
            "path": str(path),
            "status": "ok" if problem is None else problem,
            "bytes": size,
            "fingerprint": (header or {}).get("fingerprint"),
        })
    return rows


def _atomic_write_bytes(path: Path, payload: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp")
    try:
        with open(tmp, "wb") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


# -- the store -----------------------------------------------------------------

class ProgramCache:
    """Process-wide store of built kernel libraries: lookup -> (load |
    build -> store), keyed by (device kind, name) and validated by (code,
    torch, cuda, nvcc, arch).

    ``hits`` count libraries loaded from the store without an ``nvcc`` run;
    ``misses`` count builds while the store was on (a warm restart has
    none); ``bypass`` counts builds with the store off."""

    def __init__(self, cache_dir: Optional[Path] = None,
                 enabled: Optional[bool] = None,
                 cache_bytes: Optional[int] = None):
        self.enabled = _env_enabled() if enabled is None else enabled
        self._cache_dir = Path(cache_dir) if cache_dir else None
        self.cache_bytes = (
            cache_bytes if cache_bytes is not None
            else parse_bytes(os.environ.get(ENV_CACHE_BYTES))
        )
        self.hits = 0
        self.misses = 0
        self.bypass = 0
        self.evictions = 0
        self.load_times_s: List[float] = []
        self._session: List[dict] = []
        self._lock = threading.RLock()

    # -- configuration ---------------------------------------------------------

    @property
    def cache_dir(self) -> Path:
        # resolved lazily so an env override set after import still applies
        return self._cache_dir if self._cache_dir else default_cache_dir()

    def set_cache_dir(self, cache_dir) -> None:
        with self._lock:
            self._cache_dir = Path(cache_dir) if cache_dir else None

    # -- keys ------------------------------------------------------------------

    def fingerprint(self, code: str, arch: str) -> dict:
        """The validity fingerprint of an artifact built from ``code`` for
        ``arch`` by this process's toolchain."""
        return {"code": _salted(code), **_toolchain_versions(),
                "arch": str(arch)}

    def artifact_path(self, name: str, kind: Optional[str] = None) -> Path:
        kind = _device_kind() if kind is None else kind
        return (self.cache_dir / _sanitize_part(kind or "unknown")
                / f"{_sanitize_part(name)}{_SUFFIX}")

    # -- load / store ----------------------------------------------------------

    def lookup(self, name: str, fingerprint: dict) -> Tuple[
            Optional[bytes], str]:
        """``(blob, "hit")`` for a valid artifact, else ``(None, miss
        reason)``: ``absent``, ``corrupt`` (the artifact is deleted, so the
        rebuild replaces it) or ``stale:<components>`` (logged with each
        changed component). No accounting: :meth:`load_or_build_ex` does that."""
        path = self.artifact_path(name)
        header, blob, problem = _read_artifact(path)
        if problem == "absent":
            return None, "absent"
        if problem is not None:
            logger.warning(
                "AOT: MISS (corrupt) %s — %s; deleting the artifact and "
                "rebuilding.", path, problem,
            )
            try:
                path.unlink()
            except OSError:
                pass
            return None, "corrupt"
        stored = header.get("fingerprint") or {}
        changed = [c for c in FINGERPRINT_COMPONENTS
                   if stored.get(c) != fingerprint.get(c)]
        if changed:
            # the loud stale-invalidation contract: ONE line naming each
            # changed component; a stale library is never loaded
            logger.warning(
                "AOT: MISS (stale) %s — fingerprint changed: %s; "
                "rebuilding.", path,
                ", ".join(
                    f"component={c} artifact={stored.get(c)!r} "
                    f"current={fingerprint.get(c)!r}" for c in changed
                ),
            )
            return None, f"stale:{','.join(changed)}"
        return blob, "hit"

    def store(self, name: str, blob: bytes, fingerprint: dict) -> None:
        """Write one artifact atomically (best effort: a failed write costs
        persistence, never the run), then evict to the byte budget."""
        kind = _device_kind()
        path = self.artifact_path(name, kind)
        header = {
            "store_version": _STORE_VERSION,
            "name": name,
            "device_kind": kind,
            "fingerprint": dict(fingerprint),
            "blob_bytes": len(blob),
            "blob_sha256": hashlib.sha256(blob).hexdigest(),
            "created": time.time(),
        }
        payload = (_MAGIC + json.dumps(header, separators=(",", ":")).encode()
                   + b"\n" + blob)
        try:
            _atomic_write_bytes(path, payload)
        except OSError as e:
            logger.warning("AOT: could not persist artifact %s: %s", path, e)
            return
        with self._lock:
            removed = evict_to_budget(self.cache_dir, self.cache_bytes)
            self.evictions += len(removed)

    def load_or_build_ex(self, name: str, build_fn: Callable[[], bytes], *,
                         code: str, arch: str,
                         looked_up: Optional[Tuple[Optional[bytes], str]] = None,
                         started: Optional[float] = None):
        """``(blob, outcome, seconds)`` with outcome ``'hit'`` (loaded, no
        build), ``'miss'`` (built and stored: the artifact was absent,
        stale or corrupt) or ``'bypass'`` (the store is off: built, nothing
        written). ``looked_up`` is the caller's own :meth:`lookup` of the
        same fingerprint (the artifact is then not read again);
        ``seconds`` run from ``started`` (a ``perf_counter`` reading, by
        default this call's start). Build errors PROPAGATE; only store I/O
        degrades."""
        t0 = time.perf_counter() if started is None else started
        if not self.enabled:
            blob = build_fn()
            self._note(name, "bypass", None, time.perf_counter() - t0)
            return blob, "bypass", time.perf_counter() - t0
        fingerprint = self.fingerprint(code, arch)
        blob, reason = (looked_up if looked_up is not None
                        else self.lookup(name, fingerprint))
        if blob is not None:
            seconds = time.perf_counter() - t0
            self._note(name, "hit", None, seconds)
            return blob, "hit", seconds
        blob = build_fn()        # errors propagate to the caller
        self.store(name, blob, fingerprint)
        seconds = time.perf_counter() - t0
        self._note(name, "miss", reason, seconds)
        return blob, "miss", seconds

    # -- accounting ------------------------------------------------------------

    def _note(self, name: str, outcome: str, reason: Optional[str],
             seconds: float) -> None:
        with self._lock:
            if outcome == "hit":
                self.hits += 1
                self.load_times_s.append(seconds)
            elif outcome == "miss":
                self.misses += 1
            else:
                self.bypass += 1
            event: Dict[str, Any] = {
                "name": name, "outcome": outcome,
                "seconds": round(seconds, 6),
            }
            if reason and reason != "hit":
                event["reason"] = reason
            self._session.append(event)

    def session_summary(self) -> dict:
        """The overall outcome (``hit`` only when every library loaded from
        the store), the hit/miss/bypass counters and each library's
        event."""
        with self._lock:
            if not self.enabled:
                overall = "disabled"
            elif not self._session:
                overall = "unused"
            elif any(e["outcome"] == "miss" for e in self._session):
                overall = "miss"
            else:
                overall = "hit"
            return {
                "cache": overall,
                "hits": self.hits,
                "misses": self.misses,
                "bypass": self.bypass,
                "evictions": self.evictions,
                "load_s_total": round(sum(self.load_times_s), 6),
                "events": [dict(e) for e in self._session],
            }


_instance: Optional[ProgramCache] = None


def get() -> ProgramCache:
    """The process-wide store (created on first use)."""
    global _instance
    if _instance is None:
        _instance = ProgramCache()
    return _instance


def configure(*, enabled: Optional[bool] = None, cache_dir=None,
              cache_bytes=None) -> ProgramCache:
    """(Re)configure the process-wide store: the CLI wiring for
    ``--aot_cache`` / ``--aot_cache_bytes``."""
    inst = get()
    if enabled is not None:
        inst.enabled = enabled
    if cache_dir is not None:
        inst.set_cache_dir(cache_dir)
    if cache_bytes is not None:
        inst.cache_bytes = parse_bytes(cache_bytes)
    return inst


def configure_from_flags(params) -> ProgramCache:
    """``--aot_cache`` ('off' | a directory | None) and
    ``--aot_cache_bytes`` onto the process-wide store, as the JAX CLIs do."""
    value = getattr(params, "aot_cache", None)
    return configure(
        enabled=value != "off",
        cache_dir=value if value not in (None, "off") else None,
        cache_bytes=getattr(params, "aot_cache_bytes", 0) or None,
    )


def reset() -> ProgramCache:
    """Drop the process-wide store and return a fresh one (tests)."""
    global _instance
    _instance = None
    return get()


# -- inspection tool (stdlib-only) ---------------------------------------------

def _fmt_age(seconds: float) -> str:
    if seconds < 120:
        return f"{seconds:.0f}s"
    if seconds < 7200:
        return f"{seconds / 60:.0f}m"
    if seconds < 172800:
        return f"{seconds / 3600:.1f}h"
    return f"{seconds / 86400:.1f}d"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ml_recipe_tpu_torch.ops.aot",
        description="Inspect / verify / evict the store of built kernel "
                    "libraries.",
    )
    parser.add_argument(
        "--cache_dir", default=None,
        help="store root (default: $MLRT_AOT_CACHE or "
             "ml_recipe_tpu_torch/csrc/build)")
    parser.add_argument(
        "--list", action="store_true",
        help="enumerate artifacts with key, size, age and fingerprint")
    parser.add_argument(
        "--verify", action="store_true",
        help="check every artifact's header + blob checksum; corrupt or "
             "truncated blobs are reported (exit 1), not deleted")
    parser.add_argument(
        "--evict", action="store_true",
        help="prune oldest artifacts until the store fits "
             "--aot_cache_bytes")
    parser.add_argument(
        "--aot_cache_bytes", default=None,
        help="byte budget for --evict (K/M/G suffixes, e.g. 512M)")
    args = parser.parse_args(argv)

    cache_dir = Path(args.cache_dir) if args.cache_dir else default_cache_dir()
    if not (args.list or args.verify or args.evict):
        args.list = True

    status = 0
    if args.list:
        rows = list(_iter_artifacts(cache_dir))
        if not rows:
            print(f"AOT store {cache_dir}: empty")
        else:
            now = time.time()
            total = 0
            for path, header, problem in rows:
                try:
                    st = path.stat()
                except OSError:
                    continue
                total += st.st_size
                fp = (header or {}).get("fingerprint") or {}
                fp_text = (
                    " ".join(f"{k}={fp.get(k)}"
                             for k in FINGERPRINT_COMPONENTS)
                    if fp else f"<{problem}>"
                )
                print(
                    f"{path.relative_to(cache_dir)}  "
                    f"{st.st_size}B  age={_fmt_age(max(0.0, now - st.st_mtime))}  "
                    f"{fp_text}"
                )
            print(f"total: {len(rows)} artifact(s), {total} bytes")
    if args.verify:
        rows = verify_store(cache_dir)
        bad = [r for r in rows if r["status"] != "ok"]
        for row in rows:
            print(f"{row['status'].upper():<40}  {row['path']}")
        print(
            f"verified {len(rows)} artifact(s): {len(rows) - len(bad)} ok, "
            f"{len(bad)} corrupt"
        )
        if bad:
            status = 1
    if args.evict:
        budget = parse_bytes(args.aot_cache_bytes)
        if budget is None:
            parser.error("--evict requires --aot_cache_bytes (e.g. 512M)")
        removed = evict_to_budget(cache_dir, budget)
        for path in removed:
            print(f"evicted {path}")
        print(f"evicted {len(removed)} artifact(s)")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
