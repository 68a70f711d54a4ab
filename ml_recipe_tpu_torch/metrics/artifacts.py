"""Atomic on-disk telemetry artifacts (the port of
``ml_recipe_tpu/metrics/artifacts.py``'s ``atomic_write_json`` and
``wall_now``; the JSONL ledger writers wait for ROADMAP.md queue 1,
'Runtime subsystems').

Trace span files are read by another process (a human loading Perfetto, a
trace merger) while the writer may be killed at any byte, so they are
written tmp + ``os.replace``: a reader sees the old document or the new
one, never a torn half-write.
"""

from __future__ import annotations

import json
import os
import threading
from datetime import datetime, timezone
from typing import Optional


def wall_now() -> float:
    """Wall-clock EVENT stamp (epoch seconds, UTC): cross-process artifacts
    (trace origins aligned across hosts) need one shared timeline, which
    only the wall clock provides; durations inside events stay
    ``perf_counter``-based."""
    return datetime.now(timezone.utc).timestamp()


def atomic_write_json(path, doc, *, indent: Optional[int] = None) -> str:
    """Serialize ``doc`` to ``path`` atomically (tmp + rename); returns the
    path. The tmp name carries pid and thread id, so two threads flushing
    one writer never interleave into one tmp file."""
    path = os.fspath(path)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=indent)
    os.replace(tmp, path)
    return path
