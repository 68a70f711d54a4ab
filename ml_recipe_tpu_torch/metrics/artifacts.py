"""Atomic on-disk telemetry artifacts (the port of
``ml_recipe_tpu/metrics/artifacts.py``).

Trace span files, flight-recorder dumps and the supervisor's sidecar are
read by another process (a human loading Perfetto, the supervisor's exit
classifier) while the writer may be killed at any byte, so they are
written tmp + ``os.replace``: a reader sees the old document or the new
one, never a torn half-write. The goodput ledger is an append-only JSONL
log (:func:`append_jsonl`: one ``os.write`` per record on an ``O_APPEND``
descriptor, so the supervisor and its child interleave whole lines), and
:func:`read_jsonl` skips the torn last line a killed writer leaves.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from datetime import datetime, timezone
from typing import Iterator, List, Optional

logger = logging.getLogger(__name__)


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


def atomic_write_bytes(path, payload: bytes) -> str:
    """Binary sibling of :func:`atomic_write_json` (tmp + ``os.replace``): a
    concurrent reader sees the old artifact or the new one, never a
    truncated blob."""
    path = os.fspath(path)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as fh:
        fh.write(payload)
    os.replace(tmp, path)
    return path


def append_jsonl(path, record: dict) -> None:
    """Append one JSON record as a single line via one ``os.write`` on an
    ``O_APPEND`` descriptor — POSIX appends of one small buffer land whole,
    so two processes appending to the same ledger interleave cleanly."""
    path = os.fspath(path)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    line = json.dumps(record, separators=(",", ":")) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)


def read_jsonl(path) -> List[dict]:
    """Every parseable record in ``path`` (empty list when absent). A torn
    final line — the writer was killed mid-append, which is exactly the
    scenario these logs exist to survive — is skipped with a debug note,
    never an error."""
    out: List[dict] = []
    try:
        with open(os.fspath(path)) as fh:
            lines: Iterator[str] = iter(fh.readlines())
    except OSError:
        return out
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except ValueError:
            logger.debug("skipping torn ledger line %s:%d", path, lineno)
            continue
        if isinstance(record, dict):
            out.append(record)
    return out
