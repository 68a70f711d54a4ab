"""Goodput ledger: run-level wall-clock accounting that survives restarts
(the port of ``ml_recipe_tpu/metrics/goodput.py``: the same events, the
same partition).

The per-step breakdown (``train/telemetry.py``) answers "what is this step
doing right now"; across a supervised run with crashes and restarts the
question that decides pod economics is different: what fraction of total
wall-clock was PRODUCTIVE training (the goodput discipline of large-scale
training, arxiv 2204.06514), and where did the rest go — named.

The ledger is an append-only JSONL event log (atomic single-line appends,
``metrics.artifacts``) living next to ``supervisor_state.json`` in the
experiment directory, written by BOTH processes:

- the supervisor appends ``attempt_start`` / ``attempt_end`` at every
  attempt boundary (restart downtime = the gap between them);
- each training attempt appends ``run_start`` (the first step id it will
  execute — resumes reveal recomputed steps), bounded ``steps`` windows
  (productive vs data-wait vs first-step compile time), ``checkpoint`` /
  ``eval`` durations and ``run_end``.

:func:`summarize_events` partitions ``[first event, last event]`` into
productive step time plus the named badput categories; ``other`` is the
explicit residual, so the partition sums to total wall-clock exactly by
construction. Step time spent on steps that a later resume replays is
reclassified as ``recompute`` — work that ran, burned GPUs, and was lost.

The ``aot`` event keeps the JAX package's name: there it counts AOT
program-store loads, here the hand-written kernel libraries
(``ops/cuda_build.py``'s ``build_counts``): a hit is a library loaded as it
was found built, a miss an ``nvcc`` run. A warm restart is the attempt
whose ``aot`` event shows ``misses == 0``.

Everything is stdlib-only: the supervisor (which must not pay the torch
import) uses it, and ``path=None`` makes a pure in-memory accountant.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

from .artifacts import append_jsonl, read_jsonl, wall_now as _wall_now

logger = logging.getLogger(__name__)

# ledger file name, next to supervisor_state.json in the experiment dir
GOODPUT_FILENAME = "goodput.jsonl"

# the named non-productive categories; 'other' is the explicit residual
# that makes the partition exact
BADPUT_CATEGORIES = (
    "compile_warmup",
    "data_wait",
    "checkpoint_save",
    "checkpoint_restore",
    "eval",
    "restart_downtime",
    "recompute",
    "other",
)


def append_event(path, ev: str, **fields) -> None:
    """One-shot ledger append (the supervisor's attempt boundaries)."""
    record = {"ev": ev, "t": _wall_now()}
    record.update(fields)
    append_jsonl(path, record)


def read_ledger(path) -> List[dict]:
    return read_jsonl(path)


def summarize_events(events: List[dict], *, now: Optional[float] = None) -> dict:
    """Partition the ledger's wall-clock span into productive + badput.

    Pure function of the event list (exactness-tested): total wall-clock is
    ``(now or last event stamp) - first event stamp``; ``productive_s`` +
    every ``badput_s`` category sums to it exactly (``other`` is the
    residual, clamped at zero when double-counted durations overlap).
    A ``run_start`` at step R reclassifies previously recorded productive
    time on steps >= R as ``recompute`` (pro-rated within step windows).
    """
    badput: Dict[str, float] = {c: 0.0 for c in BADPUT_CATEGORIES}
    summary = {
        "total_wall_s": 0.0,
        "productive_s": 0.0,
        "goodput_ratio": None,
        "badput_s": badput,
        # async-checkpoint persist time: runs CONCURRENTLY with training
        # (the whole point of --async_checkpoint), so it is reported as
        # its own field and deliberately EXCLUDED from the badput
        # partition — counting it there would double-book wall-clock the
        # productive steps already own. checkpoint_save badput is the
        # BLOCKING (critical-path) share only.
        "checkpoint_overlapped_s": 0.0,
        "steps": 0,
        "recomputed_steps": 0,
        "attempts": 0,
        # elastic transitions: hosts the pod lost over the run's lifetime
        # (events carry no duration — the downtime they cause is already
        # partitioned into restart_downtime/recompute; this is the COUNT
        # the run report names the cause with)
        "hosts_lost": 0,
        # kernel-library outcomes (ops/cuda_build.py): hits are libraries
        # loaded as found built, misses nvcc runs — a warm restart shows
        # aot_misses == 0. Counts only; their wall-clock already lives
        # inside compile_warmup, so the partition stays exact.
        "aot_hits": 0,
        "aot_misses": 0,
        "events": len(events),
    }
    stamped = [e for e in events if isinstance(e.get("t"), (int, float))]
    if not stamped:
        return summary
    ordered = sorted(stamped, key=lambda e: e["t"])
    t0 = ordered[0]["t"]
    t1 = now if now is not None else ordered[-1]["t"]

    windows: List[dict] = []   # live copies: productive_s shrinks on resume
    last_attempt_end: Optional[float] = None
    for e in ordered:
        ev = e.get("ev")
        if ev == "attempt_start":
            summary["attempts"] += 1
            if last_attempt_end is not None:
                badput["restart_downtime"] += max(
                    0.0, e["t"] - last_attempt_end
                )
                last_attempt_end = None
        elif ev == "attempt_end":
            last_attempt_end = e["t"]
        elif ev == "run_start":
            resume = e.get("step")
            if resume is None:
                continue
            for w in windows:
                if w["last_step"] < resume or w["steps"] <= 0:
                    continue
                lost = w["last_step"] - max(w["first_step"], resume) + 1
                moved = w["productive_s"] * lost / w["steps"]
                w["productive_s"] -= moved
                # SHRINK the window to its surviving range: a crash loop
                # resuming at the same step repeatedly must reclassify
                # each window's replayed tail ONCE, not pro-rate the
                # already-moved share again on every restart
                w["last_step"] = resume - 1
                w["steps"] -= lost
                badput["recompute"] += moved
                summary["recomputed_steps"] += lost
        elif ev == "steps":
            w = {
                "first_step": int(e.get("first_step", 0)),
                "last_step": int(e.get("last_step", 0)),
                "steps": int(e.get("steps", 0)),
                "productive_s": float(e.get("productive_s", 0.0)),
            }
            windows.append(w)
            summary["steps"] += w["steps"]
            badput["data_wait"] += float(e.get("data_wait_s", 0.0))
            badput["compile_warmup"] += float(e.get("compile_s", 0.0))
        elif ev == "checkpoint":
            if e.get("overlapped"):
                summary["checkpoint_overlapped_s"] += float(
                    e.get("seconds", 0.0)
                )
                continue
            kind = "restore" if e.get("kind") == "restore" else "save"
            badput[f"checkpoint_{kind}"] += float(e.get("seconds", 0.0))
        elif ev == "eval":
            badput["eval"] += float(e.get("seconds", 0.0))
        elif ev == "host_lost":
            summary["hosts_lost"] += 1
        elif ev == "aot":
            summary["aot_hits"] += int(e.get("hits", 0))
            summary["aot_misses"] += int(e.get("misses", 0))

    total = max(0.0, t1 - t0)
    productive = sum(w["productive_s"] for w in windows)
    accounted = productive + sum(
        badput[c] for c in BADPUT_CATEGORIES if c != "other"
    )
    badput["other"] = max(0.0, total - accounted)
    summary["total_wall_s"] = total
    summary["productive_s"] = productive
    if total > 0:
        summary["goodput_ratio"] = productive / total
    return summary


class GoodputLedger:
    """Writer + live accountant for one training attempt.

    ``path=None`` keeps everything in memory (an in-memory accountant); with
    a path, construction reads the events PRIOR attempts left behind, so a
    resumed run's ``/metrics`` gauges and run-end summary carry the whole
    run's accounting — restart downtime and recompute loss included.

    Per-step feeds aggregate into bounded ``steps`` windows (one ledger
    line per ``flush_every`` steps, not per step) flushed durably as they
    close, so a hard kill loses at most one window of accounting.
    """

    def __init__(self, path=None, *, process_index: int = 0,
                 flush_every: int = 32):
        self.path = os.fspath(path) if path else None
        self.process_index = int(process_index)
        self.flush_every = max(1, int(flush_every))
        self._base: List[dict] = read_jsonl(self.path) if self.path else []
        self._own: List[dict] = []
        self._win: Optional[dict] = None
        self._lock = threading.Lock()

    # -- event emission --------------------------------------------------------

    def _emit(self, record: dict) -> None:
        record.setdefault("t", _wall_now())
        record.setdefault("process", self.process_index)
        self._own.append(record)
        if self.path is None:
            return
        try:
            append_jsonl(self.path, record)
        except OSError as e:
            # accounting degrades; training never does
            logger.warning(
                f"GOODPUT: could not append to {self.path}: {e}"
            )

    def _flush_window_locked(self) -> None:
        if self._win is None:
            return
        win, self._win = self._win, None
        win["ev"] = "steps"
        self._emit(win)

    # -- feeds (telemetry + CLI) -----------------------------------------------

    def note_run_start(self, step: int) -> None:
        """``step`` is the FIRST step id this attempt will execute (the
        trainer's restored ``global_step``): any previously ledgered work
        on steps >= it is about to be recomputed."""
        with self._lock:
            self._emit({
                "ev": "run_start", "step": int(step),
                "process": self.process_index, "pid": os.getpid(),
            })

    def note_step(self, step: int, *, wall_s: float,
                  data_wait_s: float = 0.0, compile: bool = False,
                  aot_hit: Optional[bool] = None) -> None:
        """One consumed step's on-wall time. ``compile=True`` (the first
        observed step) books the whole non-wait share as compile/warmup
        badput instead of productive time; ``aot_hit`` (only meaningful
        on that step) stamps whether every kernel library of the warmup
        was loaded as found built rather than compiled by ``nvcc``."""
        with self._lock:
            wait = min(max(0.0, float(data_wait_s)), max(0.0, float(wall_s)))
            productive = max(0.0, float(wall_s) - wait)
            w = self._win
            if w is None:
                w = self._win = {
                    "first_step": int(step), "last_step": int(step),
                    "steps": 0, "productive_s": 0.0, "data_wait_s": 0.0,
                    "compile_s": 0.0,
                }
            w["last_step"] = int(step)
            w["steps"] += 1
            w["data_wait_s"] += wait
            if compile:
                w["compile_s"] += productive
                if aot_hit is not None:
                    w["aot_hit"] = bool(aot_hit)
            else:
                w["productive_s"] += productive
            if w["steps"] >= self.flush_every:
                self._flush_window_locked()

    def note_checkpoint(self, kind: str, seconds: float, *,
                        overlapped: bool = False) -> None:
        """``overlapped=True`` books the time as an async save's
        background persist: reported in the summary's
        ``checkpoint_overlapped_s``, NOT as badput (it ran under
        productive step time — that concurrency is the async-checkpoint
        win the split exists to make visible)."""
        with self._lock:
            record = {
                "ev": "checkpoint", "kind": str(kind),
                "seconds": float(seconds),
            }
            if overlapped:
                record["overlapped"] = True
            self._emit(record)

    def note_eval(self, seconds: float) -> None:
        with self._lock:
            self._emit({"ev": "eval", "seconds": float(seconds)})

    def note_aot(self, hits: int, misses: int, load_s: float = 0.0) -> None:
        """This attempt's kernel-library tally (run end,
        ``ops/cuda_build.build_counts``): ``hits`` libraries loaded as
        found built, ``misses`` ``nvcc`` builds, and ``load_s`` the time
        spent on them when measured (0 otherwise). A zero-compile warm
        restart is the attempt whose ``aot`` event shows ``misses ==
        0``."""
        with self._lock:
            self._emit({
                "ev": "aot", "hits": int(hits), "misses": int(misses),
                "load_s": float(load_s),
            })

    def note_run_end(self, step: int) -> None:
        with self._lock:
            self._flush_window_locked()
            self._emit({"ev": "run_end", "step": int(step)})

    def flush(self) -> None:
        with self._lock:
            self._flush_window_locked()

    # -- accounting ------------------------------------------------------------

    def events(self) -> List[dict]:
        """Prior attempts' events + this attempt's, with the open step
        window materialized (not flushed) so live reads see current work."""
        with self._lock:
            out = list(self._base) + list(self._own)
            if self._win is not None and self._win["steps"] > 0:
                live = dict(self._win)
                live["ev"] = "steps"
                live["t"] = _wall_now()
                out.append(live)
        return out

    def summary(self, *, now: Optional[float] = None) -> dict:
        """Whole-run accounting as of now (live gauge / run-end report)."""
        return summarize_events(
            self.events(), now=now if now is not None else _wall_now()
        )

    def summary_message(self) -> str:
        """One human line for the run-end log."""
        s = self.summary()
        ratio = s["goodput_ratio"]
        parts = ", ".join(
            f"{k}={v:.1f}s" for k, v in s["badput_s"].items() if v > 0.005
        )
        overlapped = (
            f" ({s['checkpoint_overlapped_s']:.1f}s checkpoint persist "
            f"overlapped under training)"
            if s.get("checkpoint_overlapped_s", 0.0) > 0.005 else ""
        )
        return (
            f"GOODPUT: ratio "
            f"{ratio if ratio is None else format(ratio, '.3f')} — "
            f"{s['productive_s']:.1f}s productive of {s['total_wall_s']:.1f}s "
            f"wall over {s['attempts'] or 1} attempt(s), "
            f"{s['recomputed_steps']} recomputed step(s)"
            + (f", {s['hosts_lost']} host(s) lost" if s.get("hosts_lost") else "")
            + f"; badput: {parts or 'none'}.{overlapped}"
        )
