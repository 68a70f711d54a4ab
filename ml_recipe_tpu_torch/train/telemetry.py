"""Training-plane telemetry: the trainer's /metrics surface (the port of
``ml_recipe_tpu/train/telemetry.py``: the same series, buckets and feeds).

:class:`TrainTelemetry` gives training what serving has: a registry of training
metrics (served by ``metrics.exporter.MetricsExporter`` from
``--metrics_port``) fed per consumed step by the trainer with a wall-time
breakdown —

- ``data_wait``: blocked on the loader / prefetch queue,
- ``host``: collate + micro split + host→device placement,
- ``device``: step launch + device execution (the trainer synchronizes
  CUDA before it reads the clock, so asynchronous launches cannot fake
  it),

plus tokens/sec, padding waste, loss-scale adjustments, checkpoint
save/restore durations, the first step's kernel-library loads (the
``train_aot_*`` series keep the JAX package's names; here they count
``ops/cuda_build.py``'s library loads and ``nvcc`` builds), and — at
scrape time — the watchdog heartbeat age
and the supervisor's restart/exit-classification counts read cross-process
from its JSON sidecar (``resilience.supervisor.peek_supervisor_state``).

Everything here is opt-in and host-side-only: with no telemetry attached
the trainer's step loop is bit-identical to the untelemetered path, and
with it attached only timing/blocking changes — never batch contents,
order, or arithmetic.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

from ..metrics.anomaly import AnomalyReport, SlowStepDetector
from ..metrics.registry import Registry

logger = logging.getLogger(__name__)

# step-scale histogram bounds: 5 ms .. 120 s (a pod-scale step with a
# checkpoint barrier in the tail is seconds, not the serving plane's ms)
STEP_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    120.0,
)

# checkpoint I/O is far slower than a step: 50 ms .. 10 min
CKPT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0, 600.0)


class TrainTelemetry:
    """Registry + per-step accounting + slow-step anomaly detection."""

    def __init__(
        self,
        *,
        registry: Optional[Registry] = None,
        process_index: int = 0,
        process_count: int = 1,
        anomaly_factor: float = 3.0,
        anomaly_window: int = 64,
        anomaly_min_steps: int = 8,
        watchdog=None,
        supervisor_state_path=None,
        goodput=None,
        flightrec=None,
    ):
        self.registry = registry if registry is not None else Registry()
        self.watchdog = watchdog
        self.supervisor_state_path = (
            str(supervisor_state_path) if supervisor_state_path else None
        )
        # run-level accounting plane, both optional and host-only:
        # goodput is a metrics.goodput.GoodputLedger (productive-vs-badput
        # wall-clock partition, exported as train_goodput_ratio), flightrec
        # a metrics.flightrec.FlightRecorder (last-N-events crash timeline)
        self.goodput = goodput
        self.flightrec = flightrec
        self._observed_steps = 0
        self._aot_hits = 0
        self._aot_misses = 0
        self.detector = SlowStepDetector(
            factor=anomaly_factor,
            window=anomaly_window,
            min_steps=anomaly_min_steps,
        )
        self._last_loss_scale: Optional[float] = None

        m = self.registry
        self.m_steps = m.counter(
            "train_steps_total", "Consumed optimizer steps this process.")
        self.m_global_step = m.gauge(
            "train_global_step", "Current global optimizer step.")
        self.m_step = m.histogram(
            "train_step_seconds",
            "Per-step wall time: data wait + host + device (host excluded "
            "when the prefetch thread overlaps it with device compute).",
            STEP_BUCKETS)
        self.m_data_wait = m.histogram(
            "train_step_data_wait_seconds",
            "Per-step time blocked on the loader / prefetch queue.",
            STEP_BUCKETS)
        self.m_host = m.histogram(
            "train_step_host_seconds",
            "Per-step collate + micro split + host-to-device placement time.",
            STEP_BUCKETS)
        self.m_device = m.histogram(
            "train_step_device_seconds",
            "Per-step launch + device execution time (CUDA synchronized).",
            STEP_BUCKETS)
        self.m_tokens_per_sec = m.gauge(
            "train_tokens_per_sec",
            "Real (non-pad) input tokens per second, last consumed step.")
        self.m_examples_per_sec = m.gauge(
            "train_examples_per_sec",
            "Examples (rows / packed segments) per second, last step.")
        self.m_padding_waste = m.gauge(
            "train_padding_waste_pct",
            "Share of step input tokens that are padding, last step (%).")
        self.m_loss = m.gauge(
            "train_loss", "Running mean training loss (epoch meter).")
        self.m_lr = m.gauge(
            "train_lr", "Learning rate at the last consumed step.")
        self.m_loss_scale = m.gauge(
            "train_loss_scale",
            "Current loss scale (0 when loss scaling is off).")
        self.m_loss_scale_adjustments = m.counter(
            "train_loss_scale_adjustments_total",
            "Dynamic loss-scale changes (growth or overflow backoff).")
        self.m_slow_steps = m.counter(
            "train_slow_steps_total",
            "Steps flagged anomalous by the rolling median+MAD detector.")
        self.m_ckpt_save = m.histogram(
            "train_checkpoint_save_seconds",
            "Checkpoint save durations on the step critical path (sync "
            "saves: full serialize+write; async saves: the blocking "
            "device-to-host snapshot only).", CKPT_BUCKETS)
        self.m_ckpt_persist = m.histogram(
            "train_checkpoint_persist_seconds",
            "Background persist durations of async checkpoint saves "
            "(serialize+write overlapped with training — off the step "
            "critical path).", CKPT_BUCKETS)
        self.m_ckpt_restore = m.histogram(
            "train_checkpoint_restore_seconds",
            "Checkpoint restore durations.", CKPT_BUCKETS)
        self.m_zero1_buckets = m.gauge(
            "train_zero1_buckets",
            "Gradient buckets in the bucketed ZeRO-1 collective-overlap "
            "plan (0 = monolithic exchange / overlap off).")
        self.m_aot_hits = m.counter(
            "train_aot_cache_hits_total",
            "Kernel libraries loaded as found built, no nvcc run "
            "(ops/cuda_build.py: zero-compile warm restarts).")
        self.m_aot_misses = m.counter(
            "train_aot_cache_misses_total",
            "Kernel libraries built by nvcc (and kept in csrc/build/ "
            "for the next restart).")
        self.m_aot_load = m.histogram(
            "train_aot_load_seconds",
            "Kernel library load times on hits (when measured).",
            STEP_BUCKETS)
        self.m_heartbeat_age = m.gauge(
            "train_watchdog_heartbeat_age_seconds",
            "Seconds since the step watchdog last saw progress "
            "(-1: no watchdog armed).")
        self.m_sup_restarts = m.gauge(
            "train_supervisor_restarts",
            "Supervisor restart budget consumed (no-progress failures), "
            "from the supervisor JSON sidecar (-1: no sidecar).")
        self.m_sup_attempts = m.gauge(
            "train_supervisor_attempts",
            "Supervisor attempts launched so far (-1: no sidecar).")
        self.m_sup_preempted = m.gauge(
            "train_supervisor_exits_preempted",
            "Child exits the supervisor classified as preemptions.")
        self.m_sup_hang = m.gauge(
            "train_supervisor_exits_hang",
            "Child exits the supervisor classified as hangs "
            "(watchdog aborts).")
        self.m_sup_crash = m.gauge(
            "train_supervisor_exits_crash",
            "Child exits the supervisor classified as crashes.")
        self.m_goodput = m.gauge(
            "train_goodput_ratio",
            "Productive step time / total run wall-clock, from the goodput "
            "ledger (-1: no ledger attached).")
        self.m_badput = m.labeled_gauge(
            "train_badput_seconds_total",
            "Non-productive run wall-clock by category, from the goodput "
            "ledger (compile_warmup / data_wait / checkpoint_save / "
            "checkpoint_restore / eval / restart_downtime / recompute / "
            "other).",
            "category")
        self.m_process = m.info(
            "train_process_info",
            "Identity of this training process on the mesh.",
            {
                "process_index": str(process_index),
                "process_count": str(process_count),
            },
        )
        self.m_heartbeat_age.set(-1.0)
        self.m_sup_restarts.set(-1.0)
        self.m_sup_attempts.set(-1.0)
        self.m_goodput.set(-1.0)

    # -- per-step feed (train loop) --------------------------------------------

    def observe_step(
        self,
        step: int,
        *,
        data_wait_s: float,
        host_s: float,
        device_s: float,
        examples: int = 0,
        real_tokens: int = 0,
        total_tokens: int = 0,
        host_overlapped: bool = False,
    ) -> Optional[AnomalyReport]:
        """Feed one consumed step's breakdown; total step time is defined
        as the sum of the components on the critical path (pinned by the
        accounting test). ``host_overlapped=True`` (the device-prefetch
        path) excludes ``host_s`` from the total and the detector
        baseline: placement ran on the prefetch thread UNDER the previous
        step's device time, so counting it would overstate the step wall
        — a prefetch thread that falls behind surfaces as data wait. The
        host histogram itself still records every placement. Returns the
        anomaly report when the detector fired (already logged and counted
        here)."""
        total = data_wait_s + device_s
        breakdown = {"data_wait": data_wait_s, "device": device_s}
        if not host_overlapped:
            total += host_s
            breakdown["host"] = host_s
        self.m_steps.inc()
        self.m_global_step.set(step)
        self.m_step.observe(total)
        self.m_data_wait.observe(data_wait_s)
        self.m_host.observe(host_s)
        self.m_device.observe(device_s)
        if total > 0:
            if real_tokens:
                self.m_tokens_per_sec.set(real_tokens / total)
            if examples:
                self.m_examples_per_sec.set(examples / total)
        if total_tokens:
            self.m_padding_waste.set(
                100.0 * (1.0 - real_tokens / total_tokens))

        # goodput ledger: the first observed step carries compilation —
        # its non-wait share is compile/warmup badput, not productive time.
        # The aot_hit flag says whether that warmup only LOADED kernel
        # libraries (every observed decision a hit) or ran nvcc
        first = self._observed_steps == 0
        self._observed_steps += 1
        if self.goodput is not None:
            aot_hit = None
            if first and (self._aot_hits or self._aot_misses):
                aot_hit = self._aot_misses == 0
            self.goodput.note_step(
                step, wall_s=total, data_wait_s=data_wait_s, compile=first,
                aot_hit=aot_hit,
            )

        report = self.detector.update(step, total, breakdown)
        if report is not None:
            self.m_slow_steps.inc()
            logger.warning(report.message())

        if self.flightrec is not None:
            heartbeat = (
                self.watchdog.heartbeat_age()
                if self.watchdog is not None else None
            )
            self.flightrec.record(
                "step", step=int(step), total_s=round(total, 6),
                data_wait_s=round(data_wait_s, 6),
                host_s=round(host_s, 6), device_s=round(device_s, 6),
                examples=int(examples),
                heartbeat_age_s=(
                    round(heartbeat, 3) if heartbeat is not None else None
                ),
            )
            if report is not None:
                # the anomaly verdict rides the ring too: attribution must
                # survive the crash that often follows a stall
                self.flightrec.record(
                    "slow_step", step=report.step,
                    total_s=round(report.total_s, 6),
                    threshold_s=round(report.threshold_s, 6),
                    attribution=report.attribution,
                    component_s=round(report.component_s, 6),
                )
        return report

    def observe_aot(self, outcome: str, seconds: float) -> None:
        """One kernel library's load, as the trainer sees it around its
        first step (``ops/cuda_build.build_counts``): ``'hit'`` = loaded as
        found built (the load-time histogram records ``seconds``),
        ``'miss'`` = built by ``nvcc``. On the CPU no library loads, and
        nothing reaches here."""
        if outcome == "hit":
            self._aot_hits += 1
            self.m_aot_hits.inc()
            self.m_aot_load.observe(seconds)
        elif outcome == "miss":
            self._aot_misses += 1
            self.m_aot_misses.inc()
        if self.flightrec is not None:
            self.flightrec.record(
                "aot", outcome=outcome, seconds=round(seconds, 6))

    def observe_scalars(self, host_values: Dict[str, float]) -> None:
        """Per-consumed-step scalar taps from the train step's host fetch
        (loss, lr, loss scale)."""
        loss = host_values.get("loss")
        if loss is not None:
            value = float(loss)
            if math.isfinite(value):
                self.m_loss.set(value)
        lr = host_values.get("lr")
        if lr is not None:
            self.m_lr.set(float(lr))
        scale = host_values.get("loss_scale")
        if scale is not None:
            value = float(scale)
            self.m_loss_scale.set(value)
            if (
                self._last_loss_scale is not None
                and value != self._last_loss_scale
            ):
                self.m_loss_scale_adjustments.inc()
                if self.flightrec is not None:
                    self.flightrec.record(
                        "loss_scale", scale=value,
                        previous=self._last_loss_scale,
                    )
            self._last_loss_scale = value

    # -- checkpoint + scrape-time feeds ----------------------------------------

    def observe_checkpoint_save(self, seconds: float) -> None:
        self.m_ckpt_save.observe(seconds)
        if self.goodput is not None:
            self.goodput.note_checkpoint("save", seconds)
        if self.flightrec is not None:
            self.flightrec.record(
                "checkpoint_save", seconds=round(seconds, 6))

    def observe_checkpoint_snapshot(self, seconds: float) -> None:
        """Blocking leg of an ASYNC save (device->host snapshot + the
        wait for any previous persist): this IS the save's critical-path
        cost, so it feeds the same save histogram and checkpoint_save
        badput the sync path does — the async win shows up as this number
        shrinking while the persist time moves to the overlapped feed."""
        self.m_ckpt_save.observe(seconds)
        if self.goodput is not None:
            self.goodput.note_checkpoint("save", seconds)
        if self.flightrec is not None:
            self.flightrec.record(
                "ckpt_snapshot", seconds=round(seconds, 6))

    def observe_checkpoint_persist(self, seconds: float,
                                   stalled_s: float = 0.0) -> None:
        """Background leg of an async save (serialize + write, called
        from the persist thread on completion). Only the share that ran
        while training proceeded is ledgered as checkpoint_overlapped_s:
        ``stalled_s`` — time the main thread spent blocked waiting on
        this persist (the next save's barrier, a restore, exit) — is
        already on the critical path and booking it as overlap would
        overstate the async win by exactly the stall."""
        self.m_ckpt_persist.observe(seconds)
        if self.goodput is not None:
            self.goodput.note_checkpoint(
                "save", max(0.0, seconds - stalled_s), overlapped=True
            )
        if self.flightrec is not None:
            self.flightrec.record(
                "ckpt_persist", seconds=round(seconds, 6),
                stalled_s=round(stalled_s, 6))

    def observe_zero1_buckets(self, buckets) -> None:
        """Record the bucketed ZeRO-1 overlap plan (a list of
        ``GradBucket``): the bucket count rides /metrics and the per-
        bucket byte layout lands in the flight recorder, so a post-mortem
        can attribute a collective stall to its bucket."""
        buckets = list(buckets or [])
        self.m_zero1_buckets.set(float(len(buckets)))
        if self.flightrec is not None and buckets:
            self.flightrec.record(
                "zero1_bucket_plan",
                buckets=len(buckets),
                leaf_ranges=[[int(b.lo), int(b.hi)] for b in buckets],
                bucket_bytes=[int(b.nbytes) for b in buckets],
            )

    def observe_checkpoint_restore(self, seconds: float) -> None:
        self.m_ckpt_restore.observe(seconds)
        if self.goodput is not None:
            self.goodput.note_checkpoint("restore", seconds)
        if self.flightrec is not None:
            self.flightrec.record(
                "checkpoint_restore", seconds=round(seconds, 6))

    def observe_eval(self, seconds: float) -> None:
        """One eval epoch's wall time — badput under the goodput
        discipline (chips busy, no training progress)."""
        if self.goodput is not None:
            self.goodput.note_eval(seconds)
        if self.flightrec is not None:
            self.flightrec.record("eval", seconds=round(seconds, 6))

    def refresh(self) -> None:
        """Scrape-time gauges: watchdog heartbeat age, goodput accounting
        + supervisor sidecar (registered as the exporter's pre-render
        hook)."""
        age = None
        if self.watchdog is not None:
            age = self.watchdog.heartbeat_age()
        self.m_heartbeat_age.set(age if age is not None else -1.0)

        if self.goodput is not None:
            summary = self.goodput.summary()
            ratio = summary["goodput_ratio"]
            self.m_goodput.set(ratio if ratio is not None else -1.0)
            for category, seconds in summary["badput_s"].items():
                self.m_badput.set(category, seconds)

        if self.supervisor_state_path is None:
            return
        from ..resilience.supervisor import peek_supervisor_state

        state = peek_supervisor_state(self.supervisor_state_path)
        if state is None:
            return
        self.m_sup_restarts.set(float(state.get("restarts_used", 0)))
        self.m_sup_attempts.set(float(state.get("attempts", 0)))
        outcomes = state.get("outcomes", [])
        self.m_sup_preempted.set(float(outcomes.count("preempted")))
        self.m_sup_hang.set(float(outcomes.count("hang")))
        self.m_sup_crash.set(float(outcomes.count("crash")))

    def health_document(self, *, global_step, process_index: int = 0) -> dict:
        """The /healthz JSON body: liveness AND productivity in one probe
        (the serving-fleet router and the supervisor read the same
        document). Goodput ratio and flight-recorder last-event age are
        None when the respective plane is not attached."""
        heartbeat = (
            self.watchdog.heartbeat_age() if self.watchdog is not None
            else None
        )
        doc = {
            "status": "ok",
            "global_step": global_step,
            "process_index": process_index,
            "watchdog_heartbeat_age_s": heartbeat,
            "goodput_ratio": None,
            "last_event_age_s": None,
        }
        if self.goodput is not None:
            doc["goodput_ratio"] = self.goodput.summary()["goodput_ratio"]
        if self.flightrec is not None:
            doc["last_event_age_s"] = self.flightrec.last_event_age()
        return doc

    # -- summary surface --------------------------------------------------------

    def breakdown_summary(self) -> dict:
        """Step-time breakdown percentiles + anomaly count, in seconds (a
        benchmark's JSON line)."""
        def q(hist, p):
            value = hist.quantile(p)
            return round(value, 6) if value is not None else None

        return {
            "step_p50_s": q(self.m_step, 0.5),
            "step_p95_s": q(self.m_step, 0.95),
            "data_wait_p50_s": q(self.m_data_wait, 0.5),
            "data_wait_p95_s": q(self.m_data_wait, 0.95),
            "host_p50_s": q(self.m_host, 0.5),
            "host_p95_s": q(self.m_host, 0.95),
            "device_p50_s": q(self.m_device, 0.5),
            "device_p95_s": q(self.m_device, 0.95),
            "slow_step_anomalies": self.detector.anomalies,
        }
