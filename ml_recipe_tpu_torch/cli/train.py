"""Training entry point (the port of ``ml_recipe_tpu/cli/train.py``).

Usage::

    python -m ml_recipe_tpu_torch.cli.train -c config/test_bert.cfg \\
        --vocab_file V --dump_dir D [--device cpu --model bert-tiny ...]

Data parallelism over W processes, one command per rank r (the JAX
package's contract, which ``scripts/worker.sh`` maps from the launcher's
environment)::

    python -m ml_recipe_tpu_torch.cli.train -c config/test_bert.cfg ... \\
        --dist_world_size W --local_rank r --dist_init_method tcp://HOST:PORT

Parses the trainer and model flags (the JAX package's names and defaults,
plus ``--device``), refuses the flags of subsystems the port lacks
(``check_train_flags``), writes ``trainer.cfg``/``model.cfg`` into the
experiment directory, builds model, datasets, loss and ``Trainer``, and runs
``trainer.train(after_epoch_funcs=[save_last, save_each, test_fun])``.
Without ``--dummy_dataset`` the datasets come from the NQ corpus at
``--data_path``, preprocessed into ``--processed_data_path`` (cleared
first with ``--clear_processed``).
``KeyboardInterrupt`` or ``SIGTERM`` saves ``interrupt.ch``. With
``--async_checkpoint`` the run waits for the last background write before
it returns (and, after an interrupt, for ``interrupt.ch``'s), so a
checkpoint is on disk when the process ends; ``--hf_checkpoint DIR`` warm
starts the encoder from a local HF directory (``compose.init_model``).
``--sequence_packing on`` trains on packed rows (``data/packing.py``;
``--pack_max_segments``, ``--pack_splitting fill``, ``--pack_min_fragment``).
``--aot_cache`` / ``--aot_cache_bytes`` place and bound the store of built
kernel libraries (``ops/aot.py``; a restart loads them instead of running
``nvcc``), ``--autotune`` / ``--autotune_cache`` configure the tuning cache,
and ``--hbm_preflight`` (on by default) measures the first step's device
memory and raises ``batch_split`` when it would not fit
(``Trainer.preflight_train_step``).

With ``--dist_world_size`` W > 1 each process joins the world before any
CUDA use (NCCL on CUDA, gloo with ``--device cpu``; ``parallel/dist.py``)
and runs on ``cuda:(r % device count)``; rank 0 alone writes the log file,
``trainer.cfg``/``model.cfg``, the TensorBoard events and the single-file
checkpoints, and prepares the dataset while the others wait. The step and
its semantics are the trainer's (``train/trainer.py``).

``--mesh data:D,seq:S`` lays the ``D*S`` ranks out on the JAX package's
axes (``parallel/mesh.py``; the default is ``data:W``): with S > 1 the
model runs ring attention over each ``seq`` group (``--flash_attention
auto`` resolves to ``ring``). ``--optimizer_sharding zero1`` (or
``--shard_optimizer``) shards the optimizer state over ``data`` when D >
1. ``config/longdoc.cfg`` (``mesh=data:1,seq:2``) runs as two ranks::

    python -m ml_recipe_tpu_torch.cli.train -c config/longdoc.cfg ... \
        --dist_world_size 2 --local_rank r --dist_init_method tcp://HOST:PORT

``--mesh model:T`` (or ``data:D,model:T``, ``D*T`` ranks) runs the
encoder tensor-parallel: each rank of a ``model`` group holds ``1/T`` of
every layer's heads and MLP columns and the group shares its rows and its
data seed (``train/trainer.py``)::

    python -m ml_recipe_tpu_torch.cli.train -c config/test_bert.cfg ... \
        --mesh model:2 --dist_world_size 2 --local_rank r \
        --dist_init_method tcp://HOST:PORT

``--mesh pipe:K,model:T`` (or ``data:D,pipe:K,model:T``, ``D*K*T``
ranks) runs K pipeline stages (``--pipe_schedule gpipe|1f1b``,
``--pipe_param_sharding stage|replicated``), each stage's layers split
over its own ``model`` group::

    python -m ml_recipe_tpu_torch.cli.train -c config/test_bert.cfg ... \
        --mesh pipe:2,model:2 --dist_world_size 4 --local_rank r \
        --dist_init_method tcp://HOST:PORT

The runtime subsystems, all off by default (the JAX CLI's flags):

- ``--watchdog_timeout S`` arms the step watchdog before the world is
  joined (a hung rendezvous is caught too): a missed deadline dumps every
  thread's stack and exits 87;
- ``--trace_spans DIR`` writes the host spans to
  ``DIR/train_trace_p<rank>.json``; ``--trace`` captures steps 2-4 of
  epoch 1 (from step 0 in debug runs) with ``torch.profiler`` into
  ``<dump_dir>/board/<experiment>/trace``; on CUDA a capture without CUDA
  activity is taken again over the next steps, and the run fails when
  every capture came back empty;
- ``--metrics_port P`` serves the training telemetry at ``/metrics`` and
  ``/healthz`` on ``P + rank`` (0: an ephemeral port), and with
  ``--metrics_hosts h:p,...`` rank 0 serves the merged pod page at
  ``/metrics/pod``;
- ``--goodput_ledger`` keeps ``goodput.jsonl`` and ``--flight_recorder``
  the ``flightrec_*.json`` dumps in the experiment directory;
- ``--fault_plan SPEC`` (or ``$MLRT_FAULTS``) arms the drills of
  ``resilience/faults.py``;
- ``--supervise`` makes this process the supervisor
  (``resilience/supervisor.py``): each attempt is a child running this CLI
  without the flag, with ``MLRT_SUPERVISED=1``, resumed from the newest of
  ``interrupt.ch`` / ``last.ch``. A supervised child that catches SIGTERM
  dumps the recorder, flushes the ledger, saves ``interrupt.ch`` and exits
  75 (a preemption, to resume). A SIGTERM inside a step takes effect when
  the step ends, so ``interrupt.ch`` never holds half a step;
- ``--supervise --elastic on`` runs one supervisor per host (``--local_rank``
  is the host, ``--dist_world_size`` the hosts), coordinated through
  ``<exp_dir>/pod/`` (``--host_timeout``, ``--coord_poll``,
  ``--min_world``): after a host dies its peers restart on the live world
  (``MLRT_ELASTIC_WORLD``), where the mesh's ``data`` axis narrows
  (``ParallelPlan.elastic_from_spec``, the "ELASTIC RESUME" warning and
  the recorder's ``mesh_shrunk`` event), and resume from the last
  checkpoint. A supervised elastic child with a watchdog writes its step
  to ``pod/child-<host>.json`` on the watchdog's beat.

``--optimizer_sharding zero1 --zero1_overlap bucketed`` exchanges the
gradients in ``--zero1_bucket_mb`` buckets, each reduce-scattered as the
last micro-batch's backward completes it (``train/trainer.py``).
"""

from __future__ import annotations

import functools
import logging
import os
import signal
import sys
import threading
from datetime import datetime

import numpy as np
import torch
import torch.distributed

from ..compose import (
    init_collate_fun,
    init_loss,
    init_model,
    init_shared_datasets,
)
from ..config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
    write_config_file,
)
from ..data.labels import labels2id
from ..metrics import trace as trace_mod
from ..ops import cuda_build
from ..parallel import dist as pdist
from ..parallel.plan import ParallelPlan
from ..resilience import faults
from ..resilience import watchdog as watchdog_mod
from ..resilience.supervisor import PREEMPT_EXIT_CODE, SUPERVISED_ENV
from ..train.callback import AccuracyCallback, MAPCallback, SaveBestCallback
from ..train.trainer import Trainer
from ..utils.device import resolve_device
from ..utils.logging import show_params
from ..utils.seed import set_seed

logger = logging.getLogger(__name__)


def optimizer_sharding(params) -> str:
    """``--optimizer_sharding`` when given, else ``zero1`` under the legacy
    ``--shard_optimizer`` (the JAX package's ``parse_optimizer_sharding``)."""
    if params.optimizer_sharding is not None:
        return params.optimizer_sharding
    return "zero1" if params.shard_optimizer else "off"


def shared_random_seed() -> int:
    """A fresh random seed drawn by rank 0 and broadcast to every rank."""
    seed = torch.randint(0, 1 << 62, (1,), dtype=torch.int64)
    if pdist.process_count() > 1:
        torch.distributed.broadcast(seed, src=0)
    return int(seed)


def build_plan(params) -> ParallelPlan:
    """The parallelism plan of ``--mesh`` over the joined world; under
    ``--elastic on`` its data axis narrows to the live processes, with the
    "ELASTIC RESUME" warning when it did."""
    if params.elastic != "on":
        return ParallelPlan.from_spec(params.mesh)
    plan = ParallelPlan.elastic_from_spec(params.mesh)
    if plan.shrunk:
        logger.warning("ELASTIC RESUME: mesh re-derived for the live device "
                       "set: requested %s -> running %s.",
                       plan.requested_axes, plan.describe())
    return plan


def build_trainer(params, model_params, *, watchdog=None,
                  telemetry=None) -> Trainer:
    """Model, datasets, loss and ``Trainer`` from the parsed flags, resumed
    from ``--last`` when given; in a data-parallel world, on this rank's
    device. ``watchdog`` and ``telemetry`` are the runtime subsystems the
    trainer feeds (:func:`run_worker` builds them); ``--trace`` gives it
    its profiler window's directory. A shrunk elastic plan is a
    ``mesh_shrunk`` event in the telemetry's flight recorder."""
    check_train_flags(params, model_params)
    # the warm-up plane, as the JAX CLI wires it: the tuning cache and the
    # store every kernel library is built into and loaded from
    from ..ops import aot, autotune

    autotune.configure(enabled=params.autotune,
                       cache_dir=params.autotune_cache)
    aot.configure_from_flags(params)
    device = resolve_device(
        pdist.rank_device(params.device, pdist.process_index())
        if pdist.process_count() > 1 else params.device)
    plan = build_plan(params)
    mesh = plan.mesh
    flightrec = getattr(telemetry, "flightrec", None)
    if plan.shrunk and flightrec is not None:
        # this attempt runs narrower than the operator asked: the
        # crash-loop diagnosis timeline must explain it
        flightrec.record("mesh_shrunk", old=plan.requested_axes,
                         new=plan.describe())
    rng_pool = set_seed(params.seed)
    data_rng = rng_pool.host_rng("chunk_sampling") if rng_pool else None
    if data_rng is None and (mesh.seq_size > 1 or mesh.pipe_size > 1
                             or mesh.model_size > 1):
        # the ranks of a seq (pipe, model) group hold blocks (stages,
        # slices) of the same rows: without a seed their datasets still
        # draw from one shared one
        data_rng = np.random.default_rng(shared_random_seed())
    seed = params.seed if params.seed is not None else 0

    model, tokenizer = init_model(model_params, bpe_dropout=params.bpe_dropout,
                                  rng_seed=seed, device=device, train=True,
                                  mesh=mesh)
    train_dataset, test_dataset, train_weights = init_shared_datasets(
        params, tokenizer=tokenizer, clear=params.clear_processed,
        rng=data_rng)
    trainer = Trainer(
        model=model,
        loss=init_loss(params, train_weights),
        collate_fun=init_collate_fun(tokenizer, max_seq_len=params.max_seq_len),
        trainer_params=params,
        train_dataset=train_dataset,
        test_dataset=test_dataset,
        writer_dir=params.dump_dir / f"board/{params.experiment_name}",
        n_epochs=params.n_epochs,
        train_batch_size=params.train_batch_size,
        test_batch_size=params.test_batch_size,
        batch_split=params.batch_split,
        n_jobs=params.n_jobs,
        warmup_coef=params.warmup_coef,
        max_grad_norm=params.max_grad_norm,
        train_weights=train_weights,
        drop_optimizer=params.drop_optimizer,
        debug=params.debug,
        seed=seed,
        length_buckets=params.length_buckets,
        device_prefetch=params.device_prefetch,
        log_every=params.log_every,
        sharded_checkpoint=params.sharded_checkpoint,
        async_checkpoint=params.async_checkpoint,
        sequence_packing=params.sequence_packing,
        pack_max_segments=params.pack_max_segments,
        pack_splitting=params.pack_splitting,
        pack_min_fragment=params.pack_min_fragment,
        mesh=mesh,
        optimizer_sharding=optimizer_sharding(params),
        zero1_overlap=params.zero1_overlap,
        zero1_bucket_mb=params.zero1_bucket_mb,
        watchdog=watchdog,
        telemetry=telemetry,
        trace_dir=(params.dump_dir / f"board/{params.experiment_name}/trace"
                   if params.trace else None),
        hbm_preflight=params.hbm_preflight,
        pipe_schedule=params.pipe_schedule,
        pipe_param_sharding=params.pipe_param_sharding,
    )
    if params.last is not None:
        trainer.load_state_dict(params.last)
    return trainer


def _note_kernel_builds(goodput) -> None:
    """This attempt's kernel-library tally into the ledger (its ``aot``
    event: hits, misses and the hits' load seconds)."""
    counts = cuda_build.build_counts()
    goodput.note_aot(counts["hits"], counts["misses"],
                     sum(t for kind, t in cuda_build.load_events()
                         if kind == "hit"))


def train(trainer: Trainer, params, *, goodput=None,
          flightrec=None) -> Trainer:
    """``trainer.train`` with the after-epoch hooks (save_last, save_each,
    test); ``KeyboardInterrupt`` or ``SIGTERM`` saves ``interrupt.ch``
    (the recorder dumped and the ledger flushed first) and, under a
    supervisor, exits ``PREEMPT_EXIT_CODE``. Every way out passes the
    completion barrier of the async saves; a clean end closes the ledger
    and dumps the recorder."""
    exp_dir = params.dump_dir / params.experiment_name

    def save_last(*args, **kwargs):
        trainer.save_state_dict(exp_dir / "last.ch")

    def save_each(epoch_i):
        trainer.save_state_dict(exp_dir / f"epoch_{epoch_i}.ch")

    test_fun = functools.partial(trainer.test, callbacks=[
        MAPCallback(list(labels2id.keys())),
        AccuracyCallback(),
        SaveBestCallback(params),
    ])

    def _sigterm_to_interrupt(signum, frame):
        if trainer.in_step:
            # the step ends first: an interrupt.ch never holds half a step
            trainer.interrupt_pending = True
            return
        raise KeyboardInterrupt(f"signal {signum}")

    def close_ledger():
        if goodput is not None:
            _note_kernel_builds(goodput)
            goodput.note_run_end(trainer.global_step)
            logger.warning(goodput.summary_message())

    on_main_thread = threading.current_thread() is threading.main_thread()
    if on_main_thread:
        prev_handler = signal.signal(signal.SIGTERM, _sigterm_to_interrupt)
    try:
        trainer.train(after_epoch_funcs=[save_last, save_each, test_fun])
    except KeyboardInterrupt:
        # disarm first: a second SIGTERM must not abort the save below
        if on_main_thread:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        logger.error("Training process was interrupted.")
        # before the (fallible) emergency save: the timeline into the
        # preemption and the open step window's accounting must survive
        if flightrec is not None:
            flightrec.dump("sigterm", step=trainer.global_step)
        if goodput is not None:
            goodput.flush()
        # an earlier write's failure (already logged) must not abort the
        # emergency checkpoint
        trainer.finish_pending_checkpoint(raise_errors=False)
        trainer.save_state_dict(exp_dir / "interrupt.ch")
        # durable before the process ends and a resume reads it
        trainer.finish_pending_checkpoint()
        close_ledger()
        # under a supervisor a caught preemption is a reason to resume:
        # the tempfail code it classifies as 'preempted'
        if os.environ.get(SUPERVISED_ENV):
            raise SystemExit(PREEMPT_EXIT_CODE)
    except Exception as e:
        if flightrec is not None:
            flightrec.dump("exception", error=f"{type(e).__name__}: {e}")
        if goodput is not None:
            goodput.flush()   # keep the open step window's accounting
        # let an in-flight write land, without masking the error
        trainer.finish_pending_checkpoint(raise_errors=False)
        raise
    else:
        # a clean run must not end while its last checkpoint is written
        trainer.finish_pending_checkpoint()
        close_ledger()
        if flightrec is not None:
            flightrec.record("run_end", step=trainer.global_step)
            flightrec.dump("clean")
    finally:
        if on_main_thread:
            signal.signal(signal.SIGTERM, prev_handler)
        trainer.close()
    return trainer


def _arm_watchdog(params):
    """Install the process-global step watchdog from ``--watchdog_timeout``
    (or clear it when unset: a stale instance of an earlier in-process run
    must not govern the barriers). Runs before the world is joined: a
    rendezvous that never completes is the canonical startup hang."""
    timeout = params.watchdog_timeout
    return watchdog_mod.install(
        watchdog_mod.Watchdog(timeout) if timeout else None)


def run_worker(params, model_params) -> Trainer:
    """Build, then train; returns the trainer. The watchdog :func:`main`
    armed is used; a direct caller with ``--watchdog_timeout`` gets one
    armed (and torn down) here."""
    watchdog = watchdog_mod.current()
    locally_armed = False
    if watchdog is None and params.watchdog_timeout:
        watchdog = _arm_watchdog(params)
        locally_armed = True
    try:
        return _run_worker(params, model_params, watchdog)
    finally:
        if locally_armed:
            watchdog.stop()
            watchdog_mod.install(None)


def _run_worker(params, model_params, watchdog) -> Trainer:
    """The observability plane around build and train: the span tracer
    (``--trace_spans``), the goodput ledger, the flight recorder, the
    telemetry and its exporter. The tracer's install and the teardown of
    tracer and exporter bracket everything, so a failed start neither
    leaks the instrumented path into a later in-process run nor keeps the
    port open."""
    rank = pdist.process_index()
    tracer = None
    if params.trace_spans:
        tracer = trace_mod.install(trace_mod.TraceWriter(
            os.path.join(str(params.trace_spans), f"train_trace_p{rank}.json"),
            process_name="train"))
    exporter = None
    try:
        exp_dir = params.dump_dir / params.experiment_name
        if (params.elastic == "on" and os.environ.get(SUPERVISED_ENV)
                and watchdog is not None):
            # the elastic child's heartbeat on the watchdog's beat: peer
            # supervisors read this host's last step from it
            from ..resilience.coordination import (
                COORD_DIRNAME, write_child_heartbeat)

            coord_dir = os.path.join(str(exp_dir), COORD_DIRNAME)
            host = faults.current_host()
            watchdog.add_on_beat(
                lambda step: write_child_heartbeat(coord_dir, host, step=step))
        goodput = flightrec = telemetry = None
        if params.goodput_ledger:
            from ..metrics.goodput import GOODPUT_FILENAME, GoodputLedger

            # next to supervisor_state.json; it reads earlier attempts'
            # events. Rank 0 alone writes the file (every rank sees the
            # same global steps: N writers would count them N times)
            goodput = GoodputLedger(
                os.path.join(str(exp_dir), GOODPUT_FILENAME)
                if rank == 0 else None, process_index=rank)
        if params.flight_recorder:
            from ..metrics.flightrec import FlightRecorder

            flightrec = FlightRecorder.open_in(
                str(exp_dir), process_index=rank,
                capacity=params.flightrec_events)
            if watchdog is not None:
                # a hang abort dumps the timeline before the exit 87
                watchdog.add_on_timeout(
                    lambda label: flightrec.dump("watchdog", label=label))
        if (params.metrics_port is not None or goodput is not None
                or flightrec is not None):
            from ..resilience.supervisor import STATE_FILENAME
            from ..train.telemetry import TrainTelemetry

            # the telemetry is also how the ledger and the recorder get
            # their per-step feeds; the exporter needs --metrics_port
            telemetry = TrainTelemetry(
                process_index=rank, process_count=pdist.process_count(),
                anomaly_factor=params.anomaly_factor,
                anomaly_window=params.anomaly_window, watchdog=watchdog,
                # the supervisor (the parent process) keeps it current
                supervisor_state_path=os.path.join(str(exp_dir),
                                                   STATE_FILENAME),
                goodput=goodput, flightrec=flightrec)

        trainer = build_trainer(params, model_params, watchdog=watchdog,
                                telemetry=telemetry)
        if goodput is not None:
            # the first step this attempt runs: the ledger reclassifies
            # earlier work on steps >= it as recompute
            goodput.note_run_start(trainer.global_step)
        if flightrec is not None:
            flightrec.record("run_start", step=trainer.global_step)
        if telemetry is not None and params.metrics_port is not None:
            exporter = _start_exporter(params, telemetry, trainer, rank)
        return train(trainer, params, goodput=goodput, flightrec=flightrec)
    finally:
        if exporter is not None:
            exporter.close()
        if tracer is not None:
            trace_mod.install(None)
            tracer.close()   # the span file, whatever the exit


def _start_exporter(params, telemetry, trainer, rank: int):
    """``/metrics`` and ``/healthz`` on ``--metrics_port`` + rank (0 stays
    ephemeral), and on rank 0 with ``--metrics_hosts`` the pod page."""
    from ..metrics.exporter import MetricsExporter

    base = int(params.metrics_port)
    exporter = MetricsExporter(
        telemetry.registry, port=base + rank if base else 0,
        health_fn=lambda: telemetry.health_document(
            global_step=trainer.global_step, process_index=rank)).start()
    exporter.add_pre_render(telemetry.refresh)
    if params.metrics_hosts and rank == 0:
        from ..metrics.aggregator import PodAggregator

        aggregator = PodAggregator(str(params.metrics_hosts).split(","))
        exporter.add_route("/metrics/pod", aggregator.render)
        logger.info("Pod-scope aggregation over %d host exporter(s) at "
                    "/metrics/pod.", len(aggregator.targets))
    logger.info("Training metrics at http://%s:%d/metrics.", exporter.host,
                exporter.port)
    return exporter


_LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def main(argv=None) -> Trainer:
    """Parse, arm ``--fault_plan``; under ``--supervise`` become the
    supervisor and exit with its code; else set up logging and the cfg
    files (rank 0), arm the watchdog, join the world (``--dist_world_size``
    > 1), build and train; leaves the world at the end and returns the
    trainer."""
    argv = sys.argv[1:] if argv is None else list(argv)
    (parser, model_parser), (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), argv)
    exp_dir = params.dump_dir / params.experiment_name
    os.makedirs(exp_dir, exist_ok=True)
    # the drills armed in this process (a supervisor's children arm their
    # own from the same argv)
    if params.fault_plan:
        faults.install_plan(params.fault_plan)
    if params.supervise and not os.environ.get(SUPERVISED_ENV):
        # each attempt is a child of this CLI without --supervise;
        # MLRT_SUPERVISED breaks the recursion when a cfg sets the flag
        from ..resilience.supervisor import supervise_cli

        logging.basicConfig(level=logging.INFO, format=_LOG_FORMAT,
                            handlers=[logging.StreamHandler(sys.stderr)])
        check_train_flags(params, model_params)
        raise SystemExit(supervise_cli(params, argv))
    # the reference's local_rank in [-1, 0] gate, on the live world
    primary = pdist.live_world(params)[1] == 0
    params.log_file = (
        exp_dir / f'{datetime.now().strftime("%d-%m-%Y_%H-%M-%S")}.log'
        if primary else None)
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    handlers = [logging.StreamHandler(sys.stderr)]
    if primary:
        handlers.append(logging.FileHandler(params.log_file, mode="w"))
    logging.basicConfig(level=logging.INFO, format=_LOG_FORMAT,
                        handlers=handlers)
    show_params(model_params, "model")
    show_params(params, "trainer")
    if primary:
        write_config_file(parser, params, exp_dir / "trainer.cfg")
        write_config_file(model_parser, model_params, exp_dir / "model.cfg")
    # armed before the world is joined: the rendezvous is the first thing
    # that can hang, and its frame exists only with the watchdog installed
    watchdog = _arm_watchdog(params)
    try:
        # join before any CUDA use: NCCL binds the rank's device
        pdist.initialize_from_params(params)
        return run_worker(params, model_params)
    finally:
        pdist.shutdown()
        # stop the monitor and clear the slot: a later in-process run must
        # not inherit it
        if watchdog is not None:
            watchdog.stop()
        watchdog_mod.install(None)


if __name__ == "__main__":
    main()
