"""Serving-fleet entry point of the PyTorch/CUDA port: router tier + N
supervised engines (the port of ``ml_recipe_tpu/cli/fleet.py``).

Launches N ``ml_recipe_tpu_torch.cli.serve`` engine children (each runs
its bucket grid once before admitting traffic), puts the consistent-hash
router in front of them, and serves ``POST /v1/qa`` until SIGTERM. The
router sheds load health-first; crashed engines are classified with the
``resilience/`` exit-code contract and relaunched behind the router's
ejection. ``--rolling_restart true`` performs one rolling restart pass
once the tier is up, and SIGHUP asks for another at any time; each
finished pass is written to ``<fleet_run_dir>/rolling_restart.json``.

Usage::

    python -m ml_recipe_tpu_torch.cli.fleet -c config/fleet.cfg \\
        --vocab_file V [--checkpoint C] [--device cpu]

``--host``/``--port`` bind the ROUTER; engines always bind ephemeral
ports on the same host and run on ``--device`` (``cuda`` by default, all
on the current card). ``--ready_file`` documents the router address and
every engine endpoint once the whole tier admits traffic.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import tempfile
import threading
from pathlib import Path

from ..config.parser import (
    check_serve_flags,
    get_fleet_parser,
    get_model_parser,
    get_params,
    get_serve_parser,
)
from ..fleet import FleetManager, FleetRouter
from ..metrics.artifacts import atomic_write_json
from ..utils.logging import show_params


# (flag, attr, kind) map from the parsed serve+model namespaces onto the
# engine-child argv. 'value' flags are skipped when None; 'bool' flags
# are forwarded as true/false; 'switch' flags are store_true and forwarded
# only when set. The JAX package's list, plus the port's --device and the
# --long_scatter_chunks threshold.
_MODEL_FLAGS = (
    ("--model", "model", "value"),
    ("--vocab_file", "vocab_file", "value"),
    ("--merges_file", "merges_file", "value"),
    ("--lowercase", "lowercase", "switch"),
    ("--handle_chinese_chars", "handle_chinese_chars", "switch"),
    ("--hf_checkpoint", "hf_checkpoint", "value"),
    ("--param_dtype", "param_dtype", "value"),
    ("--compute_dtype", "compute_dtype", "value"),
    ("--flash_attention", "flash_attention", "value"),
    ("--ln_impl", "ln_impl", "value"),
    ("--max_position_embeddings", "max_position_embeddings", "value"),
    ("--device", "device", "value"),
)
_SERVE_FLAGS = (
    ("--host", "host", "value"),
    ("--buckets", "buckets", "value"),
    ("--max_batch_delay_ms", "max_batch_delay_ms", "value"),
    ("--queue_size", "queue_size", "value"),
    ("--request_timeout_s", "request_timeout_s", "value"),
    ("--drain_timeout_s", "drain_timeout_s", "value"),
    ("--max_question_len", "max_question_len", "value"),
    ("--doc_stride", "doc_stride", "value"),
    ("--long_scatter_chunks", "long_scatter_chunks", "value"),
    ("--mesh", "mesh", "value"),
    ("--autotune", "autotune", "bool"),
    ("--autotune_cache", "autotune_cache", "value"),
    ("--aot_cache", "aot_cache", "value"),
    ("--aot_cache_bytes", "aot_cache_bytes", "value"),
    ("--hbm_preflight", "hbm_preflight", "bool"),
    ("--serve_cache_bytes", "serve_cache_bytes", "value"),
    ("--doc_cache_bytes", "doc_cache_bytes", "value"),
    ("--quantize", "quantize", "value"),
    ("--trace_spans", "trace_spans", "value"),
)

RESTART_REPORT = "rolling_restart.json"


def engine_argv(serve_params, model_params) -> list:
    """The common ``cli.serve`` child argv from the parsed namespaces
    (everything but --port/--ready_file/--checkpoint, which the manager
    owns per engine)."""
    argv = []
    for flags, params in ((_MODEL_FLAGS, model_params),
                          (_SERVE_FLAGS, serve_params)):
        for flag, attr, kind in flags:
            value = getattr(params, attr, None)
            if kind == "switch":
                if value:
                    argv.append(flag)
            elif kind == "bool":
                argv.extend([flag, "true" if value else "false"])
            elif value is not None:
                argv.extend([flag, str(value)])
    return argv


def main(fleet_params, params, model_params) -> int:
    show_params(model_params, "model")
    show_params(params, "serve")
    show_params(fleet_params, "fleet")
    # refuse what every child would refuse, before launching any
    check_serve_flags(params, model_params)

    run_dir = Path(
        fleet_params.fleet_run_dir
        or tempfile.mkdtemp(prefix="mlrt_fleet_")
    )
    checkpoints = None
    if fleet_params.engine_checkpoints:
        checkpoints = [
            c.strip() or None
            for c in fleet_params.engine_checkpoints.split(",")
        ]
    elif params.checkpoint:
        checkpoints = [params.checkpoint]

    router = FleetRouter(
        host=params.host,
        port=params.port,
        ring_replicas=fleet_params.ring_replicas,
        health_poll_s=fleet_params.health_poll_s,
        eject_after=fleet_params.eject_after,
        degrade_weight=fleet_params.degrade_weight,
        queue_pressure=fleet_params.queue_pressure,
        spill_retries=fleet_params.spill_retries,
        request_timeout_s=params.request_timeout_s,
        routing=fleet_params.routing,
    )
    manager = FleetManager(
        engine_argv(params, model_params),
        n_engines=fleet_params.engines,
        run_dir=run_dir,
        checkpoints=checkpoints,
        drain_timeout_s=params.drain_timeout_s,
        router=router,
    )

    stop = threading.Event()
    restart = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 - signal API
        stop.set()

    def _on_hup(signum, frame):  # noqa: ARG001 - signal API
        restart.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGHUP, _on_hup)

    passes = []

    def rolling_pass() -> None:
        passes.append(manager.rolling_restart())
        atomic_write_json(run_dir / RESTART_REPORT,
                          {"passes": len(passes), "reports": passes[-1]})

    try:
        manager.start()
        router.start()

        if params.ready_file:
            # orchestration hook: the router is listening and every
            # engine's bucket grid has run — traffic is safe to send
            atomic_write_json(params.ready_file, {
                "host": router.host, "port": router.port, "pid": os.getpid(),
                "run_dir": str(run_dir),
                "engines": [
                    {"node": ep.node_id, "host": ep.host, "port": ep.port,
                     "checkpoint": ep.checkpoint}
                    for ep in router.endpoints()
                ],
            })

        if fleet_params.rolling_restart:
            rolling_pass()

        while not stop.wait(0.5):
            if restart.is_set():
                restart.clear()
                rolling_pass()
            manager.reap()
    finally:
        manager.stop()
        router.close()
    return 0


def cli(argv=None) -> None:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        level=logging.INFO, stream=sys.stderr)
    _, (fleet_params, params, model_params) = get_params(
        (get_fleet_parser, get_serve_parser, get_model_parser), argv)
    raise SystemExit(main(fleet_params, params, model_params))


if __name__ == "__main__":
    cli()
