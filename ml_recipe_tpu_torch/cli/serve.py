"""Online QA serving entry point of the PyTorch/CUDA port.

Builds the model (seeded random init, then ``--checkpoint``), the bucket
grid and the engine, runs every bucket once, then serves ``POST /v1/qa``
until SIGTERM drains it::

    python -m ml_recipe_tpu_torch.cli.serve -c config/serve.cfg --vocab_file V

The model runs on ``--device`` (``cuda`` by default; without CUDA that
raises). Every attention call on the card goes through the hand-written
fused attention kernel (``csrc/fused_attention_fwd.cu``); with
``--quantize int8`` every matmul projection through the int8 matmul kernel
(``csrc/q8_matmul.cu``, weights converted at start-up), and with
``--ln_impl fused|auto`` every LayerNorm through ``csrc/layer_norm.cu``.
``--doc_cache_bytes`` / ``--serve_cache_bytes`` turn on the two serving
caches (``serve/cache.py``), and ``--trace_spans DIR`` writes each
request's spans to ``DIR/serve_trace_<pid>.json`` when the drain ends.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from pathlib import Path

from ..compose import init_model
from ..config.parser import (
    check_serve_flags,
    get_model_parser,
    get_params,
    get_serve_parser,
)
from ..utils.logging import show_params

logger = logging.getLogger("serve")


def build_engine(params, model_params):
    """The checked flags' model and ``QAEngine`` (not warmed up yet)."""
    from ..serve.bucketing import BucketGrid
    from ..serve.engine import QAEngine

    check_serve_flags(params, model_params)
    model, tokenizer = init_model(model_params, checkpoint=params.checkpoint,
                                  quantize=params.quantize)
    return QAEngine(
        model,
        tokenizer,
        grid=BucketGrid.from_spec(params.buckets),
        max_batch_delay_ms=params.max_batch_delay_ms,
        queue_size=params.queue_size,
        max_question_len=params.max_question_len,
        doc_stride=params.doc_stride,
        long_scatter_chunks=params.long_scatter_chunks,
        serve_cache_bytes=params.serve_cache_bytes,
        doc_cache_bytes=params.doc_cache_bytes,
    )


def main(params, model_params) -> int:
    from ..metrics import trace as trace_mod
    from ..serve.server import QAServer

    show_params(model_params, "model")
    show_params(params, "serve")

    # --trace_spans: request-lifecycle spans as Chrome trace-event JSON,
    # written out when the drain completes
    tracer = None
    if params.trace_spans:
        tracer = trace_mod.install(trace_mod.TraceWriter(
            str(Path(params.trace_spans) / f"serve_trace_{os.getpid()}.json"),
            process_name="serve",
        ))

    engine = build_engine(params, model_params)
    engine.warmup()

    server = QAServer(
        engine,
        host=params.host,
        port=params.port,
        request_timeout_s=params.request_timeout_s,
        drain_timeout_s=params.drain_timeout_s,
    )
    server.install_signal_handlers()
    server.start()

    if params.ready_file:
        # orchestration hook: the listener is up and every bucket has run
        ready = Path(params.ready_file)
        tmp = ready.with_name(ready.name + ".tmp")
        tmp.write_text(json.dumps({
            "host": server.host, "port": server.port, "pid": os.getpid(),
            "buckets": [str(b) for b in engine.grid],
        }))
        os.replace(tmp, ready)

    try:
        server.wait()
    finally:
        server.shutdown()
        if tracer is not None:
            trace_mod.install(None)
            tracer.close()
    return 0


def cli(argv=None) -> None:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        level=logging.INFO, stream=sys.stderr)
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser), argv)
    raise SystemExit(main(params, model_params))


if __name__ == "__main__":
    cli()
