"""Online QA inference engine: request -> chunks -> shared batches -> span.

The port of ``ml_recipe_tpu/serve/engine.py``:

- each request's document is sliding-window chunked on the host
  (``data/chunking.py``);
- chunks go to the continuous micro-batcher (``batcher.MicroBatcher``),
  which coalesces concurrent requests into ``(batch, seq)`` buckets from the
  fixed grid (``bucketing.BucketGrid``);
- every batch runs the scoring forward of ``infer/score.py`` on the model's
  device under ``torch.inference_mode()`` (entered on the batcher thread:
  the mode is thread-local), and ONE packed ``[6, B]`` f32 tensor comes
  back to the host;
- when a request's last chunk lands, chunks are reduced IN CHUNK ORDER with
  the predictor's validity rules (span order, answer not inside the
  question, best-score-wins, ties to the later chunk), and the winning span
  is decoded back to text;
- two optional byte-budgeted caches short-circuit the hot path
  (``serve/cache.py``, off by default): document preprocessing by content
  hash, and per-chunk result rows by exact-device-row hash + weights
  fingerprint + precision with single-flight dedup. Cache-hit chunks bypass
  the micro-batcher (a fully-hot request touches neither the queue nor the
  device), and responses are bit-identical cached or not: a cached row is
  the host row of Python floats a miss computed;
- with a tracer installed (``metrics/trace.py``, ``--trace_spans``) each
  request leaves ``admission`` → ``queue`` → ``flush`` → ``device`` →
  ``span_reduce`` spans keyed by its request id (``respond`` comes from
  ``serve/server.py``).

A model from ``quant.quantize_model`` serves int8 (``quantize``, read from
the model): ``/metrics`` then reports ``qa_active_precision`` int8 and the
int8 weights' bytes. ``/metrics`` also carries this process's kernel builds
(``qa_kernel_build_{hits,misses}_total``, ``ops/cuda_build.py``), the
library store's outcomes (``qa_aot_cache_{hits,misses}_total`` and
``qa_aot_load_seconds``, ``ops/aot.py``) and each hand-written kernel's
launches (``qa_kernel_launches_total``).

The warm-up plane (:meth:`QAEngine.warmup`), per bucket of the grid:

- the memory pre-flight (``hbm_preflight``): one forward at the bucket's
  shape, measured by the CUDA allocator (``utils/hbm.py``); a bucket whose
  need exceeds the card's memory is dropped from the grid, the last one
  kept;
- a CUDA graph of the scoring forward (the counterpart of the JAX engine's
  one compiled program per bucket, which comes from the AOT store): static
  wire-format input and ``[6, B]`` output buffers, a warm-up run on a side
  stream first (the kernels' one-time host calls and the allocator's
  blocks), one graph memory pool for every bucket (the batcher runs one
  batch at a time and each batch's rows are copied out before the next
  replay). ``_run_batch`` copies the host batch into the bucket's static
  input, replays, and copies the rows out through a pinned buffer. Each
  replay adds the graph's captured launches to the kernels' counts. A
  failed capture or replay raises; dispatch is eager only with the store
  off (``--aot_cache off``) or on the CPU;
- its measured cost (``ops/autotune.py``): the median of a few replays
  timed by CUDA events (eager forwards by ``perf_counter`` on the CPU),
  recorded once per tuning cache; with ``--autotune`` the batcher flushes
  the cheapest measured program first (``serve/batcher.py``).
"""

from __future__ import annotations

import itertools
import json
import logging
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.chunking import assemble_input_ids, encode_document, window_chunks
from ..data.labels import id2labels
from ..infer.score import OUT_KEYS, pack_wire, score_wire
from ..metrics import trace as trace_mod
from ..ops import aot, autotune, cuda_build
from ..quant.quantize import param_bytes
from ..utils import hbm
from .batcher import ChunkWork, DrainingError, MicroBatcher, QueueFullError
from .bucketing import Bucket, BucketGrid, pad_trailing_batch
from .cache import (
    ENTRY_OVERHEAD,
    TOKEN_BYTES,
    ByteBudgetLRU,
    ChunkResultCache,
    content_key,
    params_fingerprint,
    row_key,
)
from .metrics import Registry

logger = logging.getLogger(__name__)

__all__ = [
    "QAEngine", "QAResult", "RequestTicket", "RequestRejected",
    "QueueFullError", "DrainingError",
]


class RequestRejected(ValueError):
    """The request cannot be admitted at all (over-long question, empty
    document) — a client error, not backpressure."""


@dataclass
class QAResult:
    """Final per-request answer."""

    answer: str
    label: str           # 'yes' | 'no' | 'short' | 'long' | 'unknown'
    score: float         # answerability score of the winning chunk (0 if none)
    start: int           # winning span in final-input token coordinates
    end: int
    n_chunks: int
    latency_ms: float

    def to_json(self) -> dict:
        return {
            "answer": self.answer,
            "label": self.label,
            "score": round(float(self.score), 6),
            "start": int(self.start),
            "end": int(self.end),
            "n_chunks": int(self.n_chunks),
            "latency_ms": round(float(self.latency_ms), 3),
        }


@dataclass
class _ChunkRef:
    """Batcher payload: which request, which chunk.

    ``key`` is the chunk's tier-2 cache key when the chunk-result cache is
    on and this chunk LEADS a single-flight entry (the row computed for it
    is published through ``ChunkResultCache.complete`` / ``fail_flight``);
    None otherwise."""

    ticket: "RequestTicket"
    idx: int
    input_ids: List[int]
    key: Optional[str] = None


# request ids key the serving trace spans; monotonic per process
_REQUEST_IDS = itertools.count(1)


def kernels() -> Dict[str, "cuda_build.Kernel"]:
    """Each hand-written kernel, by the name the chip smoke gives it."""
    from ..ops import flash_attention as fa
    from ..ops import layer_norm as ln
    from ..ops import quant_matmul as q8

    return {"fused_attention_fwd": fa.KERNEL,
            "fused_attention_bwd": fa.BWD_KERNEL,
            "layer_norm_fwd": ln.FWD_KERNEL,
            "layer_norm_bwd": ln.BWD_KERNEL,
            "q8_matmul": q8.KERNEL,
            "q8_quantize": q8.QUANT_KERNEL}


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launches in this process (the wrappers'
    counts, and the replayed graphs' captured launches)."""
    return {name: k.launches for name, k in kernels().items()}


# replays (or eager forwards on the CPU) timed per bucket for its measured
# cost; one untimed replay before them
COST_REPEATS = 3


class BucketGraph:
    """One kept bucket's CUDA graph of the scoring forward: its static
    input (wire format) and ``[6, B]`` output, the pinned host copy of the
    output, and the kernels' launches the capture recorded (added to their
    counts on every replay)."""

    def __init__(self, graph, static_in: torch.Tensor,
                 static_out: torch.Tensor, tally: Dict[str, int]):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.host_out = torch.empty(static_out.shape, dtype=static_out.dtype,
                                    pin_memory=True)
        self.tally = {k: n for k, n in tally.items() if n}

    def run(self, packed: torch.Tensor) -> np.ndarray:
        """Copy ``packed`` (host, wire format) in, replay, copy the rows out
        (an owned host array: the next replay overwrites the static
        output)."""
        self.static_in.copy_(packed)
        self.graph.replay()
        self.host_out.copy_(self.static_out)
        self.count(1)
        return self.host_out.numpy().copy()

    def count(self, replays: int) -> None:
        """Add ``replays`` replays' launches to the kernels' counts."""
        launched = kernels()
        for name, n in self.tally.items():
            launched[name].launches += n * replays


class RequestTicket:
    """Completion handle for one submitted request."""

    def __init__(self, *, n_chunks: int, question_len: int,
                 request_id: Optional[str] = None):
        # a forwarded id (X-Request-Id) keeps one key across hops; local
        # submissions draw from the process-wide counter
        self.request_id = request_id if request_id is not None \
            else next(_REQUEST_IDS)
        self.n_chunks = n_chunks
        # dedicated scatter batches this request launched as (0 = the
        # coalescing queue served it)
        self.scatter_batches = 0
        self.question_len = question_len
        self.created_at = time.perf_counter()
        self.chunks: List[List[int]] = []
        self._outputs: Dict[int, Dict[str, float]] = {}
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self._result: Optional[QAResult] = None
        self._lock = threading.Lock()

    def _offer(self, idx: int, row: Dict[str, float]) -> bool:
        """Record one chunk's packed-output row; True when this was the
        last outstanding chunk."""
        with self._lock:
            self._outputs[idx] = row
            return len(self._outputs) == self.n_chunks

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._error = exc
        self._event.set()

    def _finish(self, result: QAResult) -> None:
        self._result = result
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> QAResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request did not complete within {timeout}s "
                f"({len(self._outputs)}/{self.n_chunks} chunks done)"
            )
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class QAEngine:
    """Long-running QA serving engine over one model (weights on its device)."""

    def __init__(
        self,
        model: torch.nn.Module,
        tokenizer,
        *,
        grid: BucketGrid,
        max_batch_delay_ms: float = 10.0,
        queue_size: int = 256,
        max_question_len: int = 64,
        doc_stride: int = 128,
        registry: Optional[Registry] = None,
        long_scatter_chunks: int = 0,
        serve_cache_bytes: int = 0,
        doc_cache_bytes: int = 0,
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        # the active serving precision: 'int8' for a quant.quantize_model
        # twin, on /metrics and in the warmup report
        self.quantize = getattr(model, "quantize", "off")
        self.tokenizer = tokenizer
        self.grid = grid
        self.max_question_len = int(max_question_len)
        self.doc_stride = int(doc_stride)
        # long-request scatter path: a request whose document windows into
        # at least this many chunks launches its chunks chunk-parallel as
        # dedicated batches (BucketGrid.scatter_plan); 0 disables it
        self.long_scatter_chunks = int(long_scatter_chunks or 0)
        self._closed = False
        self._close_logged = False

        # -- serving hot-path caches (serve/cache.py; both off by default) ----
        # tier 1: document preprocessing (encode_document tokens + the
        # window_chunks layout), keyed by document content hash
        self._doc_cache = (
            ByteBudgetLRU(doc_cache_bytes) if doc_cache_bytes > 0 else None)
        # tier 2: per-chunk packed output rows keyed by the exact device
        # input row + weights fingerprint + active precision, with
        # single-flight dedup of identical in-flight chunks
        self._chunk_cache = (
            ChunkResultCache(serve_cache_bytes)
            if serve_cache_bytes > 0 else None)
        # the fingerprint's device->host copy is paid only when tier 2 can
        # use it
        self._fingerprint = (
            params_fingerprint(self.model)
            if self._chunk_cache is not None else None)

        # measured flush ranking: per-(batch, seq) costs are static once
        # warmup records them, so the batcher-thread hook memoizes lookups
        self._flush_cost_memo: Dict[Tuple[int, int], Optional[float]] = {}
        # per-(batch, seq) CUDA graphs, captured at warmup (before the
        # batcher thread starts) and read lock-free by _run_batch; empty
        # with the store off or on the CPU (eager dispatch)
        self._graphs: Dict[Tuple[int, int], BucketGraph] = {}
        self._graph_pool = None
        # device forwards (eager runs and replays) this engine ran
        self.device_forwards = 0
        self._weight_bytes = param_bytes(self.model.state_dict())

        self._pad_id = int(tokenizer.pad_token_id)
        self._sep_id = int(tokenizer.sep_token_id)
        self._cls_id = int(tokenizer.cls_token_id)
        self._is_bert = getattr(tokenizer, "model_name", "bert") == "bert"
        self._wire_ids_only, self._score = score_wire(self.model, tokenizer)

        # -- metrics plane ---------------------------------------------------
        self.metrics = registry if registry is not None else Registry()
        m = self.metrics
        self.m_requests = m.counter(
            "qa_requests_total", "QA requests admitted.")
        self.m_completed = m.counter(
            "qa_requests_completed_total", "QA requests answered.")
        self.m_failed = m.counter(
            "qa_requests_failed_total", "QA requests failed internally.")
        self.m_rejected_full = m.counter(
            "qa_rejected_queue_full_total",
            "Requests rejected by queue-full backpressure.")
        self.m_rejected_draining = m.counter(
            "qa_rejected_draining_total",
            "Requests rejected while draining for shutdown.")
        self.m_rejected_invalid = m.counter(
            "qa_rejected_invalid_total",
            "Requests rejected as unservable (over-long, empty).")
        self.m_queue_depth = m.gauge(
            "qa_queue_depth", "Chunks waiting in the micro-batch queue.")
        self.m_batches = m.counter(
            "qa_batches_total", "Bucket batches launched.")
        self.m_last_batch_rows = m.gauge(
            "qa_last_batch_rows", "Valid rows in the most recent batch.")
        self.m_occupancy = m.histogram(
            "qa_batch_occupancy",
            "Valid rows / bucket batch rows per launched batch.",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self.m_padding_waste = m.histogram(
            "qa_padding_waste_ratio",
            "Padded token slots / total token slots per launched batch.",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self.m_latency = m.histogram(
            "qa_request_latency_seconds",
            "End-to-end request latency (submit to reduced answer).")
        self.m_latency_p50 = m.gauge(
            "qa_request_latency_p50_seconds",
            "p50 request latency over recent requests.")
        self.m_latency_p95 = m.gauge(
            "qa_request_latency_p95_seconds",
            "p95 request latency over recent requests.")
        self.m_latency_p99 = m.gauge(
            "qa_request_latency_p99_seconds",
            "p99 request latency over recent requests.")
        dtype = getattr(model, "dtype", torch.float32)
        precision = ("int8" if self.quantize == "int8"
                     else "bf16" if dtype == torch.bfloat16 else "f32")
        self.m_precision = m.info(
            "qa_active_precision",
            "Numeric precision of the serving forward (int8 = the "
            "post-training quantized path, quant/).",
            {"precision": precision, "device": str(self.device)})
        self.m_weight_bytes = m.gauge(
            "qa_weight_bytes",
            "Resident model weight bytes (int8 quantization roughly "
            "quarters the f32 kernels).")
        self.m_weight_bytes.set(self._weight_bytes)
        self.m_longdoc_requests = m.counter(
            "qa_longdoc_requests_total",
            "Requests served through the long-request scatter path "
            "(chunk-parallel dedicated batches).")
        self.m_longdoc_batches = m.counter(
            "qa_longdoc_scatter_batches_total",
            "Dedicated scatter batches launched for long requests.")
        # cache series are registered at any budget (0 included): the
        # /metrics surface does not change shape with configuration
        self._cache_metrics = {
            name: {
                "hits": m.counter(
                    f"qa_{name}_cache_hits_total", f"{what} cache hits."),
                "misses": m.counter(
                    f"qa_{name}_cache_misses_total", f"{what} cache misses."),
                "evictions": m.counter(
                    f"qa_{name}_cache_evictions_total",
                    f"{what} cache LRU evictions (byte budget)."),
                "bytes": m.gauge(
                    f"qa_{name}_cache_bytes",
                    f"{what} cache resident bytes (exact accounting)."),
                "entries": m.gauge(
                    f"qa_{name}_cache_entries", f"{what} cache entries."),
            }
            for name, what in (
                ("doc", "Tier-1 document-preprocessing"),
                ("chunk", "Tier-2 chunk-result"),
            )
        }
        self.m_flight_joins = m.counter(
            "qa_chunk_flight_joins_total",
            "Chunks that piggybacked on an identical in-flight chunk "
            "(single-flight dedup wins).")
        # the counterpart of the JAX engine's AOT program-store series: a
        # replacement engine of a rolling restart must build no kernel
        self.m_build_hits = m.counter(
            "qa_kernel_build_hits_total",
            "Kernel libraries this process loaded from csrc/build/ without "
            "running nvcc (ops/cuda_build.py).")
        self.m_build_misses = m.counter(
            "qa_kernel_build_misses_total",
            "nvcc runs of this process (kernel libraries built).")
        # the library store's outcomes (ops/aot.py), the JAX engine's AOT
        # program-store series: registered at any configuration
        self.m_aot_hits = m.counter(
            "qa_aot_cache_hits_total",
            "Kernel libraries this process loaded from the store without "
            "building them (ops/aot.py).")
        self.m_aot_misses = m.counter(
            "qa_aot_cache_misses_total",
            "Kernel libraries this process built and wrote to the store "
            "for the next restart.")
        self.m_aot_load = m.histogram(
            "qa_aot_load_seconds",
            "Kernel-library load times on store hits.")
        self.m_kernel_launches = m.labeled_gauge(
            "qa_kernel_launches_total",
            "Launches of each hand-written kernel in this process.", "kernel")
        # last-synced source values of the mirrored counters, under a lock:
        # /metrics renders on concurrent HTTP handler threads, and racing
        # scrapes computing the same delta would double-count
        self._sync_lock = threading.Lock()
        self._synced: Dict[str, float] = {}

        self.batcher = MicroBatcher(
            grid,
            self._run_batch,
            max_batch_delay_ms=max_batch_delay_ms,
            queue_size=queue_size,
            fail_fn=self._fail_batch,
            on_depth=self.m_queue_depth.set,
            # measured flush ranking needs a cost source: with the tuning
            # cache off every lookup would return None, so the historical
            # oldest-first order stays
            flush_cost_fn=(
                self._flush_cost if autotune.get().enabled else None),
        )
        self.warmup_report: Optional[dict] = None

    # -- warmup ----------------------------------------------------------------

    def _dummy_inputs(self, bucket: Bucket) -> dict:
        """A dense (fully-attended) host batch at the bucket shape:
        [CLS] filler... [SEP] rows."""
        ids = np.full((bucket.batch, bucket.seq), self._cls_id, np.int32)
        ids[:, -1] = self._sep_id
        lengths = np.full((bucket.batch,), bucket.seq, np.int32)
        return self._host_arrays(ids, lengths)

    def _host_arrays(self, ids: np.ndarray, lengths: np.ndarray) -> dict:
        """collate-shaped host dict from an id plane + true row lengths."""
        positions = np.arange(ids.shape[1], dtype=np.int32)[None, :]
        attention_mask = (positions < lengths[:, None]).astype(np.int32)
        token_type_ids = np.zeros_like(ids)
        if self._is_bert:
            for i in range(ids.shape[0]):
                row = ids[i, : lengths[i]]
                seps = np.flatnonzero(row == self._sep_id)
                sep_pos = int(seps[0]) if seps.size else int(lengths[i]) - 1
                token_type_ids[i, sep_pos + 1: lengths[i]] = 1
        return {
            "input_ids": ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
        }

    def _wire_pack(self, inputs: dict) -> torch.Tensor:
        """Host dict -> device tensor in the engine's wire format."""
        return pack_wire(inputs, self._wire_ids_only).to(self.device)

    def run_packed(self, inputs: dict) -> np.ndarray:
        """The scoring forward on one host batch, eager: the ``[6, B]`` f32
        array in ``OUT_KEYS`` row order."""
        with torch.inference_mode():
            out = self._score(self._wire_pack(inputs))
            self.device_forwards += 1
            return out.cpu().numpy()

    def _dispatch(self, batch: int, seq: int, inputs: dict) -> np.ndarray:
        """One batch at a kept bucket's shape: its graph's replay when
        warmup captured one, else the eager forward."""
        graph = self._graphs.get((batch, seq))
        if graph is None:
            return self.run_packed(inputs)
        with torch.inference_mode(), cuda_build.launch_scope(self.device):
            out = graph.run(pack_wire(inputs, self._wire_ids_only))
        self.device_forwards += 1
        return out

    # -- warmup + the memory pre-flight ------------------------------------------

    def _graphs_enabled(self) -> bool:
        """Graph dispatch: on CUDA with the store on (``--aot_cache off``
        and the CPU dispatch eagerly)."""
        return self.device.type == "cuda" and aot.get().enabled

    def preflight_predict_step(self, bucket: Bucket, *, limit_bytes=None,
                               compile_fn=None) -> Optional[dict]:
        """One bucket's device-memory need against the card's memory:
        ``{"bytes": need, "limit": limit, "fits": bool}``, or None when no
        limit or no analysis is available (the planner stands down rather
        than guess). The need is measured (``utils/hbm.measure``) from one
        forward at the bucket's shape: the weights and the input, the
        output, and the allocator's peak above them. A forward that runs
        out of memory does not fit (``"out_of_memory": True``, ``bytes`` the
        lower bound it reached). ``compile_fn(bucket)`` / ``limit_bytes``
        are the JAX signature's injection points: an object whose
        ``memory_analysis()`` stands in for the measurement, and the
        limit."""
        limit = (limit_bytes if limit_bytes is not None
                 else hbm.device_hbm_bytes(self.device))
        if limit is None:
            return None
        try:
            if compile_fn is not None:
                analysis = compile_fn(bucket).memory_analysis()
            else:
                analysis = self._measure_bucket(bucket)
        except Exception as e:  # noqa: BLE001 - analysis is best-effort
            logger.info("predict pre-flight: memory analysis unavailable "
                        "(%s); skipping.", e)
            return None
        need = hbm.preflight_bytes(analysis)
        if need is None:
            return None
        verdict = {"bytes": int(need), "limit": int(limit),
                   "fits": not hbm.exceeds(analysis, need, limit)}
        if getattr(analysis, "out_of_memory", False):
            verdict["out_of_memory"] = True
        return verdict

    def _measure_bucket(self, bucket: Bucket) -> hbm.MemoryAnalysis:
        """The measured forward of the pre-flight at ``bucket``'s shape."""
        dev = self._wire_pack(self._dummy_inputs(bucket))
        with torch.inference_mode():
            _, analysis = hbm.measure(
                lambda: self._score(dev), self.device,
                argument_bytes=self._weight_bytes + hbm.tensor_bytes([dev]))
        self.device_forwards += 1
        return analysis

    def _capture(self, bucket: Bucket) -> BucketGraph:
        """The bucket's CUDA graph: a warm-up run on a side stream (the
        kernels' one-time host calls, the allocator's blocks), then the
        capture into the pool all buckets share. Raises when it fails."""
        static_in = self._wire_pack(self._dummy_inputs(bucket))
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.inference_mode(), torch.cuda.stream(side):
            self._score(static_in)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.device_forwards += 1
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = {name: k.captured for name, k in kernels().items()}
        with torch.inference_mode(), \
                torch.cuda.graph(graph, pool=self._graph_pool):
            static_out = self._score(static_in)
        tally = {name: k.captured - before[name]
                 for name, k in kernels().items()}
        return BucketGraph(graph, static_in, static_out, tally)

    def warmup(self, *, hbm_preflight: bool = True, limit_bytes=None,
               compile_fn=None) -> dict:
        """Before traffic, for every bucket: the memory pre-flight (drop a
        bucket that does not fit, never the last one), the CUDA graph (or
        one eager forward), and its measured cost when the tuning cache has
        none. Starts the batcher and returns the report (the JAX keys, and
        ``dispatch``, ``graphs`` with each graph's launches per replay,
        ``device_batches``, the device forwards warmup ran, and
        ``kernel_launches``)."""
        t0 = time.perf_counter()
        before = kernel_launches()
        forwards0 = self.device_forwards
        graphs = self._graphs_enabled()
        report = {"buckets": [], "dropped": [], "preflight": {},
                  "bucket_seconds": {}, "program_costs": {}, "graphs": {},
                  "dispatch": "graph" if graphs else "eager",
                  "wire": "ids" if self._wire_ids_only else "3plane",
                  "device": str(self.device), "quantize": self.quantize,
                  "quant_mem_bytes": self._weight_bytes,
                  "mesh_axes": {"data": 1}, "mesh_unused_devices": 0}
        for bucket in list(self.grid):
            tb = time.perf_counter()
            if hbm_preflight:
                verdict = self.preflight_predict_step(
                    bucket, limit_bytes=limit_bytes, compile_fn=compile_fn)
                if verdict is not None:
                    report["preflight"][str(bucket)] = verdict
                    if not verdict["fits"]:
                        if self.grid.drop(bucket):
                            logger.warning(
                                "predict pre-flight: bucket %s needs %s%.2f GB "
                                "vs %.2f GB device memory; dropping it from "
                                "the serving grid.", bucket,
                                "over " if verdict.get("out_of_memory") else "",
                                verdict["bytes"] / 1e9, verdict["limit"] / 1e9)
                            report["dropped"].append(str(bucket))
                            continue
                        logger.warning(
                            "predict pre-flight: bucket %s exceeds device "
                            "memory but is the last bucket; keeping it.",
                            bucket)
            if graphs:
                graph = self._capture(bucket)
                self._graphs[(bucket.batch, bucket.seq)] = graph
                report["graphs"][str(bucket)] = dict(graph.tally)
            else:
                self.run_packed(self._dummy_inputs(bucket))
            est = self._record_program_cost(bucket)
            report["program_costs"][str(bucket)] = (
                est.get("est_seconds") if est else None)
            report["bucket_seconds"][str(bucket)] = round(
                time.perf_counter() - tb, 4)
            report["buckets"].append(str(bucket))
        report["autotune"] = autotune.get().session_summary()
        report["aot"] = aot.get().session_summary()
        report["warmup_seconds"] = round(time.perf_counter() - t0, 3)
        report["device_batches"] = self.device_forwards - forwards0
        # which attention ran: the hand-written kernel ('fused', counted by
        # its wrapper) or its plain version ('plain', a CPU model)
        launched = {k: n - before[k] for k, n in kernel_launches().items()}
        report["kernel_launches"] = launched
        report["attention_route"] = (
            "fused" if launched["fused_attention_fwd"] else "plain")
        self.warmup_report = report
        self.batcher.start()
        logger.info("serving warmup: %d buckets on %s (%s dropped by the "
                    "pre-flight, %s dispatch) in %.1fs; attention route %s "
                    "(%d kernel launches); cost measurements this session: "
                    "%d.", len(report["buckets"]), self.device,
                    len(report["dropped"]) or "none", report["dispatch"],
                    report["warmup_seconds"], report["attention_route"],
                    launched["fused_attention_fwd"],
                    report["autotune"]["probes"])
        return report

    # -- measured flush ranking ------------------------------------------------

    def _program_signature(self) -> str:
        """Shape-independent identity of the serving program: the model's
        geometry, the wire format and the active precision (the JAX
        engine's string for the same model, wire and precision)."""
        cfg = getattr(self.model, "cfg", None)
        sig = (f"h{cfg.hidden_size}l{cfg.num_layers}n{cfg.num_heads}"
               f"v{cfg.vocab_size}" if cfg is not None else "anon")
        wire = "ids" if self._wire_ids_only else "3p"
        suffix = "-q8" if self.quantize == "int8" else ""
        return f"{sig}-{wire}{suffix}"

    def _program_cost_key(self, batch: int, seq: int) -> str:
        """Tuning-cache key of one bucket's whole serving program (the JAX
        engine's string). On the card with the store off the program is
        launched eagerly, not replayed, and its cost keeps a key of its own
        (``-eager``): neither dispatch ranks flushes by the other's cost."""
        key = f"serve-step-{batch}x{seq}-{self._program_signature()}"
        if self.device.type == "cuda" and not self._graphs_enabled():
            key += "-eager"
        return key

    def _time_bucket(self, bucket: Bucket) -> float:
        """Median seconds of one bucket's dispatch: graph replays timed by
        CUDA events, or eager forwards (the store off, the CPU) by
        ``perf_counter`` to the synchronized end (one untimed run first)."""
        graph = self._graphs.get((bucket.batch, bucket.seq))
        samples = []
        if graph is not None:
            with torch.inference_mode(), cuda_build.launch_scope(self.device):
                graph.graph.replay()
                for _ in range(COST_REPEATS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    graph.graph.replay()
                    end.record()
                    end.synchronize()
                    samples.append(start.elapsed_time(end) / 1e3)
            graph.count(COST_REPEATS + 1)
            self.device_forwards += COST_REPEATS + 1
        else:
            dev = self._wire_pack(self._dummy_inputs(bucket))
            with torch.inference_mode():
                for i in range(COST_REPEATS + 1):
                    t0 = time.perf_counter()
                    self._score(dev)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    if i:
                        samples.append(time.perf_counter() - t0)
            self.device_forwards += COST_REPEATS + 1
        return statistics.median(samples)

    def _record_program_cost(self, bucket: Bucket) -> Optional[dict]:
        """The bucket's measured cost from the tuning cache, measured and
        recorded when the cache has none; None with the cache off."""
        tuner = autotune.get()
        if not tuner.enabled:
            return None
        key = self._program_cost_key(bucket.batch, bucket.seq)
        cached = tuner.lookup_cost(key)
        if cached is not None and cached.get("est_seconds") is not None:
            return cached
        est = {"est_seconds": self._time_bucket(bucket), "source": "measured"}
        tuner.record_cost(key, est)
        return est

    def _flush_cost(self, seq: int, n: int) -> Optional[float]:
        """Measured step cost of the program a deadline flush of ``n``
        items at ``seq`` would launch, from the tuning cache (None -> the
        batcher falls back to seq order). Memoized: the hook runs under the
        batcher lock and the costs are static after warmup."""
        batch = self.grid.batch_for(seq, n)
        memo_key = (batch, seq)
        if memo_key not in self._flush_cost_memo:
            est = autotune.get().lookup_cost(
                self._program_cost_key(batch, seq))
            self._flush_cost_memo[memo_key] = (
                float(est["est_seconds"])
                if est and est.get("est_seconds") is not None else None)
        return self._flush_cost_memo[memo_key]

    # -- request admission -----------------------------------------------------

    def _chunk_document(self, document: str, question_len: int) -> List:
        """``encode_document`` + ``window_chunks`` for one request, through
        the tier-1 cache when it is on.

        Two entry kinds share the byte budget: the token stream keyed by
        document content hash alone (the same document asked many questions
        tokenizes once), and the window layout keyed additionally by the
        question LENGTH and the grid geometry (the only question-dependence
        ``window_chunks`` has: ``document_len = max_seq - question_len -
        3``)."""
        max_seq = self.grid.max_seq

        def chunk(tokens):
            # spanless target: serving has no gold answer; the chunker only
            # needs geometry
            return window_chunks(
                tokens, ("unknown", -1, -1),
                question_len=question_len, max_seq_len=max_seq,
                doc_stride=self.doc_stride,
            )

        if self._doc_cache is None:
            tokens, _, _ = encode_document(self.tokenizer, document)
            return chunk(tokens)

        doc_hash = content_key(document)
        win_key = (f"win|{doc_hash}|q{question_len}|s{max_seq}"
                   f"|d{self.doc_stride}")
        records = self._doc_cache.get(win_key)
        if records is not None:
            return records
        tok_key = f"tok|{doc_hash}"
        tokens = self._doc_cache.get(tok_key)
        if tokens is None:
            tokens, _, _ = encode_document(self.tokenizer, document)
            self._doc_cache.put(
                tok_key, tokens,
                ENTRY_OVERHEAD + len(tok_key) + len(tokens) * TOKEN_BYTES,
            )
        records = chunk(tokens)
        cost = ENTRY_OVERHEAD + len(win_key) + sum(
            (len(r.token_ids) + 4) * TOKEN_BYTES for r in records
        )
        self._doc_cache.put(win_key, records, cost)
        return records

    def submit(self, question: str, document: str,
               request_id: Optional[str] = None) -> RequestTicket:
        """Chunk + admit one request; returns a completion ticket.

        ``request_id`` overrides the engine-local id (a router forwards its
        own, so the trace spans of one request join across the hop).

        Raises :class:`RequestRejected` (client error),
        :class:`QueueFullError` (backpressure) or :class:`DrainingError`
        (shutting down)."""
        tracer = trace_mod.current()
        if tracer is None:
            return self._submit(question, document, request_id)
        t0 = tracer.now()
        ticket = self._submit(question, document, request_id)
        tracer.complete(
            "admission", t0, tracer.now(), cat="serve",
            args={"request_id": ticket.request_id,
                  "n_chunks": ticket.n_chunks},
        )
        return ticket

    def _submit(self, question: str, document: str,
                request_id: Optional[str] = None) -> RequestTicket:
        if self._closed:
            self.m_rejected_draining.inc()
            raise DrainingError("engine is shut down")
        if not question or not document:
            self.m_rejected_invalid.inc()
            raise RequestRejected("question and document must be non-empty")

        # fast-fail under overload, before paying host-side tokenization;
        # submit_many below stays the authoritative all-or-nothing check.
        # With the chunk-result cache on only the draining arm applies: a
        # fully-hot request needs no queue slot, so refusing on depth would
        # 429 the traffic the cache exists to serve
        try:
            self.batcher.precheck(check_full=self._chunk_cache is None)
        except QueueFullError:
            self.m_rejected_full.inc()
            raise
        except DrainingError:
            self.m_rejected_draining.inc()
            raise

        max_seq = self.grid.max_seq
        enc_q = self.tokenizer.encode(question)[: self.max_question_len]
        if len(enc_q) + 3 >= max_seq:
            self.m_rejected_invalid.inc()
            raise RequestRejected(
                f"question tokenizes to {len(enc_q)} tokens; the largest "
                f"serving bucket ({max_seq}) leaves no room for a document"
            )
        records = self._chunk_document(document, len(enc_q))
        if self._chunk_cache is None and \
                len(records) > self.batcher.queue_size:
            # more chunks than the queue can EVER hold: a 429 would loop
            # forever, so fail it as a client error up front (with the chunk
            # cache on, the bound applies to the misses after
            # classification)
            self.m_rejected_invalid.inc()
            raise RequestRejected(
                f"document chunks into {len(records)} windows, beyond the "
                f"work queue's total capacity ({self.batcher.queue_size}); "
                f"split the document or raise queue_size"
            )

        ticket = RequestTicket(
            n_chunks=len(records), question_len=len(enc_q),
            request_id=request_id)
        rows: List[Tuple[int, int, List[int]]] = []
        for idx, rec in enumerate(records):
            input_ids = assemble_input_ids(
                self._cls_id, self._sep_id, enc_q, rec)
            seq = self.grid.admit(len(input_ids))
            if seq is None:  # unreachable with window_chunks at max_seq
                self.m_rejected_invalid.inc()
                raise RequestRejected(
                    f"chunk of {len(input_ids)} tokens exceeds every "
                    f"serving bucket (max {max_seq})"
                )
            ticket.chunks.append(input_ids)
            rows.append((idx, seq, input_ids))

        cache = self._chunk_cache
        if cache is None:
            works = [
                ChunkWork(seq=seq, payload=_ChunkRef(ticket, idx, input_ids))
                for idx, seq, input_ids in rows
            ]
            try:
                self._admit_works(ticket, works)
            except QueueFullError:
                self.m_rejected_full.inc()
                raise
            except DrainingError:
                self.m_rejected_draining.inc()
                raise
            self.m_requests.inc()
            return ticket

        # tier-2 classify-and-admit, atomic under the cache lock: each chunk
        # is a HIT (row served from the LRU, bypassing the batcher), a
        # WAITER (an identical row is in flight: piggyback) or a LEADER (a
        # leased flight, which reaches the queue or is aborted under this
        # same lock hold, so no thread joins a flight that never launches)
        hits: List[Tuple[int, Dict[str, float]]] = []
        works = []
        leased: List[str] = []
        # hashing reads only immutable inputs: done outside the lock so a
        # many-window document does not serialize other admissions and the
        # batcher's publication
        keyed = [
            (idx, seq, input_ids,
             row_key(self._fingerprint, self.quantize, input_ids))
            for idx, seq, input_ids in rows
        ]
        with cache.lock:
            for idx, seq, input_ids, key in keyed:
                row = cache.get(key)
                if row is not None:
                    hits.append((idx, row))
                    continue
                if cache.join_flight(key, (ticket, idx)):
                    continue
                leased.append(key)
                works.append(ChunkWork(
                    seq=seq,
                    payload=_ChunkRef(ticket, idx, input_ids, key=key)))

            def rollback():
                # drop our waiter registrations first (from other leaders'
                # flights and our own), so every undone join lands in
                # flight_join_rollbacks; then forget the leased flights (no
                # foreign waiter can have joined them: we hold the lock)
                cache.remove_waiters(ticket)
                for key in leased:
                    cache.abort_flight(key)

            if len(works) > self.batcher.queue_size:
                # only misses need queue slots; more of them than the queue
                # can EVER hold is a permanent client error
                rollback()
                self.m_rejected_invalid.inc()
                raise RequestRejected(
                    f"document needs {len(works)} uncached windows, beyond "
                    f"the work queue's total capacity "
                    f"({self.batcher.queue_size}); split the document or "
                    f"raise queue_size"
                )
            if works:
                try:
                    self._admit_works(ticket, works)
                except (QueueFullError, DrainingError) as exc:
                    rollback()
                    if isinstance(exc, QueueFullError):
                        self.m_rejected_full.inc()
                    else:
                        self.m_rejected_draining.inc()
                    raise
        self.m_requests.inc()
        # hit rows reach the ticket only once admission succeeded (a refused
        # request leaves no partial state); a fully-hot request finalizes
        # here on the handler thread and never touches the batcher, the
        # queue or the device
        done = False
        for idx, row in hits:
            if ticket._offer(idx, row):
                done = True
        if done:
            self._finalize(ticket)
        return ticket

    def _admit_works(self, ticket: RequestTicket, works: List) -> None:
        """Queue one request's chunk works: the coalescing queue normally,
        or — when the request windows into at least ``long_scatter_chunks``
        chunks — per-seq slices from ``BucketGrid.scatter_plan`` submitted
        as dedicated batches (``MicroBatcher.submit_group``). Raises what
        ``submit_many`` raises; on rejection nothing is queued."""
        if not self.long_scatter_chunks or \
                len(works) < self.long_scatter_chunks:
            self.batcher.submit_many(works)
            return
        by_seq: Dict[int, List] = {}
        for w in works:
            by_seq.setdefault(w.seq, []).append(w)
        slices = []
        for seq in sorted(by_seq):
            ws = by_seq[seq]
            for batch in self.grid.scatter_plan(seq, len(ws)):
                slices.append(ws[:batch])
                ws = ws[batch:]
        self.batcher.submit_group(slices)
        ticket.scatter_batches = len(slices)
        self.m_longdoc_requests.inc()
        self.m_longdoc_batches.inc(len(slices))

    # -- batch execution (batcher thread) --------------------------------------

    def _run_batch(self, seq: int, works: Sequence[ChunkWork]) -> None:
        n = len(works)
        batch = self.grid.batch_for(seq, n)

        tracer = trace_mod.current()
        t_flush0 = time.perf_counter()
        if tracer is not None:
            # per-chunk queue-wait spans: enqueued_at is a monotonic stamp,
            # so the WAIT is mapped onto the tracer's clock ending now
            waited_now = time.monotonic()
            for w in works:
                if w.enqueued_at:
                    wait = max(0.0, waited_now - w.enqueued_at)
                    tracer.complete(
                        "queue", t_flush0 - wait, t_flush0, cat="serve",
                        args={"request_id": w.payload.ticket.request_id},
                    )

        ids = np.full((n, seq), self._pad_id, np.int32)
        lengths = np.empty((n,), np.int32)
        for i, w in enumerate(works):
            row = w.payload.input_ids
            ids[i, : len(row)] = row
            lengths[i] = len(row)
        if self._wire_ids_only:
            # mask and token types are derived on the device (infer/score.py)
            inputs = {"input_ids": ids}
        else:
            inputs = self._host_arrays(ids, lengths)
        inputs = pad_trailing_batch(inputs, batch)
        t_dev0 = time.perf_counter()
        # the device span ends when the rows are on the host (an owned
        # numpy array), not at the launch
        out = self._dispatch(batch, seq, inputs)[:, :n]
        if tracer is not None:
            # the batch's requests (beyond the JAX package's args): joins
            # the flush and device spans to the other four's request ids
            rids = sorted({str(w.payload.ticket.request_id) for w in works})
            tracer.complete(
                "device", t_dev0, time.perf_counter(), cat="serve",
                args={"seq": seq, "rows": n, "batch": batch,
                      "request_ids": rids},
            )

        self.m_batches.inc()
        self.m_last_batch_rows.set(n)
        self.m_occupancy.observe(n / batch)
        self.m_padding_waste.observe(
            1.0 - float(lengths.sum()) / float(batch * seq))

        decoded = {k: out[i] for i, k in enumerate(OUT_KEYS)}
        cache = self._chunk_cache
        for i, w in enumerate(works):
            ref: _ChunkRef = w.payload
            # a host row of Python floats: a cache entry must never be a
            # view of a device buffer that the next batch overwrites
            row = {k: float(decoded[k][i]) for k in OUT_KEYS}
            offers = [(ref.ticket, ref.idx)]
            if cache is not None and ref.key is not None:
                # publish the leader's row: cache it and release every
                # single-flight waiter with the SAME object, so cached and
                # computed responses are bit-identical by construction
                waiters, _ = cache.complete(
                    ref.key, row,
                    ENTRY_OVERHEAD + len(ref.key) + 8 * len(OUT_KEYS),
                )
                offers.extend(waiters)
            for ticket, idx in offers:
                if ticket._offer(idx, row):
                    self._finalize(ticket)
        if tracer is not None:
            tracer.complete(
                "flush", t_flush0, time.perf_counter(), cat="serve",
                args={"seq": seq, "rows": n, "request_ids": rids},
            )

    def _fail_batch(self, works: Sequence[ChunkWork],
                    exc: BaseException) -> None:
        cache = self._chunk_cache
        failed = set()

        def fail(ticket: RequestTicket) -> None:
            if id(ticket) not in failed:
                failed.add(id(ticket))
                ticket._fail(exc)

        for w in works:
            fail(w.payload.ticket)
            if cache is not None and w.payload.key is not None:
                # single-flight waiters were promised this leader's row;
                # nothing is cached and their tickets fail with it
                for ticket, _ in cache.fail_flight(w.payload.key):
                    fail(ticket)
        self.m_failed.inc(len(failed))

    # -- reduction (predictor parity) ------------------------------------------

    def _finalize(self, ticket: RequestTicket) -> None:
        """Reduce chunk outputs to the per-request best span, applying the
        predictor's validity rules in chunk order (ties resolve to the
        later chunk, exactly as the predictor's sequential stream does)."""
        with trace_mod.span("span_reduce", cat="serve",
                            args={"request_id": ticket.request_id,
                                  "n_chunks": ticket.n_chunks}):
            self._finalize_inner(ticket)

    def _finalize_inner(self, ticket: RequestTicket) -> None:
        best_score = 0.0   # predictor: defaultdict(int) floor of 0
        best: Optional[Tuple[int, dict]] = None
        for idx in range(ticket.n_chunks):
            row = ticket._outputs[idx]
            start_id = int(row["start_ids"])
            end_id = int(row["end_ids"])
            score = row["scores"]
            if start_id > end_id:
                continue
            # answer must not start inside "[CLS] question [SEP]"
            if start_id < ticket.question_len + 2:
                continue
            if best_score > score:
                continue
            best_score = score
            best = (idx, row)

        latency = time.perf_counter() - ticket.created_at
        if best is None:
            result = QAResult(
                answer="", label="unknown", score=0.0, start=-1, end=-1,
                n_chunks=ticket.n_chunks, latency_ms=latency * 1e3,
            )
        else:
            idx, row = best
            start_id = int(row["start_ids"])
            end_id = int(row["end_ids"])
            label = id2labels[int(row["labels"])]
            if label in ("yes", "no"):
                answer = label
            elif label == "unknown":
                answer = ""
            else:
                span = ticket.chunks[idx][start_id: end_id + 1]
                answer = self.tokenizer.decode(span)
            result = QAResult(
                answer=answer, label=label, score=float(row["scores"]),
                start=start_id, end=end_id, n_chunks=ticket.n_chunks,
                latency_ms=latency * 1e3,
            )
        self.m_completed.inc()
        self.m_latency.observe(latency)
        ticket._finish(result)

    # -- metrics / shutdown ----------------------------------------------------

    def cache_stats(self) -> dict:
        """Both tiers' live stats (None for a tier that is off)."""
        out = {"doc": None, "chunk": None}
        if self._doc_cache is not None:
            out["doc"] = self._doc_cache.stats()
        if self._chunk_cache is not None:
            out["chunk"] = self._chunk_cache.stats()
            out["chunk"]["flight_joins"] = self._chunk_cache.flight_joins
            out["chunk"]["flight_join_rollbacks"] = (
                self._chunk_cache.flight_join_rollbacks)
            out["chunk"]["inflight"] = self._chunk_cache.inflight()
        return out

    def _mirror(self, counter, key: str, value: float) -> None:
        """Raise ``counter`` to the monotonic source ``value``. Caller holds
        ``_sync_lock``; rollback corners may briefly move a source stat
        backwards, hence the max."""
        last = self._synced.setdefault(key, 0.0)
        counter.inc(max(0.0, value - last))
        self._synced[key] = max(last, float(value))

    def _sync_metrics(self) -> None:
        """Mirror the caches' own stats, the kernel build counts and the
        kernels' launches into the Prometheus series, under one lock with a
        last-synced snapshot."""
        stats = self.cache_stats()
        builds = cuda_build.build_counts()
        store = aot.get()
        with self._sync_lock:
            for name, s in stats.items():
                if s is None:
                    continue
                mm = self._cache_metrics[name]
                for k in ("hits", "misses", "evictions"):
                    self._mirror(mm[k], f"{name}.{k}", s[k])
                mm["bytes"].set(s["bytes"])
                mm["entries"].set(s["entries"])
            if stats["chunk"] is not None:
                self._mirror(self.m_flight_joins, "flight_joins",
                             stats["chunk"]["flight_joins"])
            self._mirror(self.m_build_hits, "build.hits", builds["hits"])
            self._mirror(self.m_build_misses, "build.misses",
                         builds["misses"])
            self._mirror(self.m_aot_hits, "aot.hits", store.hits)
            self._mirror(self.m_aot_misses, "aot.misses", store.misses)
            loads = list(store.load_times_s)
            for seconds in loads[int(self._synced.get("aot.loads", 0)):]:
                self.m_aot_load.observe(seconds)
            self._synced["aot.loads"] = float(len(loads))
            for kernel, n in kernel_launches().items():
                self.m_kernel_launches.set(kernel, n)

    def render_metrics(self) -> str:
        for gauge, q in ((self.m_latency_p50, 0.5),
                         (self.m_latency_p95, 0.95),
                         (self.m_latency_p99, 0.99)):
            v = self.m_latency.quantile(q)
            if v is not None:
                gauge.set(v)
        self._sync_metrics()
        return self.metrics.render()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admissions, flush every admitted request to completion."""
        self._closed = True
        return self.batcher.drain(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        self._closed = True
        self.batcher.close(timeout=timeout)
        if not self._close_logged:
            # the process's final counts, read after its last batch: what a
            # supervisor that drains this engine learns of its kernel path
            self._close_logged = True
            warm = int((self.warmup_report or {}).get("device_batches", 0))
            logger.info("serving closed after %d device batches (%d warmup); "
                        "kernel launches %s", warm + int(self.m_batches.value),
                        warm, json.dumps(kernel_launches(), sort_keys=True))
