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
  is decoded back to text.

A model from ``quant.quantize_model`` serves int8 (``quantize``, read from
the model): ``/metrics`` then reports ``qa_active_precision`` int8 and the
int8 weights' bytes.

Not ported yet (ROADMAP.md queue 1, 'Serving'): the two serving caches, the
AOT program store, autotuned flush ranking, the memory pre-flight and the
trace spans.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.chunking import assemble_input_ids, encode_document, window_chunks
from ..data.labels import id2labels
from ..infer.score import OUT_KEYS, build_score_fn
from ..quant.quantize import param_bytes
from .batcher import ChunkWork, DrainingError, MicroBatcher, QueueFullError
from .bucketing import Bucket, BucketGrid, pad_trailing_batch
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
    """Batcher payload: which request, which chunk."""

    ticket: "RequestTicket"
    idx: int
    input_ids: List[int]


_REQUEST_IDS = itertools.count(1)


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

        try:
            vocab = len(tokenizer)
        except TypeError:
            vocab = getattr(tokenizer, "vocab_size", 1 << 20)
        self._pad_id = int(tokenizer.pad_token_id)
        self._sep_id = int(tokenizer.sep_token_id)
        self._cls_id = int(tokenizer.cls_token_id)
        self._is_bert = getattr(tokenizer, "model_name", "bert") == "bert"
        self._wire_ids_only = vocab is not None and vocab < 2 ** 16
        self._score = build_score_fn(
            self.model, wire_ids_only=self._wire_ids_only,
            pad_id=self._pad_id, sep_id=self._sep_id, is_bert=self._is_bert,
        )

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
        self.m_weight_bytes.set(param_bytes(model.state_dict()))
        self.m_longdoc_requests = m.counter(
            "qa_longdoc_requests_total",
            "Requests served through the long-request scatter path "
            "(chunk-parallel dedicated batches).")
        self.m_longdoc_batches = m.counter(
            "qa_longdoc_scatter_batches_total",
            "Dedicated scatter batches launched for long requests.")

        self.batcher = MicroBatcher(
            grid,
            self._run_batch,
            max_batch_delay_ms=max_batch_delay_ms,
            queue_size=queue_size,
            fail_fn=self._fail_batch,
            on_depth=self.m_queue_depth.set,
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
        if self._wire_ids_only:
            ids16 = np.asarray(inputs["input_ids"], np.uint16).view(np.int16)
            packed = torch.from_numpy(np.ascontiguousarray(ids16))
        else:
            packed = torch.from_numpy(np.stack([
                np.asarray(inputs["input_ids"], np.int32),
                np.asarray(inputs["attention_mask"], np.int32),
                np.asarray(inputs["token_type_ids"], np.int32),
            ]))
        return packed.to(self.device)

    def run_packed(self, inputs: dict) -> np.ndarray:
        """The scoring forward on one host batch: the ``[6, B]`` f32 array
        in ``OUT_KEYS`` row order."""
        with torch.inference_mode():
            out = self._score(self._wire_pack(inputs))
            return out.cpu().numpy()

    def warmup(self) -> dict:
        """Run every bucket once before traffic: the attention kernel is
        built and loaded, the allocator holds each bucket's blocks, and the
        launch path is hot. Starts the batcher."""
        t0 = time.perf_counter()
        report = {"buckets": [], "bucket_seconds": {},
                  "wire": "ids" if self._wire_ids_only else "3plane",
                  "device": str(self.device), "quantize": self.quantize,
                  "quant_mem_bytes": param_bytes(self.model.state_dict())}
        for bucket in list(self.grid):
            tb = time.perf_counter()
            self.run_packed(self._dummy_inputs(bucket))
            report["bucket_seconds"][str(bucket)] = round(
                time.perf_counter() - tb, 4)
            report["buckets"].append(str(bucket))
        report["warmup_seconds"] = round(time.perf_counter() - t0, 3)
        self.warmup_report = report
        self.batcher.start()
        logger.info("serving warmup: %d buckets on %s in %.1fs.",
                    len(report["buckets"]), self.device,
                    report["warmup_seconds"])
        return report

    # -- request admission -----------------------------------------------------

    def _chunk_document(self, document: str, question_len: int) -> List:
        tokens, _, _ = encode_document(self.tokenizer, document)
        # spanless target: serving has no gold answer; the chunker only
        # needs geometry
        return window_chunks(
            tokens, ("unknown", -1, -1),
            question_len=question_len, max_seq_len=self.grid.max_seq,
            doc_stride=self.doc_stride,
        )

    def submit(self, question: str, document: str,
               request_id: Optional[str] = None) -> RequestTicket:
        """Chunk + admit one request; returns a completion ticket.

        Raises :class:`RequestRejected` (client error),
        :class:`QueueFullError` (backpressure) or :class:`DrainingError`
        (shutting down)."""
        return self._submit(question, document, request_id)

    def _submit(self, question: str, document: str,
                request_id: Optional[str] = None) -> RequestTicket:
        if self._closed:
            self.m_rejected_draining.inc()
            raise DrainingError("engine is shut down")
        if not question or not document:
            self.m_rejected_invalid.inc()
            raise RequestRejected("question and document must be non-empty")

        # fast-fail under overload, before paying host-side tokenization;
        # submit_many below stays the authoritative all-or-nothing check
        try:
            self.batcher.precheck()
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
        if len(records) > self.batcher.queue_size:
            # more chunks than the queue can EVER hold: a 429 would loop
            # forever, so fail it as a client error up front
            self.m_rejected_invalid.inc()
            raise RequestRejected(
                f"document chunks into {len(records)} windows, beyond the "
                f"work queue's total capacity ({self.batcher.queue_size}); "
                f"split the document or raise queue_size"
            )

        ticket = RequestTicket(
            n_chunks=len(records), question_len=len(enc_q),
            request_id=request_id)
        works = []
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
            works.append(ChunkWork(seq=seq,
                                   payload=_ChunkRef(ticket, idx, input_ids)))
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
        out = self.run_packed(inputs)[:, :n]

        self.m_batches.inc()
        self.m_last_batch_rows.set(n)
        self.m_occupancy.observe(n / batch)
        self.m_padding_waste.observe(
            1.0 - float(lengths.sum()) / float(batch * seq))

        decoded = {k: out[i] for i, k in enumerate(OUT_KEYS)}
        for i, w in enumerate(works):
            ref: _ChunkRef = w.payload
            row = {k: float(decoded[k][i]) for k in OUT_KEYS}
            if ref.ticket._offer(ref.idx, row):
                self._finalize(ref.ticket)

    def _fail_batch(self, works: Sequence[ChunkWork],
                    exc: BaseException) -> None:
        failed = set()
        for w in works:
            ticket = w.payload.ticket
            if id(ticket) not in failed:
                failed.add(id(ticket))
                ticket._fail(exc)
        self.m_failed.inc(len(failed))

    # -- reduction (predictor parity) ------------------------------------------

    def _finalize(self, ticket: RequestTicket) -> None:
        """Reduce chunk outputs to the per-request best span, applying the
        predictor's validity rules in chunk order (ties resolve to the
        later chunk, exactly as the predictor's sequential stream does)."""
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

    def render_metrics(self) -> str:
        for gauge, q in ((self.m_latency_p50, 0.5),
                         (self.m_latency_p95, 0.95),
                         (self.m_latency_p99, 0.99)):
            v = self.m_latency.quantile(q)
            if v is not None:
                gauge.set(v)
        return self.metrics.render()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admissions, flush every admitted request to completion."""
        self._closed = True
        return self.batcher.drain(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        self._closed = True
        self.batcher.close(timeout=timeout)
