"""Offline inference predictor (the port of ``ml_recipe_tpu/infer/predictor.py``
without a mesh).

Streams chunk batches from the async :class:`~..data.loader.ListDataloader`,
scores each chunk with the answerability score of arXiv 1901.08634
(``s = max(start) + max(end) - (start[0] + end[0])``) in
``infer.score.score_wire``, the scoring forward the serving engine runs,
and keeps the best-scored candidate per document under the validity rules
(span order, answer not inside the question, not below the document's best
score so far; reference predictor.py:63-75).

The loop, on one device:

- a transfer thread builds host batches (pad-to-max, length buckets
  under a token budget with per-bucket tails, or packed rows), pads the
  trailing partial
  batch by repeating its last row (``serve.bucketing.pad_trailing_batch``),
  packs them in the wire ``infer.score.score_wire`` chose (one int16
  ``[B, L]`` id plane when the tokenizer's vocab fits 16 bits, else
  ``[3, B, L]`` int32) into pinned memory and starts the copy to the
  device with ``non_blocking=True``; at most two batches wait staged;
- the main thread launches the scoring forward of each staged batch, then
  starts ONE non-blocking ``[6, B]`` device->host copy into pinned memory
  and records an event after it; the copy is read two batches later
  (``utils.pipeline.LaggedConsumer``, depth 2), after the event has
  synchronised, so the device always holds the next batches' work while
  the host updates candidates. The reference's ``fetch_every`` (fetches
  grouped to save round trips of a tunnelled device) is not ported: a
  local card has no such round trip.

Sequence packing (``sequence_packing``): chunks first-fit into full
``max_seq_len`` rows (``data/packing.SequencePacker``; it supersedes
``length_buckets``); a batch crosses as ``[4, R, L]`` int32 planes and
``[R, S]`` segment starts, ``infer.score.build_packed_score_fn`` scores
every chunk per segment, and the ``[8, R, S]`` output is read out per chunk
through the host's segment mask (row-major segment order). With
``pack_splitting='fill'`` a chunk that fits no open row is split into
fragments, whose outputs ``infer.score.FragmentMerger`` re-merges into the
chunk's before candidate tracking, so everything after it sees whole
chunks. Fragments attend only within themselves, so a split chunk's logits
approximate the unsplit chunk's.

Every copy and launch goes on the device's current stream, so a forward is
ordered after its input's copy. A fresh pinned buffer per batch is never
reused before its copy completes (PyTorch's caching host allocator holds
it until the copy's stream passes it).
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.bucketing import (
    TokenBudgetBucketer,
    bucket_batch_sizes,
    parse_length_buckets,
)
from ..data.collate import rebind_collate_seq
from ..data.labels import id2labels
from ..data.loader import ListDataloader
from ..data.packing import (
    DEFAULT_MAX_SEGMENTS,
    DEFAULT_MIN_FRAGMENT,
    ChunkFragment,
    SequencePacker,
    collate_packed,
    parse_pack_splitting,
    parse_sequence_packing,
)
from ..serve.bucketing import pad_trailing_batch
from ..utils.pipeline import LaggedConsumer
from .score import (
    OUT_KEYS,
    PACKED_OUT_KEYS,
    FragmentMerger,
    build_packed_score_fn,
    pack_wire,
    score_wire,
)

logger = logging.getLogger(__name__)


class WorkerShutdownError(RuntimeError):
    """The transfer worker was still alive after the join timeout: something
    it blocks on (a device copy, the upstream loader) is wedged. Raised so
    the hang shows at the call site instead of leaking a thread."""


def _ensure_worker_stopped(worker: threading.Thread, *,
                           timeout: float = 10.0) -> None:
    """Join ``worker``; on timeout, log its stack and raise, unless an
    exception is already propagating (then only warn: the original error
    is the story)."""
    worker.join(timeout=timeout)
    if not worker.is_alive():
        return
    frame = sys._current_frames().get(worker.ident)
    stack = ("".join(traceback.format_stack(frame)) if frame is not None
             else "<no frame available>")
    logger.warning(f"Worker thread {worker.name!r} still alive {timeout:g}s "
                   f"after shutdown was requested; its stack:\n{stack}")
    if sys.exc_info()[0] is None:
        raise WorkerShutdownError(
            f"worker thread {worker.name!r} failed to stop within "
            f"{timeout:g}s (stack logged above)")


@dataclass
class PredictorCandidate:
    start_id: int
    end_id: int
    start_reg: float
    end_reg: float
    label: int


def _start_host_copy(t: torch.Tensor, pin: bool):
    """``(host tensor, event)``: a non-blocking copy of ``t`` into pinned
    host memory and an event recorded after it (None off CUDA)."""
    if not pin:
        return t.to("cpu"), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _read_host_copy(host: torch.Tensor, event) -> np.ndarray:
    if event is not None:
        event.synchronize()
    return host.numpy()


class Predictor:
    def __init__(
        self,
        model,
        *,
        collate_fun=None,
        batch_size: int = 256,
        n_jobs: int = 16,
        buffer_size: int = 4096,
        limit: Optional[int] = None,
        length_buckets: Optional[list] = None,
        sequence_packing=False,
        pack_max_segments: int = DEFAULT_MAX_SEGMENTS,
        pack_splitting="off",
        pack_min_fragment: int = DEFAULT_MIN_FRAGMENT,
    ):
        self.model = model
        self.device = model.device

        self.scores: dict = defaultdict(int)
        self.candidates: dict = {}
        self.items: dict = {}

        self.batch_size = batch_size
        self.n_jobs = n_jobs
        self.collate_fun = collate_fun
        self.buffer_size = buffer_size
        self.limit = limit
        self.dump = None
        # the last run's counts and host times (see __call__)
        self.stats: dict = {}

        # the wire of a tokenizer-bound collate_fun: the ids-only plane
        # when its vocab fits 16 bits (infer/score.py), else three planes
        tok = getattr(self.collate_fun, "keywords", {}).get("tokenizer")
        self._wire_ids_only, self._score = score_wire(model, tok)
        self._pad_id = int(tok.pad_token_id) if self._wire_ids_only else None

        # sequence packing (module docstring); the cuts of the last run's
        # splitting packer in pack_split_count
        self._packing = parse_sequence_packing(sequence_packing)
        self._pack_max_segments = max(1, int(pack_max_segments))
        self._pack_splitting = parse_pack_splitting(pack_splitting)
        self._pack_min_fragment = max(1, int(pack_min_fragment))
        self.pack_split_count = 0
        if self._packing:
            kw = getattr(self.collate_fun, "keywords", {}) or {}
            if kw.get("tokenizer") is None:
                raise ValueError("sequence_packing needs a tokenizer-bound "
                                 "collate_fun (init_collate_fun)")
            if kw.get("max_seq_len") is None:
                raise ValueError("sequence_packing needs the collate's static "
                                 "max_seq_len (init_collate_fun(..., "
                                 "max_seq_len=...))")
            self._score_packed = build_packed_score_fn(model)
            if parse_length_buckets(length_buckets, kw["max_seq_len"]):
                logger.info("sequence_packing supersedes length_buckets for "
                            "offline eval (packed rows are already nearly "
                            "pad-free).")
                length_buckets = None

        # length-bucketed chunk batching (a --length_buckets spec or grid):
        # chunks pad to the smallest bucket seq that fits them; per-bucket
        # batch sizes hold the token budget batch_size * max_seq constant.
        # None or 'off' = pad-to-max.
        max_len = getattr(self.collate_fun, "keywords", {}).get("max_seq_len")
        grid = (parse_length_buckets(length_buckets, max_len)
                if length_buckets else None)
        self._seq_grid = grid
        self._bucket_batches = None
        if grid:
            self._bucket_batches = bucket_batch_sizes(
                grid, self.batch_size * grid[-1], multiple=1)
            logger.info(f"Predictor length buckets: grid {grid}, per-bucket "
                        f"batches {self._bucket_batches}.")

        logger.info(f"Predictor on {self.device}. Batch size: "
                    f"{self.batch_size}. #workers: {self.n_jobs}. Buffer "
                    f"size: {self.buffer_size}. Set limit: {self.limit}.")

    @staticmethod
    def _check_ids_wire(ids, attention_mask, pad_id) -> None:
        """The device-side mask is ``(ids != pad_id)``; if a valid position
        ever carried the pad id (literal "[PAD]" text surviving
        tokenization), that derivation would diverge from the collate's
        row-length mask: fail loudly instead."""
        if not np.array_equal(ids != pad_id, np.asarray(attention_mask, bool)):
            raise ValueError(
                "ids-only wire precondition violated: pad_token_id occurs "
                "at an attended position (or a padded position carries a "
                "non-pad id); construct the Predictor without a tokenizer-"
                "bound collate_fun to use the 3-plane wire")

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory() if self.device.type == "cuda" else t

    def _wire(self, inputs: dict) -> torch.Tensor:
        """Host batch -> a CPU tensor in the wire format (pinned on CUDA)."""
        if self._wire_ids_only:
            self._check_ids_wire(np.asarray(inputs["input_ids"]),
                                 inputs["attention_mask"], self._pad_id)
        return self._pinned(pack_wire(inputs, self._wire_ids_only))

    # -- candidate tracking (predictor.py:63-87) -------------------------------

    def _is_valid(self, item, score, start_id, end_id) -> bool:
        assert score >= 0

        if start_id > end_id:
            return False

        # answer must not start inside "[CLS] question [SEP]"
        if start_id < item.question_len + 2:
            return False

        if self.scores[item.item_id] > score:
            return False

        return True

    def _update_candidates(self, out: dict, items) -> None:
        for i, item in enumerate(items):
            score = float(out["scores"][i])
            start_id = int(out["start_ids"][i])
            end_id = int(out["end_ids"][i])
            if self._is_valid(item, score, start_id, end_id):
                self.scores[item.item_id] = score
                self.candidates[item.item_id] = PredictorCandidate(
                    start_id=start_id,
                    end_id=end_id,
                    start_reg=float(out["start_regs"][i]),
                    end_reg=float(out["end_regs"][i]),
                    label=int(out["labels"][i]),
                )
                self.items[item.item_id] = item

    # -- main loop (predictor.py:89-131) ---------------------------------------

    def __call__(self, dataset, *, save_dump: bool = False):
        """Score every chunk of ``dataset`` (a ``ChunkDataset``) and keep one
        candidate per document. ``self.stats`` then holds the run's
        ``batches``, ``chunks`` and ``documents`` scored (packed: also its
        ``segments``, fragments included), ``candidates``,
        ``seconds``, ``first_batch_seconds`` (until the first batch was
        staged: the loader's first documents) and the transfer thread's
        median host milliseconds per batch (``host_ms_per_batch``:
        building, padding, packing and staging one batch, the loader's
        waits included)."""
        bucketed = self._seq_grid is not None
        packing = self._packing
        pin = self.device.type == "cuda"
        self.pack_split_count = 0
        packer = None
        async_dataset = ListDataloader(
            dataset,
            batch_size=self.batch_size,
            n_jobs=self.n_jobs,
            # bucketed, packed: stream raw chunk lists and collate below
            collate_fun=None if (bucketed or packing) else self.collate_fun,
            buffer_size=self.buffer_size,
            shuffle=True,
        )
        if save_dump:
            self.dump = []

        seen: set = set()
        merger = (FragmentMerger() if packing and self._pack_splitting != "off"
                  else None)

        def process(host_out, n_valid, items) -> None:
            if packing:
                out, items = unpack(host_out, n_valid, items)
            else:
                out = {k: host_out[i, :n_valid] for i, k in enumerate(OUT_KEYS)}
            seen.update(item.item_id for item in items)
            self._update_candidates(out, items)
            if save_dump:
                self.dump.append((out["scores"], out["start_ids"],
                                  out["end_ids"], out["labels"], items))

        def unpack(host_out, seg_mask, entries):
            """``[8, R, S]`` per-segment outputs -> per-chunk vectors through
            the packing map (row-major segment order over the mask), split
            chunks re-merged once all their fragments are in."""
            m = np.asarray(seg_mask).reshape(-1) > 0
            out = {k: host_out[i].reshape(-1)[m]
                   for i, k in enumerate(PACKED_OUT_KEYS)}
            assert len(entries) == int(m.sum()), (len(entries), int(m.sum()))
            if merger is None:
                return out, entries
            done_items, done = [], {k: [] for k in OUT_KEYS}
            for j, entry in enumerate(entries):
                fields = {k: out[k][j] for k in PACKED_OUT_KEYS}
                for item, merged in merger.add(entry, fields):
                    done_items.append(item)
                    for k in OUT_KEYS:
                        done[k].append(merged[k])
            return ({k: np.asarray(v, dtype=np.float32)
                     for k, v in done.items()}, done_items)

        lag = LaggedConsumer(
            lambda copy, n_valid, items: process(_read_host_copy(*copy),
                                                 n_valid, items), depth=2)

        stop = threading.Event()
        stage: queue.Queue = queue.Queue(maxsize=2)
        _DONE = object()
        host_ms: list = []

        def host_batches():
            """Collated, padded host batches as ``(inputs, n_valid, items)``:
            pad-to-max (the loader collated at the global max), length
            buckets (each bucket collates at its seq when its token-budget
            batch fills; the per-bucket tails flush padded), or packed rows
            (``inputs`` the ``(planes, segment_starts)`` pair, ``n_valid``
            the ``[R, S]`` segment mask, ``items`` the rows' entries in
            row-major segment order)."""
            nonlocal packer
            if packing:
                tok = self.collate_fun.keywords["tokenizer"]
                max_len = int(self.collate_fun.keywords["max_seq_len"])
                packer = SequencePacker(
                    max_len, max_segments=self._pack_max_segments,
                    splitting=self._pack_splitting,
                    min_fragment=self._pack_min_fragment)
                pending: list = []

                def packed_batch(rows):
                    real = len(rows)
                    rows = rows + [rows[-1]] * (self.batch_size - real)
                    inputs, seg_mask = collate_packed(
                        rows, tok, max_seq_len=max_len,
                        max_segments=self._pack_max_segments,
                        with_labels=False)
                    seg_mask[real:] = 0   # pad rows: no phantom chunks
                    planes = np.stack([inputs[k] for k in (
                        "input_ids", "token_type_ids", "segment_ids",
                        "position_ids")])
                    entries = [e for row in rows[:real] for e in row]
                    return ((planes, inputs["segment_starts"]), seg_mask,
                            entries)

                for group in async_dataset:   # raw chunk lists
                    for chunk in group:
                        pending.extend(packer.add(
                            chunk, len(chunk.input_ids),
                            (chunk.start_id, chunk.end_id)))
                        while len(pending) >= self.batch_size:
                            yield packed_batch(pending[:self.batch_size])
                            del pending[:self.batch_size]
                pending.extend(packer.flush())
                while pending:
                    yield packed_batch(pending[:self.batch_size])
                    del pending[:self.batch_size]
                return
            if not bucketed:
                for inputs, _labels, items in async_dataset:
                    n_valid = len(items)
                    if n_valid < self.batch_size:
                        inputs = pad_trailing_batch(inputs, self.batch_size)
                    yield inputs, n_valid, items
                return
            bucketer = TokenBudgetBucketer(self._seq_grid, self._bucket_batches)
            collates = {seq: rebind_collate_seq(self.collate_fun, seq)
                        for seq in self._seq_grid}

            def collated(seq, chunk_items):
                inputs, _labels, chunk_items = collates[seq](chunk_items)
                n_valid = len(chunk_items)
                if n_valid < self._bucket_batches[seq]:
                    inputs = pad_trailing_batch(inputs,
                                                self._bucket_batches[seq])
                return inputs, n_valid, chunk_items

            for group in async_dataset:  # raw chunk lists
                for chunk in group:
                    emitted = bucketer.add(len(chunk.input_ids), chunk)
                    if emitted is not None:
                        yield collated(*emitted)
            for seq, tail in bucketer.flush():
                yield collated(seq, tail)

        def transfer_worker() -> None:
            batches = host_batches()
            try:
                batch_i = 0
                while True:
                    t0 = time.perf_counter()
                    got = next(batches, None)
                    if got is None:
                        break
                    inputs, n_valid, items = got
                    if packing:
                        dev_inputs = tuple(
                            self._pinned(torch.from_numpy(x)).to(
                                self.device, non_blocking=pin)
                            for x in inputs)
                    else:
                        dev_inputs = self._wire(inputs).to(self.device,
                                                           non_blocking=pin)
                    host_ms.append(1e3 * (time.perf_counter() - t0))
                    payload = (dev_inputs, n_valid, items)
                    while not stop.is_set():
                        try:
                            stage.put(payload, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                    if self.limit is not None and batch_i >= self.limit:
                        break
                    batch_i += 1
            except BaseException as exc:  # propagate into the main loop
                stage.put(exc)
            else:
                stage.put(_DONE)
            finally:
                batches.close()   # stops the loader's producer

        worker = threading.Thread(target=transfer_worker,
                                  name="predictor-transfer", daemon=True)
        t_start = time.perf_counter()
        t_first = None
        n_batches = n_chunks = n_segments = 0
        worker.start()
        try:
            with torch.inference_mode():
                while True:
                    got = stage.get()
                    if got is _DONE:
                        break
                    if isinstance(got, BaseException):
                        raise got
                    dev_inputs, n_valid, items = got
                    if t_first is None:
                        t_first = time.perf_counter() - t_start
                    n_batches += 1
                    if packing:
                        out = self._score_packed(*dev_inputs)
                        n_segments += len(items)
                        # a chunk counts once: whole, or by its head fragment
                        n_chunks += sum(not isinstance(e, ChunkFragment)
                                        or e.index == 0 for e in items)
                    else:
                        out = self._score(dev_inputs)
                        n_chunks += n_valid
                    lag.feed(_start_host_copy(out, pin), n_valid, items)
                lag.flush()
        finally:
            stop.set()
            while True:  # unblock a worker waiting on a full queue
                try:
                    stage.get_nowait()
                except queue.Empty:
                    break
            _ensure_worker_stopped(worker, timeout=10)

        if packer is not None:
            self.pack_split_count = packer.split_count
            if self.pack_split_count:
                logger.info("Sequence packing split %d chunk(s) into "
                            "hole-filling fragments (re-merged to per-chunk "
                            "outputs).", self.pack_split_count)
        if merger is not None and merger.pending:
            # every fragment is scored (eval pads, never drops) unless
            # --limit stopped the stream: a leftover chunk is dropped
            logger.warning("Fragment re-merge finished with %d incomplete "
                           "chunk(s); their candidates were dropped.",
                           merger.pending)
        self.stats = dict(
            segments=n_segments,
            batches=n_batches, chunks=n_chunks,
            documents=len(seen),
            candidates=len(self.candidates),
            seconds=time.perf_counter() - t_start,
            first_batch_seconds=t_first or 0.0,
            host_ms_per_batch=(float(np.median(host_ms)) if host_ms else 0.0),
        )
        return self

    def show_predictions(self, *, n_docs: Optional[int] = None) -> None:
        for doc_i, doc_id in enumerate(self.scores.keys()):
            if n_docs is not None and doc_i >= n_docs:
                break

            doc = self.items[doc_id]
            candidate = self.candidates[doc_id]

            logger.info(f"Text: {doc.true_text}")
            logger.info(f"Question: {doc.true_question}")
            logger.info(f"True label: {id2labels[doc.true_label]}. "
                        f"Pred label: {id2labels[candidate.label]}.")
