"""Sequence packing (the port of ``ml_recipe_tpu/data/packing.py``).

Short chunks are concatenated into fixed ``max_seq_len`` rows, so nearly
every token is a real token and every step has one shape:

- :class:`SequencePacker`: greedy first-fit binning of chunks into rows in
  the epoch order the samplers draw; a row closes when it fills exactly or
  holds ``max_segments`` segments, and when no open row fits and the window
  of open rows is full, the fullest row is emitted. ``splitting='fill'``
  (``--pack_splitting``) splits a chunk that fits no open row at a
  label-safe token boundary (``chunking.label_safe_cut``) and drops the
  head :class:`ChunkFragment` into the largest residual hole;
- :func:`collate_packed`: the ``input_ids`` / ``attention_mask`` /
  ``token_type_ids`` planes plus ``segment_ids`` (1..S per segment, 0 on
  pad: the attention kernels' block-diagonal mask operand),
  ``position_ids`` (0.. within each segment, a fragment continuing at its
  token offset), ``segment_starts`` (each segment's first row index) and
  per-segment labels ``[rows, S]`` with row-absolute spans and a
  ``segment_mask``;
- :class:`PackedDataLoader`: the train and eval loader, with the epoch
  order kept, drop-last (train) or pad-last (eval) rows, token accounting
  (``epoch_stats``) and the LR-schedule step plan
  (:meth:`PackedDataLoader.planned_epoch_steps`).

Packing and bucketing are content-dependent: which items form which batch
depends on the chunk lengths, which every process must agree on for the
step shapes to stay in lockstep. The shared length oracle makes every item
read a pure function of ``(epoch, index)``: a dataset that draws its chunks
from an ``rng`` has it swapped for one seeded by ``(ORACLE_SEED, epoch,
index)`` for the read, so every process materialises the same items and
derives the same epoch plan from the deterministic epoch ordering, and
then collates only its row slice of each planned global batch. No
traffic between processes is needed.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .chunking import label_safe_cut
from .loader import read_with_retry

logger = logging.getLogger(__name__)

# seed of the shared length oracle (the JAX package's ORACLE_SEED)
ORACLE_SEED = 0x0AC1E

# LR-schedule planning reads item LENGTHS, which means materializing items;
# past this many items the planner simulates on the epoch ordering's prefix
# and scales the step count
PLAN_SAMPLE_ITEMS = 4096

# the dataset.rng swap is process-global state: oracle reads of rng-carrying
# datasets are serialized (rng-less datasets read fully parallel)
_ORACLE_LOCK = threading.Lock()


def oracle_read(dataset, index: int, *, retries: int = 3, epoch: int = 0):
    """One item read as a pure function of ``(epoch, index)``: a dataset's
    chunk-sampling ``rng``, when it has one, is swapped for
    ``default_rng(SeedSequence([ORACLE_SEED, epoch, index]))`` for the
    read (fresh chunks each epoch, the same on every process and every
    repeat); the training draw stream is untouched."""
    if getattr(dataset, "rng", None) is None:
        return read_with_retry(dataset, int(index), retries=retries)
    with _ORACLE_LOCK:
        saved = dataset.rng
        dataset.rng = np.random.default_rng(
            np.random.SeedSequence([ORACLE_SEED, int(epoch), int(index)]))
        try:
            return read_with_retry(dataset, int(index), retries=retries)
        finally:
            dataset.rng = saved


def _oracle_epoch_key(dataset, epoch: int) -> int:
    """The epoch part of an oracle cache key: rng-less datasets give the
    same item every epoch (key 0, cached once for the run), stochastic-chunk
    datasets draw per epoch."""
    return int(epoch) if getattr(dataset, "rng", None) is not None else 0


def _item_meta(item) -> Tuple[int, int, int]:
    """The cached planning meta of one item: ``(length, start_id,
    end_id)``."""
    return (len(item.input_ids), int(getattr(item, "start_id", -1)),
            int(getattr(item, "end_id", -1)))


def oracle_epoch_meta(dataset, indices, *, cache: Dict[tuple, tuple],
                      n_jobs: int, read_retries: int,
                      epoch: int = 0) -> List[tuple]:
    """Item metas for ``indices`` under the oracle, each unique ``(epoch
    key, index)`` read at most once (``cache`` persists across epochs and
    is exact: oracle reads are reproducible)."""
    ek = _oracle_epoch_key(dataset, epoch)
    missing = sorted({int(i) for i in indices if (ek, int(i)) not in cache})
    if missing:
        with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as pool:
            for idx, item in zip(missing, pool.map(
                    lambda i: oracle_read(dataset, i, retries=read_retries,
                                          epoch=ek), missing)):
                cache[(ek, idx)] = _item_meta(item)
    return [cache[(ek, int(i))] for i in indices]


def oracle_epoch_lengths(dataset, indices, *, cache: Dict[tuple, tuple],
                         n_jobs: int, read_retries: int,
                         epoch: int = 0) -> List[int]:
    """Item lengths under the oracle (the bucket planner's column of
    :func:`oracle_epoch_meta`)."""
    return [meta[0] for meta in oracle_epoch_meta(
        dataset, indices, cache=cache, n_jobs=n_jobs,
        read_retries=read_retries, epoch=epoch)]


def epoch_item_meta(dataset, sampler, epoch, *, cache: dict, n_jobs: int,
                    read_retries: int, max_items: Optional[int] = None,
                    oracle: bool = False) -> List[tuple]:
    """Item metas in one epoch's order (the first ``max_items`` when
    given), each unique index read at most once. Without the oracle the
    dataset's ``rng`` is swapped for a throwaway during the reads, so
    planning never perturbs the training draws, and a stochastic-chunk
    item's meta is one draw, an estimate; ``oracle=True`` reads through
    :func:`oracle_read`: exact and the same on every process, which
    multi-process planning needs (a step count that differed across
    processes would differ the LR schedule itself)."""
    indices = [int(i) for i in sampler.epoch_indices(epoch)]
    if max_items is not None:
        indices = indices[:max_items]
    if oracle:
        return oracle_epoch_meta(dataset, indices, cache=cache, n_jobs=n_jobs,
                                 read_retries=read_retries, epoch=epoch)
    missing = sorted({i for i in indices if i not in cache})
    if missing:
        saved_rng = getattr(dataset, "rng", None)
        if saved_rng is not None:
            dataset.rng = np.random.default_rng(0)
        try:
            with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as pool:
                for idx, item in zip(missing, pool.map(
                        lambda i: read_with_retry(dataset, i,
                                                  retries=read_retries),
                        missing)):
                    cache[idx] = _item_meta(item)
        finally:
            if saved_rng is not None:
                dataset.rng = saved_rng
    return [cache[i] for i in indices]


def epoch_item_lengths(dataset, sampler, epoch, *, cache: dict, n_jobs: int,
                       read_retries: int, max_items: Optional[int] = None,
                       oracle: bool = False) -> List[int]:
    """Item lengths in one epoch's order (:func:`epoch_item_meta`'s length
    column)."""
    return [meta[0] for meta in epoch_item_meta(
        dataset, sampler, epoch, cache=cache, n_jobs=n_jobs,
        read_retries=read_retries, max_items=max_items, oracle=oracle)]


def plan_scaled_count(dataset, sampler, epoch, *, cache: dict, n_jobs: int,
                      read_retries: int, simulate,
                      oracle: bool = False, meta: bool = False) -> int:
    """The LR-schedule planning skeleton: read the epoch's item metas (the
    first ``PLAN_SAMPLE_ITEMS`` of its ordering), run ``simulate(lengths)
    -> count`` (``simulate(metas)`` with ``meta=True``: the splitting
    packer's cuts need the spans), and scale the count to the whole epoch
    when only a prefix was read. Tail handling stays with the caller (it
    must not be scaled)."""
    n_total = len(sampler.epoch_indices(epoch))
    metas = epoch_item_meta(
        dataset, sampler, epoch, cache=cache, n_jobs=n_jobs,
        read_retries=read_retries, max_items=PLAN_SAMPLE_ITEMS, oracle=oracle)
    count = simulate(metas if meta else [m[0] for m in metas])
    if metas and n_total > len(metas):
        count = int(round(count * n_total / len(metas)))
    return count


# the per-row segment cap: the static S of the [rows, S] label planes and
# of the model's per-segment head outputs
DEFAULT_MAX_SEGMENTS = 8

# the packer's window of open rows: more open rows pack tighter (more
# chances to fill a gap) and emit later
DEFAULT_OPEN_ROWS = 32

# the splitting packer's least fragment, head or tail, in tokens
DEFAULT_MIN_FRAGMENT = 32

# the packed loader's retries of a failing item read
READ_RETRIES = 3


def parse_sequence_packing(spec) -> bool:
    """``--sequence_packing``: truthy strings and bools -> on; ``off``,
    ``none``, ``0``, ``false``, the empty string, None and False -> off."""
    if spec is None or spec is False:
        return False
    if spec is True:
        return True
    return str(spec).strip().lower() not in ("off", "none", "0", "false", "")


def parse_pack_splitting(spec) -> str:
    """``--pack_splitting``: ``off`` (the non-splitting packer) or ``fill``
    (split pending chunks at label-safe token boundaries to fill residual
    holes); truthy bools and strings mean ``fill``."""
    if spec is None or spec is False:
        return "off"
    if spec is True:
        return "fill"
    s = str(spec).strip().lower()
    if s in ("off", "none", "0", "false", ""):
        return "off"
    if s in ("fill", "on", "1", "true", "yes"):
        return "fill"
    raise ValueError(f"--pack_splitting must be off|fill, got {spec!r}")


@dataclasses.dataclass
class ChunkFragment:
    """One fragment of a split chunk, placed in a pack row in place of the
    whole item. ``item`` is the packer's payload (an item on the live path,
    an ``(index, length)`` pair in the oracle plan, None in a simulation);
    ``offset``/``length`` slice the parent chunk's tokens; ``(chunk_id,
    index, count)`` say where it belongs for the re-merge (``count`` is set
    once the whole chunk is placed); ``keep_labels`` marks the one fragment
    that carries the parent's labels, the one holding the gold span (the
    head for spanless chunks): its siblings collate with ``segment_mask``
    0, so a split chunk counts once."""

    item: Any
    chunk_id: int
    offset: int
    length: int
    index: int
    count: int = 0
    keep_labels: bool = False
    chunk_len: int = 0


def _entry_tokens(entry) -> int:
    """Tokens of one pack-row entry (a whole item or a fragment)."""
    if isinstance(entry, ChunkFragment):
        return entry.length
    return len(entry.input_ids)


def _entry_is_example(entry) -> bool:
    """Whether the entry carries labels: every whole item, and of a split
    chunk only its ``keep_labels`` fragment."""
    return entry.keep_labels if isinstance(entry, ChunkFragment) else True


def _item_span(item) -> Optional[Tuple[int, int]]:
    """The gold span's token indices (inclusive) of an item, or None."""
    start = int(getattr(item, "start_id", -1))
    end = int(getattr(item, "end_id", -1))
    if start < 0 or end < start:
        return None
    return start, end


def _meta_span(meta) -> Optional[Tuple[int, int]]:
    """The span of one planning meta ``(length, start_id, end_id)``."""
    _length, start, end = meta
    if start < 0 or end < start:
        return None
    return start, end


class SequencePacker:
    """Greedy first-fit packer. Items arrive in epoch order; each goes into
    the first open row with room and a free segment slot. A row that fills
    exactly or reaches ``max_segments`` closes at once; when no open row
    fits and ``open_rows`` rows are open, the fullest one (the oldest of
    ties) is emitted. A pure function of the item sequence.

    ``splitting='fill'``: an item that fits no open row whole is split at a
    label-safe cut (never inside the gold ``span``); its head fragment goes
    into the open row with the largest hole, and the tail goes through the
    same placement again (it may fit whole, split again or open a row).
    Still a pure function of the ``(item, length, span)`` sequence, so a
    simulation and every process replay the same plan."""

    def __init__(self, max_seq_len: int, *,
                 max_segments: int = DEFAULT_MAX_SEGMENTS,
                 open_rows: int = DEFAULT_OPEN_ROWS,
                 splitting: str = "off",
                 min_fragment: int = DEFAULT_MIN_FRAGMENT):
        self.max_seq_len = int(max_seq_len)
        self.max_segments = max(1, int(max_segments))
        self.open_rows = max(1, int(open_rows))
        self.splitting = parse_pack_splitting(splitting)
        self.min_fragment = max(1, int(min_fragment))
        self.split_count = 0   # cuts made
        self._open: List[tuple] = []   # (entries, used tokens)
        self._next_chunk_id = 0
        self._placing: List[ChunkFragment] = []   # the current add's fragments

    def add(self, item, length: int, span=None) -> List[list]:
        """Place one item; returns the rows this placement closed, each a
        list of entries (items and :class:`ChunkFragment`\\ s) in row
        order. ``span``, the item's gold ``(start, end)`` or None, steers
        only the splitting packer's cuts."""
        length = int(length)
        if length > self.max_seq_len:
            raise ValueError(
                f"item of length {length} exceeds max_seq_len "
                f"{self.max_seq_len} (the collate would reject it too)")
        done: List[list] = []
        self._place(item, length, self._norm_span(span, length), done)
        if self._placing:
            # the chunk is placed whole: every fragment learns the count
            # (rows may be emitted out of placement order)
            for frag in self._placing:
                frag.count = len(self._placing)
            self._placing = []
        return done

    @staticmethod
    def _norm_span(span, length: int):
        if span is None:
            return None
        start, end = int(span[0]), int(span[1])
        if not (0 <= start <= end < length):
            return None
        return start, end

    def _place(self, entry, length: int, span, done: List[list]) -> None:
        """First fit of the whole entry, else a hole-filling split, else
        the forced emit and a new row."""
        for i, (items, used) in enumerate(self._open):
            if used + length <= self.max_seq_len and len(items) < self.max_segments:
                items.append(entry)
                used += length
                if used == self.max_seq_len or len(items) == self.max_segments:
                    done.append(items)
                    del self._open[i]
                else:
                    self._open[i] = (items, used)
                return
        if (self.splitting == "fill" and length >= 2 * self.min_fragment
                and self._split_place(entry, length, span, done)):
            return
        if len(self._open) >= self.open_rows:
            fullest = max(range(len(self._open)),
                          key=lambda i: self._open[i][1])
            done.append(self._open.pop(fullest)[0])
        self._open.append(([entry], length))

    def _split_place(self, entry, length: int, span, done: List[list]) -> bool:
        """Split ``entry`` so its head fills an open row's hole, trying the
        rows largest hole first (the oldest of ties); False when no row
        admits a legal cut."""
        order = sorted(range(len(self._open)),
                       key=lambda i: (self._open[i][1], i))
        for i in order:
            items, used = self._open[i]
            hole = self.max_seq_len - used
            if hole < self.min_fragment or len(items) >= self.max_segments:
                continue
            cut = label_safe_cut(length, span, hole, self.min_fragment)
            if cut is None:
                continue
            head, tail, tail_span = self._cut(entry, length, span, cut)
            items.append(head)
            used += cut
            self.split_count += 1
            if used == self.max_seq_len or len(items) == self.max_segments:
                done.append(items)
                del self._open[i]
            else:
                self._open[i] = (items, used)
            self._place(tail, tail.length, tail_span, done)
            return True
        return False

    def _cut(self, entry, length: int, span, cut: int):
        """``entry`` cut at ``cut`` into head and tail fragments, and the
        tail-relative span. The fragment holding the span keeps the labels
        (the head of a spanless chunk); a re-split tail passes
        ``keep_labels`` on, so one fragment of a chunk carries them."""
        if isinstance(entry, ChunkFragment):
            parent, chunk_id = entry.item, entry.chunk_id
            base_offset, base_index = entry.offset, entry.index
            carried, chunk_len = entry.keep_labels, entry.chunk_len
            self._placing.remove(entry)
        else:
            parent, chunk_id = entry, self._next_chunk_id
            self._next_chunk_id += 1
            base_offset, base_index = 0, 0
            carried, chunk_len = True, length
        head_keeps = tail_keeps = False
        tail_span = None
        if carried:
            if span is None or span[1] < cut:
                head_keeps = True
            else:   # label_safe_cut puts the whole span in the tail
                tail_keeps = True
                tail_span = (span[0] - cut, span[1] - cut)
        head = ChunkFragment(item=parent, chunk_id=chunk_id,
                             offset=base_offset, length=cut, index=base_index,
                             keep_labels=head_keeps, chunk_len=chunk_len)
        tail = ChunkFragment(item=parent, chunk_id=chunk_id,
                             offset=base_offset + cut, length=length - cut,
                             index=base_index + 1, keep_labels=tail_keeps,
                             chunk_len=chunk_len)
        self._placing.extend([head, tail])
        return head, tail, tail_span

    def flush(self) -> List[list]:
        """Emit every open row (the epoch's end), oldest first."""
        done = [items for items, _ in self._open]
        self._open = []
        return done


class PackedBatch(NamedTuple):
    """One collated packed batch: ``rows`` rows of ``seq`` tokens holding
    ``segments`` real segments (examples). Pad rows (the eval tail) repeat
    the last real row with ``segment_mask`` 0. ``provenance`` (under
    ``--pack_splitting fill``) holds the per-segment ``chunk_id`` /
    ``fragment_index`` / ``token_offset`` planes, host metadata the model
    never reads."""

    inputs: dict
    labels: dict
    rows: int
    segments: int
    seq: int
    provenance: Optional[dict] = None


def collate_packed(row_items: Sequence[list], tokenizer, *,
                   max_seq_len: int, max_segments: int = DEFAULT_MAX_SEGMENTS,
                   with_labels: bool = True, with_provenance: bool = False):
    """Packed rows (lists of items and :class:`ChunkFragment`\\ s) as the
    packed batch.

    Inputs, ``[rows, L]`` int32 but ``segment_starts``:

    - ``input_ids``: the chunks' ids one after another, pad elsewhere;
    - ``attention_mask``: 1 on real tokens (``segment_ids > 0``);
    - ``token_type_ids``: the plain collate's BERT rule within each segment
      (0 through its first [SEP], 1 after); a fragment takes its parent's
      slice, so a split chunk's planes join into the unsplit chunk's;
    - ``segment_ids``: 1..S per segment, 0 on pad;
    - ``position_ids``: 0.. within each segment, 0 on pad; a fragment's
      continue at its ``token_offset``;
    - ``segment_starts`` ``[rows, S]``: each segment's first row index
      (absent segments 0, masked downstream).

    Labels ``[rows, S]``: ``start_class``/``end_class`` row-absolute (-1
    for spanless chunks and absent segments), ``start_reg``/``end_reg``/
    ``cls`` as the plain collate gives them, and ``segment_mask`` (1: a
    real segment). Of a split chunk only the ``keep_labels`` fragment is a
    real segment, with its span rebased by its offset.

    ``with_labels=False`` returns ``(inputs, segment_mask)``, the mask
    marking every present segment, fragments included (the re-merge needs
    them all); ``with_provenance=True`` appends the ``chunk_id`` /
    ``fragment_index`` / ``token_offset`` planes (-1/0/0 for whole
    chunks)."""
    R, L, S = len(row_items), int(max_seq_len), int(max_segments)
    pad_id = tokenizer.pad_token_id
    sep_id = tokenizer.sep_token_id
    is_bert = getattr(tokenizer, "model_name", "bert") == "bert"

    input_ids = np.full((R, L), pad_id, dtype=np.int32)
    token_type_ids = np.zeros((R, L), dtype=np.int32)
    segment_ids = np.zeros((R, L), dtype=np.int32)
    position_ids = np.zeros((R, L), dtype=np.int32)
    segment_starts = np.zeros((R, S), dtype=np.int32)
    segment_mask = np.zeros((R, S), dtype=np.int32)
    start_class = np.full((R, S), -1, dtype=np.int32)
    end_class = np.full((R, S), -1, dtype=np.int32)
    start_reg = np.zeros((R, S), dtype=np.float32)
    end_reg = np.zeros((R, S), dtype=np.float32)
    cls = np.zeros((R, S), dtype=np.int32)
    if with_provenance:
        chunk_id = np.full((R, S), -1, dtype=np.int32)
        fragment_index = np.zeros((R, S), dtype=np.int32)
        token_offset = np.zeros((R, S), dtype=np.int32)

    for r, items in enumerate(row_items):
        assert len(items) <= S, (len(items), S)
        off = 0
        for s, entry in enumerate(items):
            frag = entry if isinstance(entry, ChunkFragment) else None
            item = frag.item if frag is not None else entry
            parent_row = item.input_ids
            if frag is not None:
                row = parent_row[frag.offset:frag.offset + frag.length]
                frag_off = frag.offset
            else:
                row, frag_off = parent_row, 0
            n = len(row)
            assert off + n <= L, (f"packed row overflows max_seq_len {L} at "
                                  f"segment {s} (offset {off} + {n})")
            input_ids[r, off:off + n] = row
            segment_ids[r, off:off + n] = s + 1
            position_ids[r, off:off + n] = frag_off + np.arange(n, dtype=np.int32)
            if is_bert:
                # 0 through the parent's first [SEP], 1 after, sliced
                sep_pos = (parent_row.index(sep_id) if sep_id in parent_row
                           else len(parent_row) - 1)
                ones_from = max(sep_pos + 1 - frag_off, 0)
                if ones_from < n:
                    token_type_ids[r, off + ones_from:off + n] = 1
            segment_starts[r, s] = off
            is_example = frag is None or frag.keep_labels
            segment_mask[r, s] = 1 if (is_example or not with_labels) else 0
            if with_provenance:
                chunk_id[r, s] = frag.chunk_id if frag is not None else -1
                fragment_index[r, s] = frag.index if frag is not None else 0
                token_offset[r, s] = frag_off
            if with_labels and is_example:
                if item.start_id >= 0:
                    # the label-safe cut keeps the span inside this fragment
                    start_class[r, s] = item.start_id - frag_off + off
                    end_class[r, s] = item.end_id - frag_off + off
                start_reg[r, s] = item.start_position
                end_reg[r, s] = item.end_position
                cls[r, s] = item.label_id
            off += n

    inputs = {
        "input_ids": input_ids,
        "attention_mask": (segment_ids > 0).astype(np.int32),
        "token_type_ids": token_type_ids,
        "segment_ids": segment_ids,
        "position_ids": position_ids,
        "segment_starts": segment_starts,
    }
    provenance = ({"chunk_id": chunk_id, "fragment_index": fragment_index,
                   "token_offset": token_offset} if with_provenance else None)
    if not with_labels:
        if with_provenance:
            return inputs, segment_mask, provenance
        return inputs, segment_mask
    labels = {"start_class": start_class, "end_class": end_class,
              "start_reg": start_reg, "end_reg": end_reg, "cls": cls,
              "segment_mask": segment_mask}
    if with_provenance:
        return inputs, labels, provenance
    return inputs, labels


def _fragment_hist_key(n: int) -> str:
    lo = 32
    while lo < n and lo < 512:
        lo *= 2
    return f"<={lo}" if n <= lo else f">{lo}"


class PackedDataLoader:
    """Prefetching loader of packed ``(rows, max_seq_len)`` batches.

    Walks ``sampler.epoch_indices(epoch)`` (the order the plain and
    bucketed loaders batch, weighted sampling kept), reads items on a
    retrying thread pool, bins them with :class:`SequencePacker` and emits
    a :class:`PackedBatch` every ``rows_per_batch`` rows. Train mode drops
    the epoch's partial last batch of rows; eval mode (``pad_last``) pads
    it by repeating its last real row with ``segment_mask`` 0.

    With several processes (``sampler.process_count > 1``) every process
    derives the same epoch plan from the shared length oracle and collates
    only its contiguous ``rows_per_batch / process_count`` rows of each
    planned global batch (:meth:`_iter_oracle`); ``rows`` and ``segments``
    of the batches stay global counts."""

    def __init__(self, dataset, sampler, tokenizer, *, max_seq_len: int,
                 rows_per_batch: int,
                 max_segments: int = DEFAULT_MAX_SEGMENTS,
                 splitting: str = "off",
                 min_fragment: int = DEFAULT_MIN_FRAGMENT,
                 n_jobs: int = 4, pad_last: bool = False):
        self.process_index = int(getattr(sampler, "process_index", 0))
        self.process_count = int(getattr(sampler, "process_count", 1))
        if self.process_count > 1 and rows_per_batch % self.process_count:
            raise ValueError(
                f"rows_per_batch {rows_per_batch} must divide over "
                f"{self.process_count} hosts (each host collates its "
                f"contiguous row slice of every planned global batch)")
        self.dataset = dataset
        self.sampler = sampler
        self.tokenizer = tokenizer
        self.max_seq_len = int(max_seq_len)
        self.rows_per_batch = max(1, int(rows_per_batch))
        self.max_segments = max(1, int(max_segments))
        self.splitting = parse_pack_splitting(splitting)
        self.min_fragment = max(1, int(min_fragment))
        self.n_jobs = max(1, n_jobs)
        self.pad_last = pad_last
        self._epoch = 0
        self._last_stats: Optional[dict] = None
        # planning metas (length, start_id, end_id) by index, or by
        # (epoch key, index) for oracle reads
        self._len_cache: Dict[Any, tuple] = {}

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        """An upper bound of an epoch's steps (a row holds at least one
        item); the LR schedule uses :meth:`planned_epoch_steps`."""
        return len(self.sampler)

    def _make_packer(self) -> SequencePacker:
        """A packer configured as the live epoch's: iteration, the oracle
        plan and the step simulation replay one plan."""
        return SequencePacker(
            self.max_seq_len, max_segments=self.max_segments,
            splitting=self.splitting,
            min_fragment=self.min_fragment)

    def planned_epoch_steps(self, epoch: int) -> int:
        """An epoch's planned batch count: the packer simulated over the
        epoch's item metas (each index read once and cached; past
        ``PLAN_SAMPLE_ITEMS`` items on a prefix, the row count scaled). The
        metas carry the spans, so the simulation replays every split and a
        fully read corpus plans exactly the steps it takes."""

        def simulate(metas):
            packer = self._make_packer()
            rows = 0
            for meta in metas:
                rows += len(packer.add(None, meta[0], _meta_span(meta)))
            return rows + len(packer.flush())

        rows = plan_scaled_count(
            self.dataset, self.sampler, epoch, cache=self._len_cache,
            n_jobs=self.n_jobs, read_retries=READ_RETRIES,
            simulate=simulate, oracle=self.process_count > 1, meta=True)
        if self.pad_last:
            return -(-rows // self.rows_per_batch)
        return rows // self.rows_per_batch

    @staticmethod
    def _new_stats() -> dict:
        return {"real_tokens": 0, "supervised_tokens": 0,
                "physical_tokens": 0, "padmax_tokens": 0, "rows": 0,
                "batches": 0, "items": 0, "dropped_items": 0,
                "split_count": 0, "fragment_rows": 0,
                "fragment_size_hist": {}}

    def _account(self, stats: dict, rows: Sequence[list], real: int,
                 physical_rows: int, tokens_of=_entry_tokens) -> int:
        """Adds one batch's tokens, rows and examples to ``stats`` and
        returns its example count. Tokens count per entry (a fragment its
        own slice); ``supervised_tokens`` leave out the label-less sibling
        fragments; items follow the label carriers."""
        entries = [e for row in rows[:real] for e in row]
        n_examples = sum(1 for e in entries if _entry_is_example(e))
        stats["real_tokens"] += sum(tokens_of(e) for e in entries)
        stats["supervised_tokens"] += sum(tokens_of(e) for e in entries
                                          if _entry_is_example(e))
        stats["physical_tokens"] += physical_rows * self.max_seq_len
        stats["padmax_tokens"] += n_examples * self.max_seq_len
        stats["rows"] += real
        stats["batches"] += 1
        stats["items"] += n_examples
        for row in rows[:real]:
            frags = [e for e in row if isinstance(e, ChunkFragment)]
            stats["split_count"] += sum(1 for f in frags if f.index > 0)
            stats["fragment_rows"] += bool(frags)
            hist = stats["fragment_size_hist"]
            for f in frags:
                key = _fragment_hist_key(tokens_of(f))
                hist[key] = hist.get(key, 0) + 1
        return n_examples

    def _collate(self, rows: Sequence[list]):
        """``(inputs, labels, provenance or None)`` of packed rows."""
        splitting = self.splitting != "off"
        collated = collate_packed(
            rows, self.tokenizer, max_seq_len=self.max_seq_len,
            max_segments=self.max_segments, with_provenance=splitting)
        return collated[0], collated[1], collated[2] if splitting else None

    def _emit(self, rows: List[list], stats: dict, *, real_rows=None):
        real = len(rows) if real_rows is None else int(real_rows)
        inputs, labels, provenance = self._collate(rows)
        if real < len(rows):
            labels["segment_mask"][real:] = 0   # pad rows are no examples
        self._account(stats, rows, real, len(rows))
        return PackedBatch(inputs=inputs, labels=labels, rows=len(rows),
                           segments=int(labels["segment_mask"].sum()),
                           seq=self.max_seq_len, provenance=provenance)

    def _drop_tail(self, stats: dict, rows: Sequence[list]) -> None:
        stats["dropped_items"] += sum(1 for r in rows for e in r
                                      if _entry_is_example(e))
        logger.info("Packed epoch dropped %d tail items in %d partial-batch "
                    "rows (drop_last parity; they re-enter next epoch's "
                    "shuffle).", stats["dropped_items"], len(rows))

    def _iter_oracle(self):
        """A multi-process epoch: the global plan from the oracle metas (the
        same on every process, splits included), then this process's row
        slice of each batch read and collated. Shapes, segment counts and
        stats agree across processes."""
        indices = [int(i) for i in self.sampler.epoch_indices(self._epoch)]
        self._last_stats = stats = self._new_stats()
        metas = oracle_epoch_meta(
            self.dataset, indices, cache=self._len_cache, n_jobs=self.n_jobs,
            read_retries=READ_RETRIES, epoch=self._epoch)
        packer = self._make_packer()
        # rows of (index, length) pairs and fragments whose item is a pair
        rows: List[list] = []
        for idx, meta in zip(indices, metas):
            rows.extend(packer.add((idx, meta[0]), meta[0], _meta_span(meta)))
        rows.extend(packer.flush())

        def entry_index(entry) -> int:
            return (entry.item if isinstance(entry, ChunkFragment)
                    else entry)[0]

        def entry_tokens(entry) -> int:
            return (entry.length if isinstance(entry, ChunkFragment)
                    else entry[1])

        rpb = self.rows_per_batch
        local_rows = rpb // self.process_count
        lo = self.process_index * local_rows
        ek = _oracle_epoch_key(self.dataset, self._epoch)
        batches = [(rows[b * rpb:(b + 1) * rpb], rpb)
                   for b in range(len(rows) // rpb)]
        tail = rows[(len(rows) // rpb) * rpb:]
        if tail:
            if self.pad_last:
                batches.append((tail, len(tail)))
            else:
                self._drop_tail(stats, tail)

        def local_slice(batch_rows):
            # the global tail padded with its last real row, then this
            # process's contiguous rows
            padded = batch_rows + [batch_rows[-1]] * (rpb - len(batch_rows))
            return padded[lo:lo + local_rows]

        def submit(pool, batch_rows):
            # one read per index: fragments of a chunk share it
            futures: dict = {}

            def read(entry):
                idx = entry_index(entry)
                if idx not in futures:
                    futures[idx] = pool.submit(
                        oracle_read, self.dataset, idx,
                        retries=READ_RETRIES, epoch=ek)
                return futures[idx]

            return [[read(e) for e in row] for row in local_slice(batch_rows)]

        def materialize(entry, item):
            if isinstance(entry, ChunkFragment):
                return dataclasses.replace(entry, item=item)
            return item

        # one pool for the epoch, reads submitted two batches ahead
        with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
            pending: deque = deque()
            for i in range(min(2, len(batches))):
                pending.append(submit(pool, batches[i][0]))
            for i, (batch_rows, real_rows) in enumerate(batches):
                futures = pending.popleft()
                if i + 2 < len(batches):
                    pending.append(submit(pool, batches[i + 2][0]))
                row_items = [[materialize(e, f.result())
                              for e, f in zip(plan_row, frow)]
                             for plan_row, frow in zip(local_slice(batch_rows),
                                                       futures)]
                inputs, labels, provenance = self._collate(row_items)
                for r in range(local_rows):   # local rows that pad globally
                    if lo + r >= real_rows:
                        labels["segment_mask"][r] = 0
                segments = self._account(stats, batch_rows, real_rows, rpb,
                                         tokens_of=entry_tokens)
                yield PackedBatch(inputs=inputs, labels=labels, rows=rpb,
                                  segments=segments, seq=self.max_seq_len,
                                  provenance=provenance)

    def __iter__(self):
        if self.process_count > 1:
            yield from self._iter_oracle()
            return
        indices = [int(i) for i in self.sampler.epoch_indices(self._epoch)]
        self._last_stats = stats = self._new_stats()
        packer = self._make_packer()
        pending_rows: List[list] = []

        def drain():
            while len(pending_rows) >= self.rows_per_batch:
                batch_rows = pending_rows[:self.rows_per_batch]
                del pending_rows[:self.rows_per_batch]
                yield self._emit(batch_rows, stats)

        if indices:
            with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
                def read(i):
                    return read_with_retry(self.dataset, i,
                                           retries=READ_RETRIES)

                window = self.n_jobs * 8
                futures: deque = deque(pool.submit(read, idx)
                                       for idx in indices[:window])
                rest = iter(indices[window:])
                while futures:
                    # submission order: row assignment follows the epoch's
                    item = futures.popleft().result()
                    nxt = next(rest, None)
                    if nxt is not None:
                        futures.append(pool.submit(read, nxt))
                    pending_rows.extend(packer.add(
                        item, len(item.input_ids), _item_span(item)))
                    yield from drain()
        pending_rows.extend(packer.flush())
        yield from drain()
        if pending_rows:
            if self.pad_last:
                real = len(pending_rows)
                pad = self.rows_per_batch - real
                yield self._emit(pending_rows + [pending_rows[-1]] * pad,
                                 stats, real_rows=real)
            else:
                self._drop_tail(stats, pending_rows)

    @property
    def epoch_stats(self) -> Optional[dict]:
        """Token accounting of the last (or current) epoch:
        ``padding_waste_pct`` is the pad share of the physical tokens,
        ``packing_efficiency`` the supervised tokens over the physical ones
        (the label-less sibling fragments left out), ``padmax_waste_pct``
        what padding every example to ``max_seq_len`` would have wasted."""
        s = self._last_stats
        if not s:
            return None
        out = dict(s)
        if s["physical_tokens"]:
            out["packing_efficiency"] = round(
                s["supervised_tokens"] / s["physical_tokens"], 4)
            out["padding_waste_pct"] = round(
                100.0 * (1.0 - s["real_tokens"] / s["physical_tokens"]), 2)
        if s["padmax_tokens"]:
            out["padmax_waste_pct"] = round(
                100.0 * (1.0 - s["real_tokens"] / s["padmax_tokens"]), 2)
        return out
