"""The port's sequence packing against the JAX package's, on the same items.

Both packages read the same numpy-seeded items (a pure function of the
index, like ``DummyDataset``) and must agree bit for bit:

- the flag domains of ``--sequence_packing`` and ``--pack_splitting``;
- ``SequencePacker``'s row plans (first fit, eager close on an exact fill,
  the segment cap, the forced emit of the fullest row, and the splitting
  packer's label-safe cuts), fragment by fragment;
- ``collate_packed``'s planes, labels and fragment provenance, with and
  without labels;
- ``PackedDataLoader``'s batches over two epochs (train: drop-last; eval:
  the pad-last rows), its planned step count (equal to the steps taken)
  and its epoch stats;
- two processes' loaders (each's row slice through the shared length
  oracle) against the JAX package's, their slices joined equal to the
  one-process batches, and the refusal when rows do not divide.
"""

import numpy as np
import pytest

from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.data.loader import ShardedBatchSampler as JaxSampler
from ml_recipe_tpu.data.packing import ChunkFragment as JaxFragment
from ml_recipe_tpu.data.packing import PackedDataLoader as JaxLoader
from ml_recipe_tpu.data.packing import SequencePacker as JaxPacker
from ml_recipe_tpu.data.packing import collate_packed as jax_collate
from ml_recipe_tpu.data.packing import parse_pack_splitting as jax_splitting
from ml_recipe_tpu.data.packing import parse_sequence_packing as jax_packing
from ml_recipe_tpu_torch.data import PackedBatch, collate_packed
from ml_recipe_tpu_torch.data.datasets import DatasetItem
from ml_recipe_tpu_torch.data.loader import ShardedBatchSampler
from ml_recipe_tpu_torch.data.packing import (
    ChunkFragment,
    PackedDataLoader,
    SequencePacker,
    parse_pack_splitting,
    parse_sequence_packing,
)

from helpers import make_tokenizer

L = 64


class VarLenDataset:
    """QA items of a packable length mix, a pure function of the index,
    built as ``item_type`` (each package's ``DatasetItem``)."""

    def __init__(self, item_type, n, *, lo=10, hi=L // 2, vocab=46):
        self.item_type, self.n, self.lo, self.hi = item_type, n, lo, hi
        self.vocab = vocab

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng([11, int(i)])
        n = int(rng.integers(self.lo, self.hi + 1))
        body = rng.integers(5, self.vocab, max(n - 3, 1)).tolist()
        ids = [2, *body, 3, 3]
        if rng.random() < 0.2:
            start = end = -1
        else:
            start = int(rng.integers(0, len(ids)))
            end = min(start + 2, len(ids) - 1)
        return self.item_type(
            example_id=str(i), input_ids=ids, start_id=start, end_id=end,
            label_id=int(rng.integers(0, 5)),
            start_position=max(start, 0) / L, end_position=max(end, 0) / L)


def _entry(e):
    """A plan entry as plain values (the item by its example id)."""
    if isinstance(e, (ChunkFragment, JaxFragment)):
        return ("frag", e.item.example_id, e.chunk_id, e.offset, e.length,
                e.index, e.count, e.keep_labels, e.chunk_len)
    return ("item", e.example_id)


def _plan(rows):
    return [[_entry(e) for e in row] for row in rows]


def test_flag_domains_match_jax():
    for spec in (None, False, True, "off", "none", "0", "false", "", "on",
                 "ON", "1", "yes", "fill", " Off "):
        assert parse_sequence_packing(spec) == jax_packing(spec), spec
        assert parse_pack_splitting(spec) == jax_splitting(spec), spec
    for bad in ("split", "2"):
        with pytest.raises(ValueError):
            jax_splitting(bad)
        with pytest.raises(ValueError, match="off|fill"):
            parse_pack_splitting(bad)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_segments=2, open_rows=2),
    dict(open_rows=1),
    dict(splitting="fill", min_fragment=4),
    dict(splitting="fill", min_fragment=8, max_segments=3, open_rows=3),
], ids=["first-fit", "cap-2", "window-1", "fill", "fill-cap-3"])
def test_packer_row_plans_match_jax(kw):
    items = [VarLenDataset(DatasetItem, 80, lo=6, hi=50)[i] for i in range(80)]
    jitems = [VarLenDataset(JaxItem, 80, lo=6, hi=50)[i] for i in range(80)]
    # an exact fill closes eagerly
    for name in ("y", "x"):
        items.insert(0, DatasetItem(name, [2] * (L // 2), -1, -1, 0, 0., 0.))
        jitems.insert(0, JaxItem(name, [2] * (L // 2), -1, -1, 0, 0., 0.))
    port, ref = SequencePacker(L, **kw), JaxPacker(L, **kw)
    got, want = [], []
    for a, b in zip(items, jitems):
        got.append(_plan(port.add(a, len(a.input_ids),
                                  (a.start_id, a.end_id))))
        want.append(_plan(ref.add(b, len(b.input_ids),
                                  (b.start_id, b.end_id))))
    got.append(_plan(port.flush()))
    want.append(_plan(ref.flush()))
    assert got == want
    assert got[:2] == [[], [[("item", "x"), ("item", "y")]]]
    assert port.split_count == ref.split_count
    if kw.get("splitting") == "fill":
        assert port.split_count > 0
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        port.add(items[1], L + 1)


def _split_rows(item_type):
    packer = (SequencePacker if item_type is DatasetItem else JaxPacker)(
        L, splitting="fill", min_fragment=4, max_segments=4, open_rows=4)
    ds = VarLenDataset(item_type, 40, lo=14, hi=44)
    rows = []
    for i in range(40):
        it = ds[i]
        rows.extend(packer.add(it, len(it.input_ids), (it.start_id, it.end_id)))
    return rows + packer.flush()


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("with_labels", [True, False])
def test_collate_packed_matches_jax(tmp_path, with_labels):
    tok = make_tokenizer(tmp_path)
    rows, jrows = _split_rows(DatasetItem), _split_rows(JaxItem)
    assert _plan(rows) == _plan(jrows)
    assert any(isinstance(e, ChunkFragment) for r in rows for e in r)
    kw = dict(max_seq_len=L, max_segments=4, with_labels=with_labels,
              with_provenance=True)
    got, want = collate_packed(rows, tok, **kw), jax_collate(jrows, tok, **kw)
    _assert_same(got[0], want[0])
    if with_labels:
        _assert_same(got[1], want[1])
        # the span of every labelled segment lies in its own segment
        seg, lab = got[0]["segment_ids"], got[1]
        for r, s in zip(*np.nonzero(lab["segment_mask"])):
            if lab["start_class"][r, s] >= 0:
                assert seg[r, lab["start_class"][r, s]] == s + 1
    else:
        assert np.array_equal(got[1], want[1])
    _assert_same(got[2], want[2])
    assert (got[2]["token_offset"] > 0).any()


def _loaders(n, rows, *, tok, pad_last=False, pc=1, pi=0, ds_kw=None,
             **kw):
    """The port's and the JAX package's loaders over the same items."""
    out = []
    for item_type, sampler, loader in (
            (DatasetItem, ShardedBatchSampler, PackedDataLoader),
            (JaxItem, JaxSampler, JaxLoader)):
        s = sampler(n, rows, shuffle=not pad_last, drop_last=not pad_last,
                    pad_last=pad_last, seed=3, process_index=pi,
                    process_count=pc)
        out.append(loader(VarLenDataset(item_type, n, **(ds_kw or {})), s,
                          tok, max_seq_len=L, rows_per_batch=rows, n_jobs=2,
                          pad_last=pad_last, **kw))
    return out


def _assert_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert isinstance(a, PackedBatch)
        assert (a.rows, a.segments, a.seq) == (b.rows, b.segments, b.seq)
        _assert_same(a.inputs, b.inputs)
        _assert_same(a.labels, b.labels)
        if b.provenance is None:
            assert a.provenance is None
        else:
            _assert_same(a.provenance, b.provenance)


@pytest.mark.parametrize("pad_last", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("split", [
    dict(), dict(splitting="fill", min_fragment=4, ds_kw=dict(lo=14, hi=44))],
    ids=["off", "fill"])
def test_packed_loader_matches_jax(tmp_path, pad_last, split):
    tok = make_tokenizer(tmp_path)
    n, rows = (44, 6) if pad_last else (64, 4)
    port, ref = _loaders(n, rows, pad_last=pad_last, tok=tok, **split)
    # planned steps equal to the steps taken, on both sides
    assert port.planned_epoch_steps(1) == ref.planned_epoch_steps(1)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        _assert_batches(got, want)
        assert port.epoch_stats == ref.epoch_stats
        if epoch == 1:
            assert len(got) == port.planned_epoch_steps(1)
    stats = port.epoch_stats
    assert stats["items"] + stats["dropped_items"] == n
    assert stats["items"] > stats["rows"]          # packing happened
    if pad_last:
        assert stats["dropped_items"] == 0
        last = got[-1]
        real = int((last.labels["segment_mask"].sum(axis=1) > 0).sum())
        assert real < last.rows                      # pad rows, mask 0
        assert (last.labels["segment_mask"][real:] == 0).all()
        assert np.array_equal(last.inputs["input_ids"][real:],
                              np.repeat(last.inputs["input_ids"][real - 1:real],
                                        last.rows - real, axis=0))
    if split:
        assert stats["split_count"] > 0 and stats["fragment_rows"] > 0


@pytest.mark.parametrize("split", [
    dict(), dict(splitting="fill", min_fragment=4, ds_kw=dict(lo=14, hi=44))],
    ids=["off", "fill"])
def test_two_process_loaders_match_jax_and_join_to_one(tmp_path, split):
    tok = make_tokenizer(tmp_path)
    single = _loaders(48, 8, tok=tok, **split)[0]
    ranks = [_loaders(48, 8, tok=tok, pc=2, pi=r, **split) for r in (0, 1)]
    for loader in [single] + [x for pair in ranks for x in pair]:
        loader.set_epoch(1)
    one = list(single)
    per_rank = [(list(port), list(ref)) for port, ref in ranks]
    for got, want in per_rank:
        _assert_batches(got, want)
    (b0, _), (b1, _) = per_rank
    assert len(one) == len(b0) == len(b1)
    for s, a, b in zip(one, b0, b1):
        assert (s.rows, s.segments) == (a.rows, a.segments) == (b.rows,
                                                                  b.segments)
        assert a.inputs["input_ids"].shape[0] == s.rows // 2
        for key in s.inputs:
            assert np.array_equal(np.concatenate([a.inputs[key],
                                                  b.inputs[key]]),
                                  s.inputs[key]), key
        for key in s.labels:
            assert np.array_equal(np.concatenate([a.labels[key],
                                                  b.labels[key]]),
                                  s.labels[key]), key
    planned = {loader.planned_epoch_steps(1)
               for pair in ranks for loader in pair}
    assert planned == {single.planned_epoch_steps(1)}
    assert ranks[0][0].epoch_stats == single.epoch_stats


def test_rows_that_do_not_divide_over_processes_are_refused(tmp_path):
    tok = make_tokenizer(tmp_path)
    for item_type, sampler, loader in (
            (DatasetItem, ShardedBatchSampler, PackedDataLoader),
            (JaxItem, JaxSampler, JaxLoader)):
        s = sampler(16, 8, process_index=0, process_count=2, seed=0)
        with pytest.raises(ValueError, match="divide over"):
            loader(VarLenDataset(item_type, 16), s, tok, max_seq_len=L,
                   rows_per_batch=5)
