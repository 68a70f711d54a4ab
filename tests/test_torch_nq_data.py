"""The port's NQ corpus input path against the JAX package's, on the CPU.

One seeded corpus, written with the JAX tests' own ``helpers.nq_line`` /
``write_corpus`` (five classes mixed; a third of the documents long enough
for several chunks at ``max_seq_len`` 64), goes through both packages.
Every comparison is exact:

- ``split_sentences``; every training-side chunking function
  (``encode_document_by_sentences``, ``sentence_chunks``,
  ``truncate_record``, ``window_chunks``, ``label_safe_cut``,
  ``chunk_sampling_weights`` bit for bit, ``pick_eval_chunk``);
- ``RawPreprocessor``: returned counts, labels and split, and the files it
  writes; a directory processed by one package is read by the other;
- ``SplitDataset`` items (train mode with the same seeded chunk-sampling
  rng, read in order; test mode) and ``ChunkDataset`` items;
- ``init_datasets``' label and sampler weights;
- ``BucketedDataLoader.planned_epoch_steps`` and one epoch of bucketed
  batches, element for element, over the weighted sampler (one worker: the
  shared chunk-sampling rng draws in read order).
"""

import dataclasses
import json
import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from ml_recipe_tpu import compose as jax_compose
from ml_recipe_tpu.data import chunking as jax_chunking
from ml_recipe_tpu.data.bucketing import BucketedDataLoader as JaxBucketedLoader
from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import ChunkDataset as JaxChunkDataset
from ml_recipe_tpu.data.datasets import SplitDataset as JaxSplitDataset
from ml_recipe_tpu.data.loader import ShardedBatchSampler as JaxSampler
from ml_recipe_tpu.data.preprocessor import RawPreprocessor as JaxPreprocessor
from ml_recipe_tpu.data.sentence import split_sentences as jax_split
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.utils.seed import RngPool as JaxRngPool
from ml_recipe_tpu_torch import compose
from ml_recipe_tpu_torch.data import chunking
from ml_recipe_tpu_torch.data.bucketing import BucketedDataLoader
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import ChunkDataset, SplitDataset
from ml_recipe_tpu_torch.data.loader import ShardedBatchSampler
from ml_recipe_tpu_torch.data.preprocessor import RawPreprocessor
from ml_recipe_tpu_torch.data.sentence import split_sentences
from ml_recipe_tpu_torch.data.synthetic import vocab_words, write_nq_corpus
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.utils.seed import RngPool

from helpers import WORDS, nq_line, write_corpus, write_vocab

MAX_SEQ_LEN, MAX_Q_LEN, DOC_STRIDE = 64, 16, 16
N_DOCS = 40
_BODY = [w for w in WORDS if w.isalpha()]


def _paragraph(rng, start):
    """``<P>`` sentences ``</P>`` words, each sentence capitalised and ending
    in '.'; returns the words."""
    words = ["<P>"]
    for _ in range(int(rng.integers(2, 6))):
        sentence = [str(w) for w in rng.choice(_BODY, int(rng.integers(4, 12)))]
        words += [sentence[0].capitalize(), *sentence[1:], "."]
    return words + ["</P>"]


def mixed_lines(n_docs=N_DOCS, seed=0):
    """``n_docs`` NQ lines through ``helpers.nq_line``: classes cycle through
    yes / no / short / long / unknown; every third document has one
    paragraph, the others four (several chunks at ``MAX_SEQ_LEN``)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_docs):
        words, spans = [], []
        for _ in range(1 if i % 3 == 0 else 4):
            start = len(words)
            words += _paragraph(rng, start)
            spans.append((start, len(words)))
        p = int(rng.integers(0, len(spans)))
        s, e = spans[p]
        question = " ".join(str(w) for w in rng.choice(_BODY, 5)) + " ?"
        kind = ("yes", "no", "short", "long", "unknown")[i % 5]
        kw = dict(example_id=str(i), document_text=" ".join(words),
                  question_text=question, long_start=s, long_end=e,
                  candidate_index=p, short_answers=[])
        if kind in ("yes", "no"):
            kw["yes_no_answer"] = kind.upper()
        elif kind == "short":
            w = int(rng.integers(s + 1, e - 2))
            kw["short_answers"] = [{"start_token": w, "end_token": w + 2}]
        elif kind == "unknown":
            kw.update(long_start=-1, long_end=-1, candidate_index=-1)
        lines.append(nq_line(**kw))
    return lines


def write_mixed_corpus(tmp_path: Path, n_docs=N_DOCS, seed=0) -> Path:
    return write_corpus(tmp_path, mixed_lines(n_docs, seed))


def tokenizers(tmp_path: Path):
    vocab = str(write_vocab(tmp_path))
    return (JaxTokenizer("bert", vocab, lowercase=True),
            Tokenizer("bert", vocab, lowercase=True))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nq")
    raw = write_mixed_corpus(tmp)
    jtok, ttok = tokenizers(tmp)
    jout = JaxPreprocessor(raw, tmp / "jax_proc")()
    tout = RawPreprocessor(raw, tmp / "port_proc")()
    return SimpleNamespace(tmp=tmp, raw=raw, jtok=jtok, ttok=ttok, jout=jout,
                           tout=tout, lines=mixed_lines())


def _same(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# -- sentences and chunking -----------------------------------------------------

SENTENCE_CASES = [
    "", "   ", "One sentence without an end",
    "Dr. Smith went to Washington. He arrived at 5 p.m. on Monday! Did he? Yes.",
    "The U.S. economy grew. E.g. this one. Mr. T. Jones said \"Hello.\" Then left.",
    "Numbers 1. 2. 3. Start <P> tags. Stay </P> here.\n\nNew line. (Parens) too.",
]


@pytest.mark.parametrize("case", range(len(SENTENCE_CASES) + 1))
def test_split_sentences_matches_jax(corpus, case):
    texts = (SENTENCE_CASES[case:case + 1] if case < len(SENTENCE_CASES)
             else [line["document_text"] for line in corpus.lines])
    for text in texts:
        assert split_sentences(text) == jax_split(text)


def _targets(line):
    processed = JaxPreprocessor._process_line(line)
    return JaxPreprocessor._get_target(processed)


def test_chunking_functions_match_jax(corpus):
    jtok, ttok = corpus.jtok, corpus.ttok
    n_sentence = n_window = n_cut = 0
    for line in corpus.lines:
        text = line["document_text"]
        jt = jax_chunking.encode_document_by_sentences(jtok, text, jax_split)
        tt = chunking.encode_document_by_sentences(ttok, text, split_sentences)
        assert jt == tt
        t_sens, o2t, _ = tt
        label, start, end = _targets(line)
        target = ((label, o2t[start], o2t[end]) if start >= 0
                  else (label, -1, -1))
        q_len = len(ttok.encode(line["question_text"])[:MAX_Q_LEN])
        kw = dict(question_len=q_len, max_seq_len=MAX_SEQ_LEN)
        jrecs = jax_chunking.sentence_chunks(t_sens, target, **kw)
        trecs = chunking.sentence_chunks(t_sens, target, **kw)
        assert len(jrecs) == len(trecs) and all(map(_same, jrecs, trecs))
        n_sentence += len(trecs)
        for j, t in zip(jrecs, trecs):
            jcut = jax_chunking.truncate_record(j, **kw)
            tcut = chunking.truncate_record(t, **kw)
            assert _same(jcut, tcut)
            n_cut += tcut is not t
        w = np.asarray(chunking.chunk_sampling_weights(trecs))
        assert w.dtype == np.float64
        assert np.array_equal(w, jax_chunking.chunk_sampling_weights(jrecs))
        assert (chunking.pick_eval_chunk(trecs, label)
                == jax_chunking.pick_eval_chunk(jrecs, label))
        flat, o2t_flat, t2o_flat = chunking.encode_document(ttok, text)
        assert (flat, o2t_flat, t2o_flat) == jax_chunking.encode_document(
            jtok, text)
        wkw = dict(kw, doc_stride=DOC_STRIDE)
        jw = jax_chunking.window_chunks(flat, target, **wkw)
        tw = chunking.window_chunks(flat, target, **wkw)
        assert len(jw) == len(tw) and all(map(_same, jw, tw))
        n_window += len(tw)
    assert n_sentence > N_DOCS and n_window > N_DOCS
    for length in (8, 40, 64):
        for span in (None, (0, 3), (5, 20), (30, 60), (-1, -1)):
            for hole in (0, 4, 17, 63):
                for min_fragment in (1, 4, 32):
                    assert (chunking.label_safe_cut(length, span, hole,
                                                    min_fragment)
                            == jax_chunking.label_safe_cut(length, span, hole,
                                                           min_fragment))


# -- the preprocessor -----------------------------------------------------------

def _split_equal(a, b):
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert np.array_equal(x, y) and x.dtype == y.dtype


def test_preprocessor_outputs_and_files_match_jax(corpus):
    (jc, jl, js), (tc, tl, ts) = corpus.jout, corpus.tout
    assert dict(jc) == dict(tc) and set(tc) == set(range(5))
    assert np.array_equal(jl, tl)
    _split_equal(js, ts)
    jdir, tdir = corpus.tmp / "jax_proc", corpus.tmp / "port_proc"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert len(names) == N_DOCS + 2
    for name in names:
        a, b = (jdir / name).read_bytes(), (tdir / name).read_bytes()
        if name.endswith(".json"):
            assert a == b, name
        else:
            ja, tb = pickle.loads(a), pickle.loads(b)
            assert len(ja) == len(tb)
            for x, y in zip(ja, tb):
                assert (x == y if isinstance(x, dict)
                        else np.array_equal(x, y)), name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_processed_directory_is_read_by_the_other_package(corpus, direction):
    src = corpus.tmp / ("jax_proc" if direction == "jax_to_port" else "port_proc")
    reader = RawPreprocessor if direction == "jax_to_port" else JaxPreprocessor
    # the raw corpus path is never opened: both info files are found
    counter, labels, split = reader(corpus.tmp / "absent.jsonl", src)()
    (jc, jl, js) = corpus.jout
    assert dict(counter) == dict(jc) and np.array_equal(labels, jl)
    _split_equal(split, js)
    dataset = (SplitDataset if direction == "jax_to_port" else JaxSplitDataset)(
        src, corpus.ttok if direction == "jax_to_port" else corpus.jtok,
        split[2], max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
        test=True)
    assert all(len(dataset[i].input_ids) <= MAX_SEQ_LEN
               for i in range(len(dataset)))


def test_clear_removes_processed_files(corpus, tmp_path):
    out = tmp_path / "proc"
    RawPreprocessor(corpus.raw, out)()
    (out / "stale.json").write_text("{}")
    RawPreprocessor(corpus.raw, out, clear=True)
    assert not any(out.iterdir())


# -- datasets -------------------------------------------------------------------

DATASET_MODES = {
    "sentence_truncate": dict(split_by_sentence=True, truncate=True),
    "sentence": dict(split_by_sentence=True, truncate=False),
    "window": dict(split_by_sentence=False, truncate=False),
}


def _dataset_pair(corpus, cls_pair, indexes, mode, *, test, seed=0):
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              doc_stride=DOC_STRIDE, test=test, **DATASET_MODES[mode])
    jcls, tcls = cls_pair
    return (jcls(corpus.tmp / "jax_proc", corpus.jtok, indexes,
                 rng=JaxRngPool(seed).host_rng("chunk_sampling"), **kw),
            tcls(corpus.tmp / "port_proc", corpus.ttok, indexes,
                 rng=RngPool(seed).host_rng("chunk_sampling"), **kw))


@pytest.mark.parametrize("mode", list(DATASET_MODES))
@pytest.mark.parametrize("test", [False, True], ids=["train", "test"])
def test_split_dataset_items_match_jax(corpus, mode, test):
    _, _, (train_idx, _, test_idx, _) = corpus.tout
    indexes = test_idx if test else train_idx
    jds, tds = _dataset_pair(corpus, (JaxSplitDataset, SplitDataset),
                             indexes, mode, test=test)
    assert len(jds) == len(tds) == len(indexes)
    # two passes: the second reads the LRU cache and draws on
    for _ in range(2):
        for i in range(len(tds)):
            assert _same(jds[i], tds[i]), i
    if not test:
        # the shared rng drew the same stream
        assert jds.rng.random() == tds.rng.random()


@pytest.mark.parametrize("mode", ["sentence_truncate", "window"])
def test_chunk_dataset_items_match_jax(corpus, mode):
    _, _, (_, _, test_idx, _) = corpus.tout
    indexes = np.arange(N_DOCS)
    jds, tds = _dataset_pair(corpus, (JaxChunkDataset, ChunkDataset), indexes,
                             mode, test=False)
    n_chunks = 0
    for i in range(len(tds)):
        jitems, titems = jds[i], tds[i]
        assert len(jitems) == len(titems) >= 1
        assert all(map(_same, jitems, titems))
        n_chunks += len(titems)
    assert n_chunks > N_DOCS


def _params(corpus, proc, **kw):
    base = dict(dummy_dataset=False, data_path=str(corpus.raw),
                processed_data_path=str(corpus.tmp / proc),
                max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
                doc_stride=DOC_STRIDE, split_by_sentence=True, truncate=True,
                train_label_weights=True, train_sampler_weights=True)
    base.update(kw)
    return SimpleNamespace(**base)


def test_init_datasets_weights_match_jax(corpus):
    jtr, jte, jw = jax_compose.init_datasets(
        _params(corpus, "jax_proc"), tokenizer=corpus.jtok,
        rng=JaxRngPool(0).host_rng("chunk_sampling"))
    ttr, tte, tw = compose.init_datasets(
        _params(corpus, "port_proc"), tokenizer=corpus.ttok,
        rng=RngPool(0).host_rng("chunk_sampling"))
    for key in ("label_weights", "sampler_weights"):
        assert tw[key].dtype == np.float64
        assert np.array_equal(tw[key], jw[key]), key
    assert len(tw["label_weights"]) == 5
    assert len(tw["sampler_weights"]) == len(ttr) == len(jtr)
    assert np.array_equal(ttr.indexes, jtr.indexes)
    assert np.array_equal(tte.indexes, jte.indexes) and tte.test
    _, _, off = compose.init_datasets(
        _params(corpus, "port_proc", train_label_weights=False,
                train_sampler_weights=False), tokenizer=corpus.ttok)
    assert off == {"label_weights": None, "sampler_weights": None}
    val = compose.init_validation_dataset(_params(corpus, "port_proc"),
                                          tokenizer=corpus.ttok)
    jval = jax_compose.init_validation_dataset(_params(corpus, "jax_proc"),
                                               tokenizer=corpus.jtok)
    assert isinstance(val, ChunkDataset) and np.array_equal(val.indexes,
                                                            jval.indexes)
    assert (val.max_seq_len, val.split_by_sentence, val.truncate) == (
        jval.max_seq_len, jval.split_by_sentence, jval.truncate)


# -- bucketed batches -------------------------------------------------------------

GRID = [32, 56, MAX_SEQ_LEN]


@pytest.mark.parametrize("pad_last", [False, True], ids=["train", "eval"])
def test_bucketed_epoch_matches_jax(corpus, pad_last):
    _, _, (train_idx, train_labels, test_idx, _) = corpus.tout
    counter = corpus.tout[0]
    indexes = test_idx if pad_last else train_idx
    jds, tds = _dataset_pair(corpus, (JaxSplitDataset, SplitDataset), indexes,
                             "sentence_truncate", test=pad_last)
    weights = None
    if not pad_last:
        weights = np.asarray([1 / counter[label] for label in train_labels])
        weights = weights / weights.sum()
    batch = 4
    sampler_kw = dict(shuffle=not pad_last, drop_last=not pad_last,
                      pad_last=pad_last, weights=weights, seed=3)
    kw = dict(seq_grid=GRID, token_budget=batch * MAX_SEQ_LEN,
              batch_multiple=1 if pad_last else 2, n_jobs=1,
              pad_last=pad_last)
    jl = JaxBucketedLoader(jds, JaxSampler(len(jds), batch, **sampler_kw),
                           jax_make_collate(corpus.jtok, max_seq_len=MAX_SEQ_LEN),
                           **kw)
    tl = BucketedDataLoader(tds, ShardedBatchSampler(len(tds), batch,
                                                     **sampler_kw),
                            make_collate_fun(corpus.ttok, max_seq_len=MAX_SEQ_LEN),
                            **kw)
    planned = tl.planned_epoch_steps(1)
    assert planned == jl.planned_epoch_steps(1) > 0
    # planning read lengths with the chunk-sampling rng shielded
    assert tds.rng.random() == jds.rng.random()
    jl.set_epoch(1)
    tl.set_epoch(1)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) > 0
    seqs = set()
    for a, b in zip(jb, tb):
        assert (a.seq, a.real_rows, a.rows) == (b.seq, b.real_rows, b.rows)
        seqs.add(b.seq)
        for key in a.inputs:
            assert np.array_equal(a.inputs[key], b.inputs[key]), key
        for key in a.labels:
            assert np.array_equal(a.labels[key], b.labels[key]), key
    assert len(seqs) >= 2   # the lengths spread over the buckets
    assert tl.epoch_stats == jl.epoch_stats


def test_nq_shaped_corpus_spreads_over_the_buckets(tmp_path):
    """``data.synthetic.write_nq_corpus``: log-uniform document lengths,
    balanced classes, and after preprocessing chunks in every bucket."""
    vocab = str(write_vocab(tmp_path))
    raw = write_nq_corpus(tmp_path / "nq.jsonl", vocab, n_docs=25, seed=1,
                          min_words=10, max_words=300)
    lines = [json.loads(x) for x in raw.read_text().splitlines()]
    lengths = [len(x["document_text"].split()) for x in lines]
    assert min(lengths) < 60 and max(lengths) > 150
    assert "<P>" in lines[0]["document_text"]
    assert set(vocab_words(vocab)) >= {w for x in lines
                                       for w in x["question_text"].split()[:-1]}
    counter, _, (train_idx, _, test_idx, _) = RawPreprocessor(
        raw, tmp_path / "proc")()
    assert sorted(counter.values()) == [5] * 5
    ttok = Tokenizer("bert", vocab, lowercase=True)
    ds = ChunkDataset(tmp_path / "proc", ttok, np.arange(25),
                      max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
                      split_by_sentence=True, truncate=True)
    lengths = [len(c.input_ids) for i in range(len(ds)) for c in ds[i]]
    buckets = {next(g for g in GRID if n <= g) for n in lengths}
    assert buckets == set(GRID) and max(lengths) <= MAX_SEQ_LEN


def test_token_cache_serves_concurrent_readers(corpus):
    """The LRU token cache under the loaders' thread pools: many threads
    reading through a two-entry cache (hits, evictions and inserts racing)
    get exactly the items of one sequential reader."""
    from concurrent.futures import ThreadPoolExecutor

    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              split_by_sentence=True, truncate=True)
    idx = np.arange(N_DOCS)
    want = [ChunkDataset(corpus.tmp / "port_proc", corpus.ttok, idx,
                         cache_size=0, **kw)[i] for i in idx]
    shared = ChunkDataset(corpus.tmp / "port_proc", corpus.ttok, idx,
                          cache_size=2, **kw)
    # runs of reads over 3 of the documents at a time: mostly hits on
    # entries another thread is about to evict
    order = [i % 3 + 3 * (i // 30) for i in range(300)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(lambda i: (i, shared[i]), order))
    assert len(got) == 300 and len(shared._cache) <= 2
    for i, items in got:
        assert all(map(_same, items, want[i])), i
