"""The port's inference path and the NQ training recipe against the JAX
package's, on the CPU.

- ``ListDataloader``: order through ``pool.map`` (shuffled from its seed,
  re-batched across documents), a worker's error surfacing with its
  traceback, and an early stop that stops the producer;
- ``LaggedConsumer``: the port's copy delivers what the JAX one delivers
  for every depth / total (the port has no grouped delivery);
- ``Predictor`` against the JAX ``Predictor`` on the same weights (a
  bert-tiny-sized model, f32, through ``from_jax_params``) and the same
  ``ChunkDataset``, pad-to-max, length-bucketed and with JAX's grouped
  fetches (the port copies each batch on its own):
  candidate spans and labels equal, scores within ``SCORE_ATOL``. A span
  may differ only where JAX's own top-two logits of that chunk lie within
  ``SCORE_ATOL``; the test counts such cases;
- the NQ trainer (sentence chunks, label and sampler weights, length
  buckets, two micro-batches) against the JAX ``Trainer``: the same running
  losses per step at ``rtol=1e-5``, as ``test_trajectory_matches_jax_trainer``
  holds the dummy-data trainer;
- the CLIs as subprocesses: ``cli.train`` on a corpus without
  ``--dummy_dataset`` (2 epochs, so ``last.ch`` exists), then
  ``cli.train_metrics`` on ``last.ch``, whose test-split "Test metrics"
  line must equal the train run's last one digit for digit, and
  ``cli.validate`` in bf16 and with ``--quantize int8 --ln_impl fused``;
  the predictor flags the port lacks raise naming ROADMAP.
"""

import os
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ml_recipe_tpu.compose import init_collate_fun as jax_init_collate
from ml_recipe_tpu.data.datasets import ChunkDataset as JaxChunkDataset
from ml_recipe_tpu.data.datasets import SplitDataset as JaxSplitDataset
from ml_recipe_tpu.data.loader import ListDataloader as JaxListDataloader
from ml_recipe_tpu.infer import Predictor as JaxPredictor
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.utils.pipeline import LaggedConsumer as JaxLaggedConsumer
from ml_recipe_tpu.utils.seed import RngPool as JaxRngPool
from ml_recipe_tpu_torch.cli import train_metrics
from ml_recipe_tpu_torch.compose import init_collate_fun
from ml_recipe_tpu_torch.config.parser import (
    check_predict_flags,
    get_model_parser,
    get_params,
    get_predictor_parser,
)
from ml_recipe_tpu_torch.data.datasets import ChunkDataset, SplitDataset
from ml_recipe_tpu_torch.data.loader import DataLoaderWorkerError, ListDataloader
from ml_recipe_tpu_torch.data.preprocessor import RawPreprocessor
from ml_recipe_tpu_torch.infer.predictor import Predictor, PredictorCandidate
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, from_jax_params
from ml_recipe_tpu_torch.train.trainer import Trainer
from ml_recipe_tpu_torch.utils.pipeline import LaggedConsumer
from ml_recipe_tpu_torch.utils.seed import RngPool

from test_torch_nq_data import tokenizers, write_mixed_corpus

REPO = Path(__file__).resolve().parents[1]
MAX_SEQ_LEN, MAX_Q_LEN = 64, 16
# f32 on both sides, other summation orders: ~1e-6 on O(1) logits
SCORE_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One intra-op thread for this module's tiny models (the processes it
    starts get ``OMP_NUM_THREADS=1``): the test workers share the host's
    cores, and more threads a process only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pred")
    raw = write_mixed_corpus(tmp)
    jtok, ttok = tokenizers(tmp)
    out = RawPreprocessor(raw, tmp / "proc")()
    kw = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
              max_position_embeddings=MAX_SEQ_LEN + 2, num_labels=5,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jmodel = JaxQAModel(JaxEncoderConfig(vocab_size=len(jtok), **kw))
    params = jmodel.init(jax.random.key(0),
                         np.zeros((1, 8), np.int32))["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = QAModel(EncoderConfig(vocab_size=len(ttok), **kw), device="cpu")
    model.load_state_dict(from_jax_params(params_np), strict=True)
    model.eval()
    return SimpleNamespace(tmp=tmp, raw=raw, jtok=jtok, ttok=ttok, out=out,
                           jmodel=jmodel, params=params, params_np=params_np,
                           model=model, kw=kw)


# -- ListDataloader and LaggedConsumer --------------------------------------------

class _Docs:
    """Document i holds i % 4 + 1 chunks ``(i, j)``; reading ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad, self.reads = n, bad, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.reads += 1
        if i == self.bad:
            raise KeyError(f"document {i} is corrupt")
        return [(i, j) for j in range(i % 4 + 1)]


@pytest.mark.parametrize("shuffle", [False, True])
def test_list_dataloader_order_matches_jax(shuffle):
    kw = dict(batch_size=5, n_jobs=3, buffer_size=7, shuffle=shuffle, seed=4)
    got = list(ListDataloader(_Docs(23), **kw))
    want = list(JaxListDataloader(_Docs(23), **kw))
    assert got == want and sum(map(len, got)) == sum(i % 4 + 1 for i in range(23))
    assert all(len(b) == 5 for b in got[:-1])
    collated = list(ListDataloader(_Docs(23), collate_fun=len, **kw))
    assert collated == [len(b) for b in got]


def test_list_dataloader_surfaces_errors_and_stops_early():
    loader = ListDataloader(_Docs(30, bad=11), batch_size=4, n_jobs=2)
    with pytest.raises(DataLoaderWorkerError, match="document 11 is corrupt") as e:
        list(loader)
    assert "worker traceback" in str(e.value) and "__getitem__" in str(e.value)
    before = threading.active_count()
    docs = _Docs(5000)
    it = iter(ListDataloader(docs, batch_size=2, n_jobs=2, buffer_size=4))
    assert next(it) == [(0, 0), (1, 0)]
    it.close()   # the producer stops: no thread is left behind
    assert threading.active_count() <= before
    # reads run a bounded window ahead of the queue, not the whole dataset
    assert docs.reads <= 4 + 4 + 2


@pytest.mark.parametrize("depth,total", [
    (1, None), (2, None), (2, 7), (3, None), (1, 9), (3, 5)])
def test_lagged_consumer_matches_jax(depth, total):
    runs = []
    for cls in (LaggedConsumer, JaxLaggedConsumer):
        log = []
        lag = cls(lambda *a: log.append(("call",) + a), total=total,
                  depth=depth)
        for i in range(9):
            lag.feed(i, -i)
            log.append(("fed", i))
        lag.flush()
        lag.flush()
        runs.append(log)
    assert runs[0] == runs[1]
    assert sum(entry[0] == "call" for entry in runs[0]) == 9


# -- the predictor ------------------------------------------------------------------

def _chunk_datasets(s):
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              doc_stride=16, split_by_sentence=True, truncate=True)
    idx = np.arange(len(s.out[1]))
    return (JaxChunkDataset(s.tmp / "proc", s.jtok, idx, **kw),
            ChunkDataset(s.tmp / "proc", s.ttok, idx, **kw))


def _jax_logits(s, item):
    collate = jax_init_collate(s.jtok, max_seq_len=MAX_SEQ_LEN)
    inputs, _ = collate([item])
    out = s.jmodel.apply({"params": s.params}, inputs["input_ids"],
                         inputs["attention_mask"], inputs["token_type_ids"])
    return {k: np.asarray(out[k][0]) for k in ("start_class", "end_class")}


def _top_two_gap(logits):
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("mode", ["padmax", "buckets", "fetch_every"])
def test_predictor_matches_jax(setup, mode):
    s = setup
    jds, tds = _chunk_datasets(s)
    kw = dict(batch_size=8, n_jobs=2, buffer_size=64)
    if mode == "buckets":
        kw["length_buckets"] = [32, 48, MAX_SEQ_LEN]
    # JAX groups 3 fetches; the port copies each batch on its own
    jkw = dict(kw, fetch_every=3) if mode == "fetch_every" else kw
    jp = JaxPredictor(
        s.jmodel, s.params, mesh=build_mesh("data:1"),
        collate_fun=jax_init_collate(s.jtok, max_seq_len=MAX_SEQ_LEN,
                                     return_items=True), **jkw)
    jp(jds, save_dump=True)
    tp = Predictor(s.model, collate_fun=init_collate_fun(
        s.ttok, max_seq_len=MAX_SEQ_LEN, return_items=True), **kw)
    assert tp._wire_ids_only and tp.device.type == "cpu"
    tp(tds, save_dump=True)

    # per chunk, in the same order
    assert len(tp.dump) == len(jp.dump) > 2
    near_ties = n_chunks = 0
    for (js, jst, jen, jlab, jit), (ts, tst, ten, tlab, tit) in zip(
            jp.dump, tp.dump):
        assert [(i.item_id, i.chunk_start) for i in jit] == [
            (i.item_id, i.chunk_start) for i in tit]
        np.testing.assert_allclose(ts, js, atol=SCORE_ATOL, rtol=0)
        assert np.array_equal(tlab, jlab)
        for r, item in enumerate(tit):
            n_chunks += 1
            if (tst[r], ten[r]) != (jst[r], jen[r]):
                logits = _jax_logits(s, item)
                key = "start_class" if tst[r] != jst[r] else "end_class"
                assert _top_two_gap(logits[key]) < SCORE_ATOL, (item.item_id,
                                                                key)
                near_ties += 1
    assert n_chunks == tp.stats["chunks"] > len(tds)
    assert near_ties <= n_chunks // 20, near_ties

    # per document
    assert set(tp.candidates) == set(jp.candidates) and tp.candidates
    for doc_id, want in jp.candidates.items():
        got = tp.candidates[doc_id]
        assert isinstance(got, PredictorCandidate)
        assert got.label == want.label
        if (got.start_id, got.end_id) != (want.start_id, want.end_id):
            near_ties += 1
        assert abs(tp.scores[doc_id] - jp.scores[doc_id]) <= SCORE_ATOL
        assert abs(got.start_reg - want.start_reg) <= SCORE_ATOL
    assert near_ties <= n_chunks // 20
    assert tp.stats["documents"] == len(tds) and tp.stats["batches"] == len(
        tp.dump)
    tp.show_predictions(n_docs=2)


def test_predictor_limit_and_partial_batch(setup):
    s = setup
    _, tds = _chunk_datasets(s)
    collate = init_collate_fun(s.ttok, max_seq_len=MAX_SEQ_LEN,
                               return_items=True)
    limited = Predictor(s.model, collate_fun=collate, batch_size=4, n_jobs=2,
                        limit=1)(tds, save_dump=True)
    # the JAX count: batches 0 and 1
    assert limited.stats["batches"] == 2 == len(limited.dump)
    whole = Predictor(s.model, collate_fun=collate, batch_size=4096,
                      n_jobs=2)(tds, save_dump=True)
    assert whole.stats["batches"] == 1
    # the padded rows of the one partial batch leak no phantom items
    assert len(whole.dump[0][-1]) == whole.stats["chunks"]
    assert set(whole.items) == set(whole.candidates)


def test_predictor_three_plane_wire_matches_ids_wire(setup):
    """A collate_fun with no bound tokenizer sends the [3, B, L] int32
    wire (``infer.score.score_wire``): every chunk scores as on the
    ids-only wire, bit for bit."""
    s = setup
    _, tds = _chunk_datasets(s)
    collate = init_collate_fun(s.ttok, max_seq_len=MAX_SEQ_LEN,
                               return_items=True)
    kw = dict(batch_size=8, n_jobs=1)
    ids = Predictor(s.model, collate_fun=collate, **kw)
    three = Predictor(s.model, collate_fun=lambda items: collate(items), **kw)
    assert ids._wire_ids_only and not three._wire_ids_only
    ids(tds, save_dump=True)
    three(tds, save_dump=True)
    assert len(ids.dump) == len(three.dump) > 2
    for a, b in zip(ids.dump, three.dump):
        assert [i.item_id for i in a[-1]] == [i.item_id for i in b[-1]]
        for x, y in zip(a[:-1], b[:-1]):
            assert np.array_equal(x, y)
    assert ids.candidates == three.candidates and ids.candidates


def test_ids_wire_guard_rejects_pad_at_a_valid_position():
    ids = np.array([[2, 0, 3, 0]])
    with pytest.raises(ValueError, match="ids-only wire"):
        Predictor._check_ids_wire(ids, np.array([[1, 1, 1, 0]]), 0)
    Predictor._check_ids_wire(ids, np.array([[1, 0, 1, 0]]), 0)


# -- the NQ trainer against JAX's ---------------------------------------------------

def _tp(**kw):
    base = dict(loss="ce", smooth_alpha=0.01, focal_alpha=1.0, focal_gamma=2.0,
                w_start=1, w_end=1, w_start_reg=0.5, w_end_reg=0.5, w_cls=1,
                lr=1e-3, weight_decay=0.01, warmup_coef=0.3, optimizer="adam",
                finetune=False, best_metric="map", best_order=">")
    base.update(kw)
    return SimpleNamespace(**base)


def test_nq_trainer_losses_match_jax_trainer(setup):
    s = setup
    counter, _, (train_idx, train_labels, _, _) = s.out
    sampler = np.asarray([1 / counter[lab] for lab in train_labels])
    label_w = np.asarray([1 / counter[k] for k in sorted(counter)])
    weights = {"label_weights": label_w / label_w.sum(),
               "sampler_weights": sampler / sampler.sum()}
    data_kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
                   doc_stride=16, split_by_sentence=True, truncate=True)
    jds = JaxSplitDataset(s.tmp / "proc", s.jtok, train_idx,
                          rng=JaxRngPool(0).host_rng("chunk_sampling"),
                          **data_kw)
    tds = SplitDataset(s.tmp / "proc", s.ttok, train_idx,
                       rng=RngPool(0).host_rng("chunk_sampling"), **data_kw)
    loop = dict(n_epochs=1, train_batch_size=4, batch_split=2, n_jobs=1,
                warmup_coef=0.3, max_grad_norm=0.5, seed=0,
                train_weights=weights, length_buckets=[32, 64])
    j_running, t_running = [], []
    mesh = build_mesh("data:1")
    jt = JaxTrainer(
        model=JaxQAModel(JaxEncoderConfig(vocab_size=len(s.jtok), **s.kw),
                         attention_impl="xla", mesh=mesh),
        params=s.params, loss=jax_build_loss(_tp(), weights),
        collate_fun=jax_init_collate(s.jtok, max_seq_len=MAX_SEQ_LEN),
        trainer_params=_tp(), train_dataset=jds, mesh=mesh,
        hbm_preflight=False,
        on_train_metrics=lambda m, step: j_running.append(
            (step, m["loss"](), float(m["lr"]))), **loop)
    jt.train()
    model = QAModel(EncoderConfig(vocab_size=len(s.ttok), **s.kw),
                    dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(s.params_np), strict=True)
    tt = Trainer(model, build_loss(_tp(), weights),
                 init_collate_fun(s.ttok, max_seq_len=MAX_SEQ_LEN),
                 trainer_params=_tp(), train_dataset=tds,
                 on_train_metrics=lambda m, step: t_running.append(
                     (step, m["loss"](), float(m["lr"]))), **loop)
    assert tt.planned_steps_per_epoch == tt.train_dataloader.planned_epoch_steps(1)
    tt.train()
    assert len(t_running) == len(j_running) >= 4
    assert [x[0] for x in t_running] == [x[0] for x in j_running]
    np.testing.assert_allclose([x[1] for x in t_running],
                               [x[1] for x in j_running], rtol=1e-5)
    assert [x[2] for x in t_running] == [x[2] for x in j_running]
    rows = {h["rows"] for h in tt.history}
    assert len(rows) >= 2   # bucket batches of several sizes


# -- the CLIs -------------------------------------------------------------------------

_ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _start(module, *args):
    """A CLI run in a process of its own, its stderr into a file (several
    run side by side)."""
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=str(REPO), env=_ENV,
                            stdout=subprocess.DEVNULL, stderr=err, text=True)
    return proc, err


def _finish(started):
    proc, err = started
    try:
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err.seek(0)
    log = err.read()
    err.close()
    assert proc.returncode == 0, log[-4000:]
    return log


def _run(module, *args):
    return _finish(_start(module, *args))


def _metrics(text):
    return re.findall(r"Test metrics after epoch -?\d+ - (.*)", text)


@pytest.fixture(scope="module")
def cli_run(setup):
    s = setup
    common = ["--model", "bert-tiny", "--device", "cpu", "--vocab_file",
              str(s.tmp / "vocab.txt"), "--data_path", str(s.raw),
              "--processed_data_path", str(s.tmp / "cli_proc"),
              "--max_question_len", str(MAX_Q_LEN), "--n_jobs", "2"]
    dump = s.tmp / "results"
    train_log = _run(
        "ml_recipe_tpu_torch.cli.train", *common, "--max_seq_len",
        str(MAX_SEQ_LEN), "--doc_stride", "16", "--split_by_sentence",
        "--truncate", "--train_label_weights", "--train_sampler_weights",
        "--dump_dir", str(dump), "--experiment_name", "nq", "--n_epochs", "2",
        "--train_batch_size", "8", "--test_batch_size", "4", "--batch_split",
        "2", "--lr", "1e-3", "--warmup_coef", "0.1", "--seed", "0",
        "--length_buckets", "auto", "--device_prefetch", "2")
    ckpt = dump / "nq" / "last.ch"
    # the three readers of last.ch run side by side
    procs = {"train_metrics": _start(
        "ml_recipe_tpu_torch.cli.train_metrics", *common, "--max_seq_len",
        str(MAX_SEQ_LEN), "--doc_stride", "16", "--split_by_sentence",
        "--truncate", "--checkpoint", str(ckpt), "--batch_size", "4",
        "--length_buckets", "auto")}
    # init_validation_dataset chunks at the dataset's own max_seq_len 384,
    # as the JAX package's does: the collate takes 384 too
    for name, extra in _VALIDATE.items():
        procs[name] = _start("ml_recipe_tpu_torch.cli.validate", *common,
                             "--max_seq_len", "384", "--checkpoint", str(ckpt),
                             "--batch_size", "2", *extra)
    logs = {name: _finish(proc) for name, proc in procs.items()}
    return SimpleNamespace(common=common, train_log=train_log, ckpt=ckpt,
                           logs=logs)


_VALIDATE = {"bf16": [], "int8": ["--quantize", "int8", "--ln_impl", "fused"]}


def test_cli_trains_on_a_corpus_and_train_metrics_reproduces_it(cli_run):
    assert "Dummy dataset" not in cli_run.train_log
    assert "LR schedule sized from the planned epoch step count" in cli_run.train_log
    train_lines = _metrics(cli_run.train_log)
    assert len(train_lines) == 2 and cli_run.ckpt.exists()
    log = cli_run.logs["train_metrics"]
    assert log.index("Train dataset validation") < log.index(
        "Test dataset validation")
    lines = _metrics(log)
    assert len(lines) == 2
    # the test split's line, digit for digit
    assert lines[1] == train_lines[-1]


@pytest.mark.parametrize("extra", list(_VALIDATE), ids=list(_VALIDATE))
def test_cli_validate_scores_every_document(cli_run, extra):
    log = cli_run.logs[extra]
    m = re.search(r"Validation: (\d+) of (\d+) documents, (\d+) chunks in "
                  r"(\d+) batches, (\d+) candidates", log)
    assert m, log[-2000:]
    docs, total, chunks, batches, _ = map(int, m.groups())
    assert docs == total > 0 and chunks >= docs and batches >= 1
    if _VALIDATE[extra]:
        assert "Post-training quantization (int8)" in log


def test_train_metrics_refuses_quantize():
    _, (params, model_params) = get_params(
        (get_predictor_parser, get_model_parser), ["--quantize", "int8"])
    with pytest.raises(ValueError, match="--quantize int8"):
        train_metrics.main(params, model_params)


@pytest.mark.parametrize("flag", [
    ["--mesh", "data:2"], ["--mesh", "data:2,model:2"]])
def test_unported_predict_flags_raise(flag):
    _, (params, model_params) = get_params(
        (get_predictor_parser, get_model_parser), flag)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_predict_flags(params, model_params)


@pytest.mark.parametrize("flag,splitting,segments,min_fragment", [
    (["--sequence_packing", "on"], "off", 8, 32),
    (["--sequence_packing", "on", "--pack_splitting", "fill",
      "--pack_max_segments", "3", "--pack_min_fragment", "4"], "fill", 3, 4),
], ids=["packing", "splitting"])
def test_packing_predict_flags_are_accepted_and_act(tmp_path, flag, splitting,
                                                    segments, min_fragment):
    """Sequence packing is ported: the flags pass the check and reach the
    Predictor, which packs (its split planner takes the values given)."""
    _, (params, model_params) = get_params(
        (get_predictor_parser, get_model_parser),
        [*flag, "--length_buckets", "auto"])
    check_predict_flags(params, model_params)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                "[MASK]", "a", "b"]) + "\n")
    from ml_recipe_tpu_torch.tokenizer import Tokenizer

    model = QAModel(EncoderConfig(vocab_size=7, hidden_size=8, num_layers=1,
                                  num_heads=2, intermediate_size=16,
                                  max_position_embeddings=64), device="cpu")
    predictor = Predictor(
        model, collate_fun=init_collate_fun(Tokenizer("bert", str(vocab)),
                                            max_seq_len=64),
        length_buckets=params.length_buckets,
        sequence_packing=params.sequence_packing,
        pack_max_segments=params.pack_max_segments,
        pack_splitting=params.pack_splitting,
        pack_min_fragment=params.pack_min_fragment)
    assert predictor._packing and predictor._seq_grid is None
    assert (predictor._pack_splitting, predictor._pack_max_segments,
            predictor._pack_min_fragment) == (splitting, segments,
                                              min_fragment)


def test_predictor_parser_accepts_the_jax_flags():
    _, (params, model_params) = get_params(
        (get_predictor_parser, get_model_parser),
        ["-c", str(REPO / "config" / "validate.cfg"), "--gpu_compat",
         "--mesh", "data:1", "--fetch_every", "4"])
    check_predict_flags(params, model_params)
    assert params.fetch_every == 4        # accepted and logged: no effect
    assert (params.batch_size, params.max_seq_len, params.doc_stride,
            params.limit, params.quantize, params.length_buckets) == (
        16, 512, 128, 100, "off", "off")
    assert params.split_by_sentence and params.truncate and params.gpu_compat
