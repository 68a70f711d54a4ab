"""The port's packed training and packed inference against the JAX package's.

- ``Trainer`` with ``sequence_packing`` on, without and with
  ``pack_splitting='fill'``, against the JAX ``Trainer`` (mesh ``data:1``,
  dropout 0 since flax's PRNG cannot be reproduced, two micro-batches, the
  clip active): the same running losses per step (the epoch meters weigh
  each step by its real segments), the same lr, the same end parameters
  and the same packed eval metrics (loss heads, and accuracies from the
  per-chunk arrays read out of the segment planes);
- the packed ``Predictor`` (``build_packed_score_fn`` and, under
  ``fill``, ``FragmentMerger``) against the JAX one on the same chunks:
  the same per-chunk outputs in the same order, and the scoring function
  alone on one packed batch;
- ``cli.validate --sequence_packing on --pack_splitting fill`` against the
  JAX CLI on the same checkpoint: the same candidates and scores;
- two gloo ranks of the packed trainer (``tests/torch_ddp_worker.py``
  ``trainer_packed``) against one process on the same global batches
  (``parallel.regroup_for_world``): step values, gradients, eval metrics
  and parameters, and the replicas bit-identical.

f32 on both sides, in other summation orders.
"""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ml_recipe_tpu.cli import validate as jax_validate
from ml_recipe_tpu.compose import init_collate_fun as jax_init_collate
from ml_recipe_tpu.compose import init_model as jax_init_model
from ml_recipe_tpu.config.parser import get_model_parser as jax_model_parser
from ml_recipe_tpu.config.parser import get_params as jax_get_params
from ml_recipe_tpu.config.parser import (
    get_predictor_parser as jax_predictor_parser,
)
from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import ChunkDataset as JaxChunkDataset
from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.data.packing import SequencePacker as JaxSequencePacker
from ml_recipe_tpu.data.packing import collate_packed as jax_collate_packed
from ml_recipe_tpu.infer import Predictor as JaxPredictor
from ml_recipe_tpu.infer.score import (
    build_packed_score_fn as jax_packed_score_fn,
)
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.train import AccuracyCallback as JaxAccuracy
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.train.checkpoint import save_state_dict as jax_save_state
from ml_recipe_tpu_torch.cli import validate
from ml_recipe_tpu_torch.compose import init_collate_fun
from ml_recipe_tpu_torch.config.parser import (
    get_model_parser,
    get_params,
    get_predictor_parser,
)
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import ChunkDataset
from ml_recipe_tpu_torch.data.packing import (
    PackedDataLoader,
    SequencePacker,
    collate_packed,
)
from ml_recipe_tpu_torch.data.preprocessor import RawPreprocessor
from ml_recipe_tpu_torch.infer.predictor import Predictor
from ml_recipe_tpu_torch.infer.score import (
    PACKED_OUT_KEYS,
    build_packed_score_fn,
)
from ml_recipe_tpu_torch.losses import PackedWeightedLoss, build_loss
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.train.callback import AccuracyCallback
from ml_recipe_tpu_torch.train.trainer import Trainer

import torch_ddp_worker as worker
from test_torch_nq_data import tokenizers, write_mixed_corpus
from torch_ddp_worker import PACKING, VariedDataset, oracle, worker_pairs

MAX_SEQ_LEN, MAX_Q_LEN = 48, 8
# end params after 4 Adam steps (tests/test_torch_train.py's PARAM_ATOL)
PARAM_ATOL = 2e-5
# f32 logits of two layers, other summation orders
SCORE_ATOL = 1e-4
# the DDP pair against the one-process oracle (tests/test_torch_ddp.py)
RTOL, ATOL, DDP_PARAM_ATOL = 1e-5, 1e-7, 2e-6


def _tp(**kw):
    base = dict(loss="smooth", smooth_alpha=0.01, focal_alpha=1.0,
                focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                w_end_reg=0.5, w_cls=1, lr=1e-3, weight_decay=0.01,
                warmup_coef=0.3, optimizer="adam", finetune=False,
                best_metric="map", best_order=">")
    base.update(kw)
    return SimpleNamespace(**base)


def _cfg(kind, vocab_size, L=MAX_SEQ_LEN):
    return kind(vocab_size=vocab_size, hidden_size=16, num_layers=2,
                num_heads=2, intermediate_size=32, max_position_embeddings=L,
                num_labels=5, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module", params=["off", "fill"])
def trained(request, tmp_path_factory):
    """The JAX and the port's packed trainers, 2 epochs from the same
    params on the same items, splitting ``request.param``."""
    tmp = tmp_path_factory.mktemp("packed")
    jtok, ttok = tokenizers(tmp)
    pack = dict(sequence_packing="on", pack_splitting=request.param,
                pack_max_segments=4, pack_min_fragment=4)
    loop = dict(n_epochs=2, train_batch_size=4, test_batch_size=4,
                batch_split=2, n_jobs=2, warmup_coef=0.3, max_grad_norm=0.5,
                seed=0, **pack)
    init = JaxQAModel(_cfg(JaxEncoderConfig, len(jtok))).init(
        jax.random.key(0), np.zeros((1, MAX_SEQ_LEN), np.int32))["params"]
    init_np = jax.tree_util.tree_map(np.asarray, init)
    runs = {}
    for side in ("jax", "port"):
        running = []
        record = (lambda m, step, r=running: r.append(
            (step, m["loss"](), float(m["lr"]))))
        if side == "jax":
            mesh = build_mesh("data:1")
            t = JaxTrainer(
                model=JaxQAModel(_cfg(JaxEncoderConfig, len(jtok)),
                                 attention_impl="xla", mesh=mesh),
                params=init, loss=jax_build_loss(_tp()),
                collate_fun=jax_make_collate(jtok, max_seq_len=MAX_SEQ_LEN),
                trainer_params=_tp(), mesh=mesh, hbm_preflight=False,
                train_dataset=VariedDataset(jtok, 24, 1, item=JaxItem),
                test_dataset=VariedDataset(jtok, 14, 2, item=JaxItem),
                on_train_metrics=record, **loop)
            t.train()
            metrics = t.test(1, callbacks=[JaxAccuracy()])
            params = jax.tree_util.tree_map(np.asarray, t.params)
        else:
            model = QAModel(_cfg(EncoderConfig, len(ttok)), device="cpu")
            model.load_state_dict(from_jax_params(init_np), strict=True)
            t = Trainer(model, build_loss(_tp()),
                        make_collate_fun(ttok, max_seq_len=MAX_SEQ_LEN),
                        trainer_params=_tp(),
                        train_dataset=VariedDataset(ttok, 24, 1),
                        test_dataset=VariedDataset(ttok, 14, 2),
                        on_train_metrics=record, **loop)
            t.train()
            metrics = t.test(1, callbacks=[AccuracyCallback()])
            params = to_jax_params(t.model.state_dict())
        runs[side] = SimpleNamespace(trainer=t, running=running,
                                     metrics=metrics, params=params)
    return SimpleNamespace(splitting=request.param, **runs)


def test_packed_trainer_matches_jax_trainer(trained):
    j, t = trained.jax, trained.port
    loader = t.trainer.train_dataloader
    assert isinstance(loader, PackedDataLoader)
    assert isinstance(t.trainer.loss, PackedWeightedLoss)
    assert len(t.running) == len(j.running) >= 4
    assert [s for s, _, _ in t.running] == [s for s, _, _ in j.running]
    np.testing.assert_allclose([x[1] for x in t.running],
                               [x[1] for x in j.running], rtol=1e-5)
    # the lr: the same f32 schedule, whose division XLA may round 1 ulp
    # apart at some steps
    np.testing.assert_allclose([x[2] for x in t.running],
                               [x[2] for x in j.running], rtol=2e-7)
    # the LR schedule was sized from the packer's plan: the steps taken
    assert (t.trainer.planned_steps_per_epoch
            == j.trainer._planned_steps_per_epoch
            == loader.epoch_stats["batches"])
    jl = jax.tree_util.tree_leaves_with_path(j.params)
    tl = jax.tree_util.tree_leaves_with_path(t.params)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, err_msg=str(path))
    stats = loader.epoch_stats
    assert stats == j.trainer.train_dataloader.epoch_stats
    assert stats["items"] > stats["rows"]            # rows held several
    if trained.splitting == "fill":
        assert stats["split_count"] > 0
    # the meters weigh a step by its real segments: the last epoch's mean
    # of the per-step losses with those weights is the running value
    hist = t.trainer.history[-stats["batches"]:]
    seg = [h["rows"] for h in hist]
    assert len(set(seg)) > 1 and sum(seg) > 4 * len(seg)
    want = sum(h["loss"] * n for h, n in zip(hist, seg)) / sum(seg)
    np.testing.assert_allclose(t.running[-1][1], want, rtol=1e-6)


def test_packed_eval_metrics_match_jax(trained):
    j, t = trained.jax.metrics, trained.port.metrics
    assert set(t) == set(j)
    for key in ("start_class", "end_class", "start_reg", "end_reg", "cls",
                "loss"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-5, err_msg=key)
    for key in ("s_acc", "e_acc", "c_acc"):
        assert t[key] == j[key], key
    # every example of the test split counted once (pad rows and sibling
    # fragments carry no mask)
    assert trained.port.trainer.test_dataloader.epoch_stats["items"] == 14


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pred")
    raw = write_mixed_corpus(tmp)
    jtok, ttok = tokenizers(tmp)
    out = RawPreprocessor(raw, tmp / "proc")()
    L = 64
    jmodel = JaxQAModel(_cfg(JaxEncoderConfig, len(jtok), L + 2))
    params = jmodel.init(jax.random.key(0),
                         np.zeros((1, 8), np.int32))["params"]
    model = QAModel(_cfg(EncoderConfig, len(ttok), L + 2), device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    kw = dict(max_seq_len=L, max_question_len=16, doc_stride=16,
              split_by_sentence=True, truncate=True)
    idx = np.arange(len(out[1]))
    return SimpleNamespace(
        tmp=tmp, raw=raw, jtok=jtok, ttok=ttok, jmodel=jmodel, params=params,
        model=model.eval(), L=L,
        jds=JaxChunkDataset(tmp / "proc", jtok, idx, **kw),
        tds=ChunkDataset(tmp / "proc", ttok, idx, **kw))


def test_packed_score_fn_matches_jax(corpus):
    c = corpus
    batches = []
    for ds, packer_cls, collate in ((c.tds, SequencePacker, collate_packed),
                                    (c.jds, JaxSequencePacker,
                                     jax_collate_packed)):
        packer = packer_cls(c.L, max_segments=4, splitting="fill",
                            min_fragment=4)
        rows = []
        for x in (x for i in range(6) for x in ds[i]):
            rows += packer.add(x, len(x.input_ids), (x.start_id, x.end_id))
        rows += packer.flush()
        batches.append(collate(rows, c.ttok, max_seq_len=c.L, max_segments=4,
                               with_labels=False))
    (inputs, mask), (jin, jmask) = batches
    # the packages collate the same planes
    assert np.array_equal(jmask, mask) and mask.sum() > mask.shape[0]
    for k in inputs:
        assert np.array_equal(jin[k], inputs[k]), k
    planes = np.stack([inputs[k] for k in ("input_ids", "token_type_ids",
                                           "segment_ids", "position_ids")])
    want = np.asarray(jax.jit(jax_packed_score_fn(c.jmodel))(
        c.params, planes, inputs["segment_starts"]))
    with torch.inference_mode():
        got = build_packed_score_fn(c.model)(
            torch.from_numpy(planes), torch.from_numpy(
                inputs["segment_starts"])).numpy()
    assert got.shape == want.shape == (8,) + mask.shape
    m = mask > 0
    for i, key in enumerate(PACKED_OUT_KEYS):
        if key in ("start_ids", "end_ids", "labels"):
            # a span may flip only at a near tie of two logits
            assert (got[i][m] == want[i][m]).mean() > 0.95, key
        else:
            np.testing.assert_allclose(got[i][m], want[i][m],
                                       atol=SCORE_ATOL, err_msg=key)


@pytest.mark.parametrize("splitting", ["off", "fill"])
def test_packed_predictor_matches_jax(corpus, splitting):
    c = corpus
    kw = dict(batch_size=8, n_jobs=2, buffer_size=64, sequence_packing="on",
              pack_max_segments=4, pack_splitting=splitting,
              pack_min_fragment=4)
    jp = JaxPredictor(c.jmodel, c.params, mesh=build_mesh("data:1"),
                      collate_fun=jax_init_collate(
                          c.jtok, max_seq_len=c.L, return_items=True), **kw)
    jp(c.jds, save_dump=True)
    tp = Predictor(c.model, collate_fun=init_collate_fun(
        c.ttok, max_seq_len=c.L, return_items=True), **kw)
    tp(c.tds, save_dump=True)
    assert tp.pack_split_count == jp.pack_split_count
    if splitting == "fill":
        assert tp.pack_split_count > 0
    assert len(tp.dump) == len(jp.dump) > 1
    spans = n = 0
    for (js, jst, jen, jlab, jit), (ts, tst, ten, tlab, tit) in zip(
            jp.dump, tp.dump):
        assert [(i.item_id, i.chunk_start) for i in tit] == [
            (i.item_id, i.chunk_start) for i in jit]
        np.testing.assert_allclose(ts, js, atol=SCORE_ATOL)
        assert np.array_equal(tlab, jlab)
        spans += int((tst != jst).sum() + (ten != jen).sum())
        n += len(tit)
    # a span may flip only at a near tie of two logits
    assert spans <= n // 20
    assert tp.stats["chunks"] == n == sum(len(c.tds[i])
                                          for i in range(len(c.tds)))
    assert tp.stats["segments"] >= n
    assert set(tp.candidates) == set(jp.candidates)
    for doc, want in jp.candidates.items():
        assert abs(tp.scores[doc] - jp.scores[doc]) <= SCORE_ATOL
        assert tp.candidates[doc].label == want.label


def test_packed_validate_cli_matches_jax_cli(corpus, caplog):
    c = corpus
    vocab = str(c.tmp / "vocab.txt")
    args = ["--model", "bert-tiny", "--vocab_file", vocab, "--lowercase",
            "--compute_dtype", "float32", "--data_path", str(c.raw),
            "--processed_data_path", str(c.tmp / "cli_proc"),
            "--max_seq_len", "384", "--max_question_len", "16",
            "--batch_size", "2", "--n_jobs", "2", "--sequence_packing", "on",
            "--pack_splitting", "fill", "--pack_min_fragment", "16",
            "--pack_max_segments", "3"]
    _, (jparams, jmodel_params) = jax_get_params(
        (jax_predictor_parser, jax_model_parser), args)
    _, jax_params, _ = jax_init_model(jmodel_params)
    ckpt = c.tmp / "seeded.ch"
    jax_save_state(ckpt, params=jax_params)
    args += ["--checkpoint", str(ckpt)]
    _, (jparams, jmodel_params) = jax_get_params(
        (jax_predictor_parser, jax_model_parser), args)
    jparams.mesh = "data:1"   # the JAX predictor on one of the CPU devices
    _, (params, model_params) = get_params(
        (get_predictor_parser, get_model_parser), [*args, "--device", "cpu"])
    jp = jax_validate.main(jparams, jmodel_params)
    with caplog.at_level(logging.INFO):
        tp = validate.main(params, model_params)
    assert tp._packing and tp.pack_split_count == jp.pack_split_count > 0
    assert "Sequence packing:" in caplog.text
    assert set(tp.candidates) == set(jp.candidates) and tp.candidates
    for doc, want in jp.candidates.items():
        got = tp.candidates[doc]
        assert (got.start_id, got.end_id, got.label) == (
            want.start_id, want.end_id, want.label), doc
        assert abs(tp.scores[doc] - jp.scores[doc]) <= SCORE_ATOL


def test_two_rank_packed_run_equals_one_process(tmp_path):
    for rc, err in worker_pairs("trainer_packed", out=tmp_path)[0]:
        assert rc == 0, err[-3000:]
    record = [torch.load(tmp_path / "trainer_packed" / f"rank{r}.pt")
              for r in range(2)]
    # each rank held its slice of packed rows: the segment planes
    b = record[0]["batches"][0][0]
    assert b["input_ids"].shape[0] == worker.TRAIN_BATCH // 2
    assert b["segment_starts"].shape[1] == PACKING["pack_max_segments"]
    ref = oracle(tmp_path, record, **PACKING)
    for step, (got, want) in enumerate(zip(record[0]["values"], ref.values)):
        assert got == record[1]["values"][step]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{step} {key}")
    for name, want in ref.grads.items():
        np.testing.assert_allclose(record[0]["grads"][name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name, want in ref.params.items():
        np.testing.assert_allclose(record[0]["params"][name], want,
                                   rtol=RTOL, atol=DDP_PARAM_ATOL,
                                   err_msg=name)
        assert torch.equal(record[0]["params"][name],
                           record[1]["params"][name]), name
    for epoch, (got, want) in enumerate(zip(record[0]["metrics"],
                                            ref.metrics)):
        assert got == record[1]["metrics"][epoch]
        for key in ("start_class", "end_class", "start_reg", "end_reg",
                    "cls", "loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        for key in ("s_acc", "e_acc", "c_acc", "map"):
            assert got[key] == want[key], key
