"""Data parallelism's pieces in one process, against the JAX package.

- the samplers: the port's ``ShardedBatchSampler`` at ``(rank, W)`` yields
  the JAX one's slices for every rank, W in {2, 4}, shuffled, weighted and
  ``pad_last``; the slices tile the one-process batches. Exact;
- the bucketed loader on an NQ corpus: each rank's batches of the port's
  ``BucketedDataLoader`` over a ``(rank, 2)`` sampler equal the JAX
  loader's (its ``_iter_oracle``): ids, masks, labels, seq, rows and
  ``real_rows``, and the planned step counts; ``oracle_read`` gives the
  JAX package's chunk picks for each ``(epoch, index)``. Exact;
- the losses: a micro-batch with no-answer spans (-1) and label weights,
  split over two ranks whose losses divide by the summed denominators,
  sums to the JAX loss over the whole micro-batch (rtol 1e-6, f32), and
  its gradients concatenate to JAX's; without denominators every loss is
  the formula it was before denominators existed, bit for bit;
- dropout: a rank's rows of the plain attention with their global row
  seeds equal those rows of the whole call at rate 0.1 (exact), and a
  model's forward on a rank's rows with ``global_rows`` equals those rows
  of the whole forward, hidden dropout included;
- ``regroup_for_world``, the rank devices and backends, and the flags
  still refused at world size 2 (they name their ROADMAP item).
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ml_recipe_tpu.data.bucketing import BucketedDataLoader as JaxBucketedLoader
from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import SplitDataset as JaxSplitDataset
from ml_recipe_tpu.data.loader import ShardedBatchSampler as JaxSampler
from ml_recipe_tpu.data.packing import oracle_read as jax_oracle_read
from ml_recipe_tpu.data.preprocessor import RawPreprocessor as JaxPreprocessor
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.parallel.sharding import split_micro as jax_split_micro
from ml_recipe_tpu.utils.seed import RngPool as JaxRngPool
from ml_recipe_tpu_torch.config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.data.bucketing import BucketedDataLoader
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import SplitDataset
from ml_recipe_tpu_torch.data.loader import ShardedBatchSampler
from ml_recipe_tpu_torch.data.packing import oracle_read
from ml_recipe_tpu_torch.data.preprocessor import RawPreprocessor
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.losses import losses as port_losses
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, init_weights
from ml_recipe_tpu_torch.ops.attention import (
    dot_product_attention,
    global_row_seeds,
)
from ml_recipe_tpu_torch.parallel import dist as pdist
from ml_recipe_tpu_torch.parallel import regroup_for_world
from ml_recipe_tpu_torch.utils.seed import RngPool

from helpers import write_vocab
from test_torch_nq_data import (
    DOC_STRIDE,
    MAX_Q_LEN,
    MAX_SEQ_LEN,
    _same,
    tokenizers,
    write_mixed_corpus,
)

# -- samplers ---------------------------------------------------------------------

SAMPLER_MODES = {
    "shuffled": dict(shuffle=True, drop_last=True),
    "weighted": dict(shuffle=True, drop_last=True,
                     weights=np.linspace(1.0, 3.0, 37)),
    "pad_last": dict(shuffle=False, drop_last=False, pad_last=True),
}


@pytest.mark.parametrize("mode", list(SAMPLER_MODES))
@pytest.mark.parametrize("world", [2, 4])
def test_sampler_slices_match_jax(world, mode):
    kw = dict(SAMPLER_MODES[mode], seed=5)
    whole = ShardedBatchSampler(37, 8, **kw)
    for epoch in (1, 2):
        slices = []
        for rank in range(world):
            shard = dict(process_index=rank, process_count=world)
            ours = list(ShardedBatchSampler(37, 8, **kw, **shard)(epoch))
            theirs = list(JaxSampler(37, 8, **kw, **shard)(epoch))
            assert len(ours) == len(theirs) > 0
            for a, b in zip(ours, theirs):
                assert a.shape == (8 // world,) and np.array_equal(a, b)
            slices.append(ours)
        # rank-order slices tile the one-process batches
        for b, batch in enumerate(whole(epoch)):
            assert np.array_equal(np.concatenate([s[b] for s in slices]),
                                  batch)


# -- the bucketed loader under the length oracle -------------------------------------

GRID = [32, 56, MAX_SEQ_LEN]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nq_ddp")
    raw = write_mixed_corpus(tmp)
    jtok, ttok = tokenizers(tmp)
    JaxPreprocessor(raw, tmp / "jax_proc")()
    return SimpleNamespace(tmp=tmp, jtok=jtok, ttok=ttok,
                           tout=RawPreprocessor(raw, tmp / "port_proc")())


def _split_pair(corpus, indexes, *, test):
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              doc_stride=DOC_STRIDE, test=test, split_by_sentence=True,
              truncate=True)
    return (JaxSplitDataset(corpus.tmp / "jax_proc", corpus.jtok, indexes,
                            rng=JaxRngPool(0).host_rng("chunk_sampling"), **kw),
            SplitDataset(corpus.tmp / "port_proc", corpus.ttok, indexes,
                         rng=RngPool(0).host_rng("chunk_sampling"), **kw))


@pytest.mark.parametrize("pad_last", [False, True], ids=["train", "eval"])
def test_bucketed_rank_batches_match_jax_oracle(corpus, pad_last):
    counter, _, (train_idx, train_labels, test_idx, _) = corpus.tout
    indexes = test_idx if pad_last else train_idx
    weights = None
    if not pad_last:
        weights = np.asarray([1 / counter[label] for label in train_labels])
        weights = weights / weights.sum()
    sampler_kw = dict(shuffle=not pad_last, drop_last=not pad_last,
                      pad_last=pad_last, weights=weights, seed=3)
    batch, world = 4, 2
    kw = dict(seq_grid=GRID, token_budget=batch * MAX_SEQ_LEN,
              batch_multiple=world if pad_last else 2 * world, n_jobs=2,
              pad_last=pad_last)
    ranks = []
    for rank in range(world):
        jds, tds = _split_pair(corpus, indexes, test=pad_last)
        shard = dict(process_index=rank, process_count=world)
        jl = JaxBucketedLoader(
            jds, JaxSampler(len(jds), batch, **sampler_kw, **shard),
            jax_make_collate(corpus.jtok, max_seq_len=MAX_SEQ_LEN), **kw)
        tl = BucketedDataLoader(
            tds, ShardedBatchSampler(len(tds), batch, **sampler_kw, **shard),
            make_collate_fun(corpus.ttok, max_seq_len=MAX_SEQ_LEN), **kw)
        planned = tl.planned_epoch_steps(1)
        assert planned == jl.planned_epoch_steps(1) > 0
        jl.set_epoch(1)
        tl.set_epoch(1)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert (a.seq, a.real_rows, a.rows) == (b.seq, b.real_rows, b.rows)
            assert b.inputs["input_ids"].shape == (b.rows // world, b.seq)
            for key in a.inputs:
                assert np.array_equal(a.inputs[key], b.inputs[key]), key
            for key in a.labels:
                assert np.array_equal(a.labels[key], b.labels[key]), key
        ranks.append((planned, [(b.seq, b.rows, b.real_rows) for b in tb]))
    # every rank planned the same steps and the same global batches
    assert ranks[0] == ranks[1]
    assert len({seq for seq, _, _ in ranks[0][1]}) >= 2


def test_oracle_read_matches_jax_chunk_picks(corpus):
    _, _, (train_idx, _, _, _) = corpus.tout
    jds, tds = _split_pair(corpus, train_idx, test=False)
    for epoch in (0, 1, 2):
        for index in range(0, len(tds), 3):
            a = jax_oracle_read(jds, index, epoch=epoch)
            b = oracle_read(tds, index, epoch=epoch)
            assert _same(a, b), (epoch, index)
            # a pure function of (epoch, index)
            assert _same(b, oracle_read(tds, index, epoch=epoch))
    # the training draw stream was not touched
    assert jds.rng.random() == tds.rng.random()


# -- global loss denominators --------------------------------------------------------

def _tp(loss):
    return SimpleNamespace(loss=loss, smooth_alpha=0.01, focal_alpha=1.0,
                           focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                           w_end_reg=0.5, w_cls=1)


def _micro_batch():
    rng = np.random.default_rng(21)
    n, seq = 8, 12
    preds = {"start_class": rng.normal(size=(n, seq)) * 3,
             "end_class": rng.normal(size=(n, seq)) * 3,
             "start_reg": rng.random(n), "end_reg": rng.random(n),
             "cls": rng.normal(size=(n, 5)) * 2}
    targets = {
        # rank 1's half has one valid start target, rank 0's three
        "start_class": np.array([0, 3, -1, 9, -1, -1, 2, -1], np.int32),
        "end_class": np.array([-1, -1, -1, -1, 4, 11, 2, 5], np.int32),
        "start_reg": rng.random(n), "end_reg": rng.random(n),
        "cls": np.array([0, 4, 4, 2, 1, 3, 0, 4], np.int32),
    }
    f32 = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
           for k, v in preds.items()}
    return f32, {k: v.astype(np.float32) if v.dtype.kind == "f" else v
                 for k, v in targets.items()}


@pytest.mark.parametrize("kind", ["ce", "smooth", "focal"])
def test_global_denominators_sum_to_the_whole_micro_batch_loss(kind):
    label_weights = {"label_weights": np.array([0.1, 0.3, 0.2, 0.25, 0.15])}
    preds, targets = _micro_batch()
    jloss = jax_build_loss(_tp(kind), label_weights)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    j_total, j_values = jloss({k: jnp.asarray(v) for k, v in preds.items()}, jt)
    j_grads = jax.grad(lambda p: jloss(p, jt)[0])(
        {k: jnp.asarray(v) for k, v in preds.items()})

    loss = build_loss(_tp(kind), label_weights)
    halves = [slice(0, 4), slice(4, 8)]
    t_targets = [{k: torch.from_numpy(v[h]) for k, v in targets.items()}
                 for h in halves]
    t_preds = [{k: torch.from_numpy(v[h]).requires_grad_()
                for k, v in preds.items()} for h in halves]
    denominators = sum(loss.denominators(t) for t in t_targets)
    summed = {}
    for p, t in zip(t_preds, t_targets):
        total, values = loss(p, t, denominators)
        total.backward()
        for k, v in values.items():
            summed[k] = summed.get(k, 0.0) + float(v.detach())
    assert set(summed) == set(j_values)
    for key, value in summed.items():
        np.testing.assert_allclose(value, float(j_values[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    for key in preds:
        grad = torch.cat([p[key].grad for p in t_preds]).numpy()
        np.testing.assert_allclose(grad, np.asarray(j_grads[key]), atol=1e-6,
                                   err_msg=key)


def _before(logits, targets, kind, ignore_index, class_weights=None,
            n_classes=5, smoothing=0.01, alpha=1.0, gamma=2.0):
    """Each loss as it was computed before global denominators (the
    formulas, as written then)."""
    if kind == "mse":
        return torch.mean((logits.float() - targets.float()) ** 2)
    log_probs = F.log_softmax(logits.float(), dim=-1)
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))

    def pick(x, t):
        return torch.gather(x, -1, t.long()[..., None])[..., 0]

    if kind == "focal":
        picked = -pick(alpha * (1 - torch.exp(log_probs)) ** gamma * log_probs,
                       safe)
        valid_f = valid.float()
        return torch.sum(picked * valid_f) / torch.clamp(torch.sum(valid_f),
                                                         min=1.0)
    if kind == "smooth":
        fill = smoothing / (n_classes - 1)
        dist = torch.full((targets.shape[0], n_classes), fill)
        t = targets.long()
        t = torch.where(t < 0, t + n_classes, t)
        hit = (t >= 0) & (t < n_classes)
        dist[torch.arange(targets.shape[0])[hit], t[hit]] = 1.0 - smoothing
        t_log_t = torch.where(dist > 0, dist * torch.log(dist),
                              torch.zeros_like(dist))
        return torch.mean(torch.sum(t_log_t - dist * log_probs, dim=-1))
    nll = -pick(log_probs, safe)
    if class_weights is not None:
        w = class_weights[safe.long()] * valid
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)
    valid_f = valid.float()
    return torch.sum(nll * valid_f) / torch.clamp(torch.sum(valid_f), min=1.0)


def test_without_denominators_every_loss_is_bit_identical_to_before():
    preds, targets = _micro_batch()
    p = {k: torch.from_numpy(v) for k, v in preds.items()}
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    cw = torch.tensor([0.1, 0.3, 0.2, 0.25, 0.15])
    cases = [
        (port_losses.cross_entropy_with_ignore(p["start_class"],
                                               t["start_class"]),
         _before(p["start_class"], t["start_class"], "ce", -1)),
        (port_losses.cross_entropy_with_ignore(p["cls"], t["cls"],
                                               class_weights=cw),
         _before(p["cls"], t["cls"], "ce", -1, class_weights=cw)),
        (port_losses.focal_loss(p["cls"], t["cls"], ignore_index=4),
         _before(p["cls"], t["cls"], "focal", 4)),
        (port_losses.label_smoothing_loss(p["cls"], t["cls"], n_classes=5,
                                          smoothing=0.01),
         _before(p["cls"], t["cls"], "smooth", -100)),
        (port_losses.mse_loss(p["start_reg"], t["start_reg"]),
         _before(p["start_reg"], t["start_reg"], "mse", None)),
    ]
    for got, want in cases:
        assert torch.equal(got, want)


# -- dropout of a rank's rows ----------------------------------------------------------

def test_rank_rows_draw_the_global_attention_dropout():
    g = torch.Generator().manual_seed(0)
    B, L, H, D = 8, 40, 2, 16
    q, k, v = (torch.randn(B, L, H, D, generator=g) for _ in range(3))
    mask = torch.ones(B, L, dtype=torch.int32)
    mask[5, 30:] = 0
    seed = torch.tensor([987654321], dtype=torch.int32)
    whole = dot_product_attention(q, k, v, mask, dropout_rate=0.1, seed=seed,
                                  impl="auto")
    for world in (2, 4, 8):
        m = B // world
        for rank in range(world):
            rows = slice(rank * m, (rank + 1) * m)
            part = dot_product_attention(
                q[rows], k[rows], v[rows], mask[rows], dropout_rate=0.1,
                seed=global_row_seeds(seed, rank * m, m, B, H), impl="auto")
            assert torch.equal(part, whole[rows]), (world, rank)


def test_rank_rows_draw_the_global_hidden_dropout(tmp_path):
    cfg = EncoderConfig(vocab_size=90, hidden_size=32, num_layers=2,
                        num_heads=2, intermediate_size=64,
                        max_position_embeddings=32, hidden_dropout_prob=0.1,
                        attention_probs_dropout_prob=0.1)
    model = QAModel(cfg, dtype=torch.float32, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    model.train()
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 90, (4, 24)))
    mask = torch.ones(4, 24, dtype=torch.int32)
    mask[3, 17:] = 0

    def forward(rows, global_rows):
        gen = torch.Generator().manual_seed(11)
        out = model(ids[rows], mask[rows], generator=gen,
                    global_rows=global_rows)
        return out, gen.get_state()

    whole, state = forward(slice(0, 4), None)
    for rank in range(2):
        rows = slice(2 * rank, 2 * rank + 2)
        part, part_state = forward(rows, (2 * rank, 4))
        assert torch.equal(part_state, state)   # the generators stay in step
        for key in whole:
            np.testing.assert_allclose(part[key].detach(),
                                       whole[key][rows].detach(), rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    # without the global rows a rank would draw other masks
    other, _ = forward(slice(2, 4), None)
    assert not torch.allclose(other["cls"], whole["cls"][2:4], atol=1e-3)


# -- layout, devices and refusals ------------------------------------------------------

def _jax_global_micro_batches(rows: int, world: int, split: int):
    """The JAX package's order of a global batch's rows in its
    micro-batches: each process splits its local rows with ``split_micro``
    and global micro-batch g is, in process order, every process's local
    micro-batch g (``make_global_array(..., batch_axis=1)``)."""
    local = np.arange(rows).reshape(world, rows // world)
    micro = [jax_split_micro(local[r], split) for r in range(world)]
    return np.concatenate([np.concatenate([m[g] for m in micro])
                           for g in range(split)]).tolist()


@pytest.mark.parametrize("world,split", [(2, 4), (4, 2), (2, 1)])
def test_regroup_for_world_concatenates_the_ranks_micro_batches(world,
                                                                split):
    batch = {"x": np.arange(16) * 10, "y": {"z": torch.arange(16)}}
    got = regroup_for_world(batch, world, split)
    want = _jax_global_micro_batches(16, world, split)
    assert got["x"].tolist() == [10 * i for i in want]
    assert got["y"]["z"].tolist() == want
    assert regroup_for_world(batch, 1, 4)["x"].tolist() == batch["x"].tolist()
    with pytest.raises(ValueError, match="split"):
        regroup_for_world(batch, 3, 2)


def test_rank_devices_and_backends(monkeypatch):
    assert pdist.resolve_backend("xla", "cpu") == "gloo"
    assert pdist.resolve_backend(None, "cuda:1") == "nccl"
    assert pdist.resolve_backend("nccl", "cuda") == "nccl"
    assert pdist.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="CUDA"):
        pdist.resolve_backend("nccl", "cpu")
    assert pdist.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    # two ranks may share a card: rank % device count, never a refusal
    assert pdist.rank_device("cuda", 3) == torch.device("cuda", 1)
    assert pdist.rank_device(None, 2) == torch.device("cuda", 0)
    assert pdist.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pdist.rank_device("cuda", 0)
    # alone, nothing is joined and every answer is one process's
    assert pdist.initialize_from_params(
        SimpleNamespace(dist_world_size=1)) is None
    assert (pdist.process_index(), pdist.process_count()) == (0, 1)


def _world_args(tmp_path, *extra):
    return ["--model", "bert-tiny", "--device", "cpu", "--dummy_dataset",
            "--vocab_file", str(write_vocab(tmp_path)), "--dump_dir",
            str(tmp_path / "results"), "--dist_world_size", "2",
            "--local_rank", "1", *extra]


@pytest.mark.parametrize("extra,refused", [
    # ZeRO-1 and its bucketed overlap (tests/test_torch_zero1.py,
    # tests/test_torch_zero1_overlap.py), the data and seq axes and the
    # ring (tests/test_torch_sp_train.py) and the elastic world override
    # (tests/test_torch_elastic.py) and the pipe axis
    # (tests/test_torch_pipeline.py) are ported and accepted; the model
    # axis is still refused
    (["--optimizer_sharding", "zero1", "--zero1_overlap", "bucketed"], False),
    (["--shard_optimizer", "--zero1_overlap", "bucketed"], False),
    (["--mesh", "data:1,pipe:2"], False), (["--zero1_overlap", "bucketed"], False),
    (["--flash_attention", "ring", "--mesh", "seq:1,model:2"], True),
    ([], False)], ids=[
    "zero1", "shard_optimizer", "mesh", "zero1_overlap", "ring", "elastic"])
def test_data_parallel_refusals_name_their_roadmap_item(tmp_path, monkeypatch,
                                                        extra, refused):
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), _world_args(tmp_path, *extra))
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_train_flags(params, model_params)
        return
    check_train_flags(params, model_params)   # W = 2 itself is accepted
    if not extra:
        # the elastic supervisor's override: the live world after a host
        # loss is the one checked and joined; a world of 1 joins nothing,
        # and a malformed override is a hard error
        monkeypatch.setenv(pdist.ELASTIC_WORLD_ENV, "1:0")
        check_train_flags(params, model_params)
        assert pdist.initialize_from_params(params) is None
        monkeypatch.setenv(pdist.ELASTIC_WORLD_ENV, "2")
        with pytest.raises(ValueError, match="malformed"):
            check_train_flags(params, model_params)


def test_world_flags_are_checked(tmp_path):
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        [a for a in _world_args(tmp_path) if a not in ("--local_rank", "1")])
    with pytest.raises(ValueError, match="local_rank"):
        check_train_flags(params, model_params)


def test_partial_from_functools_keeps_its_denominator():
    # build_loss's heads are partials: their denominators follow the
    # keywords (the span heads ignore -1, the cls head -100)
    loss = build_loss(_tp("ce"))
    targets = {"start_class": torch.tensor([1, -1, 2]),
               "end_class": torch.tensor([-1, -1, 2]),
               "start_reg": torch.rand(3), "end_reg": torch.rand(3),
               "cls": torch.tensor([0, -100, 1])}
    assert loss.denominators(targets).tolist() == [2.0, 1.0, 3.0, 3.0, 2.0]
    assert isinstance(loss._losses["cls"][0], functools.partial)
