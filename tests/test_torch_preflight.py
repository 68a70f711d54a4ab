"""The port's memory pre-flight planners against the JAX package's, on the
CPU, under the same fakes (the JAX tests' own: a ``compile_fn`` whose
``memory_analysis()`` reports chosen bytes, and ``limit_bytes``).

- serving: ``QAEngine.warmup`` drops the buckets that do not fit, keeps the
  last one and stands down without a limit, with the same ``buckets``,
  ``dropped`` and ``preflight`` as the JAX engine, and the shrunk grid
  still answers as the JAX engine does;
- training: ``next_batch_split`` equals the JAX ``_next_batch_split`` over
  a grid of batch sizes, splits, process counts and data axes;
  ``preflight_train_step`` and ``preflight_bucket_steps`` give the JAX
  trainer's reports, splits and rescaled ``loader.batch_sizes``;
- the real probe (one forward and backward, no update) runs on the CPU with
  a stand-in for the CUDA allocator's numbers, and a run whose plan fits is
  bit-identical to the same run with the pre-flight off, with dropout on;
- with two processes the ranks agree on the largest need.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import DummyDataset as JaxDummyDataset
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.serve.bucketing import Bucket as JaxBucket
from ml_recipe_tpu.serve.bucketing import BucketGrid as JaxBucketGrid
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import DummyDataset
from ml_recipe_tpu_torch.data.labels import labels2id
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
)
from ml_recipe_tpu_torch.serve.bucketing import Bucket, BucketGrid
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train.trainer import Trainer, next_batch_split
from ml_recipe_tpu_torch.utils import hbm

from helpers import write_vocab

REPO = Path(__file__).resolve().parents[1]

MAX_SEQ_LEN, MAX_Q_LEN = 48, 12

_QUESTION = "what is the capital of england ?"
_DOCUMENT = ("<P> London is the capital of England . </P> "
             "<P> Big Ben was built in the city . </P>")


# -- serving ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_stack(tmp_path_factory):
    vocab = str(write_vocab(tmp_path_factory.mktemp("preflight_serve")))
    jtok = JaxTokenizer("bert", vocab, lowercase=True)
    tok = Tokenizer("bert", vocab, lowercase=True)
    kw = dict(vocab_size=len(tok), hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, max_position_embeddings=66, num_labels=5)
    jmodel = JaxQAModel(JaxEncoderConfig(**kw))
    params = jmodel.init(jax.random.key(0),
                         np.zeros((1, 8), np.int32))["params"]
    model = QAModel(EncoderConfig(**kw), device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return SimpleNamespace(jtok=jtok, tok=tok, jmodel=jmodel, params=params,
                           model=model,
                           common=dict(max_batch_delay_ms=5, queue_size=64,
                                       max_question_len=16, doc_stride=24))


def _fake_program_fn(bytes_per_row):
    """The JAX test's fake: a bucket's need is its rows x ``bytes_per_row``."""
    def compile_fn(bucket):
        class _Compiled:
            def memory_analysis(self):
                return SimpleNamespace(
                    argument_size_in_bytes=bucket.batch * bytes_per_row,
                    output_size_in_bytes=0, temp_size_in_bytes=0,
                    alias_size_in_bytes=0)
        return _Compiled()
    return compile_fn


def _engines(stack, spec):
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    jengine = JaxQAEngine(stack.jmodel, stack.params, stack.jtok,
                          grid=JaxBucketGrid.from_spec(spec),
                          mesh=build_mesh(), **stack.common)
    engine = QAEngine(stack.model, stack.tok, grid=BucketGrid.from_spec(spec),
                      **stack.common)
    return jengine, engine


@pytest.mark.parametrize("spec,limit", [
    ("2x64,8x64", 3000),            # the 8-wide bucket is dropped
    ("2x64,4x64", 10),              # everything over: the last one is kept
    ("2x32,2x64,4x64", 3000),       # a seq keeps its smaller bucket
])
def test_serve_preflight_matches_jax(serve_stack, spec, limit):
    jengine, engine = _engines(serve_stack, spec)
    try:
        jrep = jengine.warmup(hbm_preflight=True, limit_bytes=limit,
                              compile_fn=_fake_program_fn(1000))
        rep = engine.warmup(hbm_preflight=True, limit_bytes=limit,
                            compile_fn=_fake_program_fn(1000))
        for key in ("buckets", "dropped", "preflight"):
            assert rep[key] == jrep[key], key
        assert [str(b) for b in engine.grid] == [str(b) for b in jengine.grid]
        # the shrunk grid still serves, with the JAX engine's answer
        ref = jengine.submit(_QUESTION, _DOCUMENT).result(timeout=60)
        got = engine.submit(_QUESTION, _DOCUMENT).result(timeout=60)
        assert got.label in labels2id
        assert (got.answer, got.label, got.start, got.end, got.n_chunks) == (
            ref.answer, ref.label, ref.start, ref.end, ref.n_chunks)
    finally:
        jengine.close()
        engine.close()


def test_serve_preflight_stands_down_without_limit(serve_stack):
    """The CPU reports no device memory: the planner does nothing, and
    measures nothing, rather than guess; with a limit but no allocator
    statistics (the CPU) the measured forward runs and it stands down."""
    _, engine = _engines(serve_stack, "4x64")
    jengine, _ = _engines(serve_stack, "4x64")
    try:
        never = lambda b: pytest.fail("must not measure without a limit")  # noqa: E731
        assert engine.preflight_predict_step(Bucket(seq=64, batch=4),
                                             compile_fn=never) is None
        assert jengine.preflight_predict_step(JaxBucket(seq=64, batch=4),
                                              compile_fn=never) is None
        before = engine.device_forwards
        assert engine.preflight_predict_step(Bucket(seq=64, batch=4),
                                             limit_bytes=1) is None
        assert engine.device_forwards == before + 1
        report = engine.warmup(limit_bytes=1)
        assert report["preflight"] == {} and report["dropped"] == []
        assert report["dispatch"] == "eager" and report["graphs"] == {}
    finally:
        jengine.close()
        engine.close()


# -- training: next_batch_split --------------------------------------------------------

@pytest.mark.parametrize("batch", [8, 16, 24, 32, 48, 64, 96, 128])
def test_next_batch_split_matches_jax(batch):
    for split in (1, 2, 3, 4, 8):
        for procs in (1, 2, 4, 8):
            for data in (1, 2, 4, 8):
                ref = JaxTrainer._next_batch_split(SimpleNamespace(
                    mesh=SimpleNamespace(shape={"data": data}),
                    train_batch_size=batch, process_count=procs,
                    batch_split=split))
                got = next_batch_split(batch, split, procs, data)
                assert got == ref, (batch, split, procs, data)


# -- training: the planners under the JAX tests' fakes ------------------------------------

def _tp():
    return SimpleNamespace(
        loss="smooth", smooth_alpha=0.01, focal_alpha=1.0, focal_gamma=2.0,
        w_start=1, w_end=1, w_start_reg=0.5, w_end_reg=0.5, w_cls=1, lr=1e-3,
        weight_decay=0.01, warmup_coef=0.3, optimizer="adam", finetune=False,
        best_metric="map", best_order=">")


def _tiny_cfg(kind, vocab_size, dropout=0.0):
    return kind(vocab_size=vocab_size, hidden_size=16, num_layers=2,
                num_heads=2, intermediate_size=32,
                max_position_embeddings=MAX_SEQ_LEN + 2, num_labels=5,
                hidden_dropout_prob=dropout,
                attention_probs_dropout_prob=dropout)


@pytest.fixture(scope="module")
def train_stack(tmp_path_factory):
    vocab = str(write_vocab(tmp_path_factory.mktemp("preflight_train")))
    jtok = JaxTokenizer("bert", vocab, lowercase=True)
    tok = Tokenizer("bert", vocab, lowercase=True)
    jcfg = _tiny_cfg(JaxEncoderConfig, len(jtok))
    init = JaxQAModel(jcfg).init(
        jax.random.key(0), np.zeros((1, MAX_SEQ_LEN), np.int32))["params"]
    return SimpleNamespace(jtok=jtok, tok=tok, jcfg=jcfg, init=init,
                           init_np=jax.tree_util.tree_map(np.asarray, init))


def _datasets(stack, n=16):
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              dataset_len=n)
    return (JaxDummyDataset(tokenizer=stack.jtok,
                            rng=np.random.default_rng(0), **kw),
            DummyDataset(tokenizer=stack.tok, rng=np.random.default_rng(0),
                         **kw))


def _trainers(stack, *, batch_split=1, length_buckets=None):
    """The JAX trainer (mesh data:1) and the port's, same data and flags."""
    jds, tds = _datasets(stack)
    mesh = build_mesh("data:1")
    common = dict(n_epochs=1, train_batch_size=8, batch_split=batch_split,
                  n_jobs=2, warmup_coef=0.3, max_grad_norm=0.5, seed=0,
                  length_buckets=length_buckets)
    jt = JaxTrainer(
        model=JaxQAModel(stack.jcfg, attention_impl="xla", mesh=mesh),
        params=stack.init, loss=jax_build_loss(_tp()),
        collate_fun=jax_make_collate(stack.jtok, max_seq_len=MAX_SEQ_LEN),
        trainer_params=_tp(), train_dataset=jds, mesh=mesh, **common)
    tt = _port_trainer(stack, tds, **common)
    return jt, tt


def _port_trainer(stack, tds, dropout=0.0, **kw):
    model = QAModel(_tiny_cfg(EncoderConfig, len(stack.tok), dropout),
                    dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(stack.init_np), strict=True)
    return Trainer(model, build_loss(_tp()),
                   make_collate_fun(stack.tok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=_tp(), train_dataset=tds, **kw)


class _FakeCompiled:
    """The JAX test's double: temp bytes shrink as batch_split grows."""

    def __init__(self, split):
        self._split = split

    def memory_analysis(self):
        return SimpleNamespace(argument_size_in_bytes=1_000,
                               output_size_in_bytes=500,
                               temp_size_in_bytes=8_000 // self._split,
                               alias_size_in_bytes=500)


def _fake_compile_fn(compiles):
    def compile_fn(trainer):
        compiles.append(trainer.batch_split)
        return _FakeCompiled(trainer.batch_split)
    return compile_fn


# fields the JAX and port reports hold to the same values (the optimizer
# state's bytes differ by representation, optax's tree against the port's
# moment tensors; mesh_unused_devices counts the tests' 8 virtual JAX
# devices that data:1 leaves idle, the port runs one device a process)
_SAME = ("limit_bytes", "batch_split_before", "batch_split", "applied",
         "mesh_axes", "opt_sharding", "param_bytes",
         "pipe_schedule", "pipe_param_layout", "pipe_stage_layers",
         "pipe_stage_param_bytes")


@pytest.mark.parametrize("split,limit", [
    (1, 5_000),     # 9000 at split 1 -> raised to 2 (5000 fits)
    (2, 10_000),    # fits: untouched, measured once
    (1, 1_000),     # raised 1 -> 2 -> 4 -> 8, no legal split left: proceeds
])
def test_preflight_train_step_matches_jax(train_stack, split, limit):
    jt, tt = _trainers(train_stack, batch_split=split)
    jcompiles, compiles = [], []
    jrep = jt.preflight_train_step(None, None,
                                   compile_fn=_fake_compile_fn(jcompiles),
                                   limit_bytes=limit)
    rep = tt.preflight_train_step(None, None,
                                  compile_fn=_fake_compile_fn(compiles),
                                  limit_bytes=limit)
    assert set(rep) == set(jrep)
    for key in _SAME + ("bytes_before", "bytes"):
        assert rep[key] == jrep[key], key
    assert compiles == jcompiles and tt.batch_split == jt.batch_split
    assert tt.preflight_report is rep and tt._preflight_done
    assert rep["opt_state_bytes_per_chip"] > 0


def test_preflight_disabled_or_without_limit(train_stack):
    jds, tds = _datasets(train_stack)
    off = _port_trainer(train_stack, tds, train_batch_size=8, batch_split=1,
                        n_jobs=2, hbm_preflight=False)
    assert off._preflight_done
    assert off.preflight_train_step(None, None) is None
    on = _port_trainer(train_stack, tds, train_batch_size=8, batch_split=1,
                       n_jobs=2)
    assert not on._preflight_done
    assert on.preflight_train_step(None, None) is None     # the CPU: no limit
    assert on.batch_split == 1 and on._preflight_done
    assert on.preflight_probes == 0


def _fake_bucket_compile_fn(compiles, byte_table):
    class _Compiled:
        def __init__(self, b):
            self._b = b

        def memory_analysis(self):
            return SimpleNamespace(argument_size_in_bytes=self._b,
                                   output_size_in_bytes=0,
                                   temp_size_in_bytes=0,
                                   alias_size_in_bytes=0)

    def compile_fn(trainer, seq, batch):
        compiles.append((seq, batch, trainer.batch_split))
        return _Compiled(byte_table[(seq, trainer.batch_split)])
    return compile_fn


@pytest.mark.parametrize("table,limit", [
    ({(MAX_SEQ_LEN, 1): 9_000, (24, 1): 4_000,
      (MAX_SEQ_LEN, 2): 5_000, (24, 2): 2_500}, 5_000),       # raise + rescale
    ({(MAX_SEQ_LEN, 1): 4_000, (24, 1): 2_000}, 5_000),       # fits
    ({(MAX_SEQ_LEN, s): 9_000 for s in (1, 2, 4, 8)}, 5_000),  # cannot fit
])
def test_preflight_bucket_steps_matches_jax(train_stack, table, limit):
    jt, tt = _trainers(train_stack, length_buckets=[24, MAX_SEQ_LEN])
    assert tt.train_dataloader.batch_sizes == jt.train_dataloader.batch_sizes
    jcompiles, compiles = [], []
    jrep = jt.preflight_bucket_steps(
        compile_fn=_fake_bucket_compile_fn(jcompiles, table),
        limit_bytes=limit)
    rep = tt.preflight_bucket_steps(
        compile_fn=_fake_bucket_compile_fn(compiles, table),
        limit_bytes=limit)
    assert set(rep) == set(jrep)
    for key in _SAME + ("buckets",):
        assert rep[key] == jrep[key], key
    assert compiles == jcompiles
    assert tt.train_dataloader.batch_sizes == jt.train_dataloader.batch_sizes
    assert (tt.train_dataloader.batch_multiple
            == jt.train_dataloader.batch_multiple)
    # not bucketed: nothing to plan, even with a limit
    _, plain = _trainers(train_stack)
    assert plain.preflight_bucket_steps(limit_bytes=1) is None


# -- the real probe: a plan that fits changes nothing --------------------------------------

@pytest.fixture
def cpu_allocator(monkeypatch):
    """The CUDA allocator's numbers stood in on the CPU: the probe runs for
    real, its temporaries and outputs read as 0 bytes, and the card holds
    ``LIMIT``."""
    real = hbm.measure

    def measure(fn, device, *, argument_bytes):
        result, analysis = real(fn, device, argument_bytes=argument_bytes)
        analysis.output_size_in_bytes = 0
        analysis.temp_size_in_bytes = 0
        return result, analysis

    monkeypatch.setattr(hbm, "measure", measure)
    monkeypatch.setattr(hbm, "device_hbm_bytes", lambda device=None: 1 << 30)


@pytest.mark.parametrize("length_buckets", [None, [24, MAX_SEQ_LEN]],
                         ids=["plain", "bucketed"])
def test_a_plan_that_fits_trains_bit_for_bit(train_stack, cpu_allocator,
                                             length_buckets):
    """Dropout 0.1, two steps of two micro-batches: the pre-flight's probe
    (one forward and backward, no update) leaves the parameters, the
    optimizer, the generators and the loader as they were."""
    runs, rng_after = [], []
    for preflight in (False, True):
        _, tds = _datasets(train_stack)
        tt = _port_trainer(train_stack, tds, dropout=0.1, n_epochs=1,
                           train_batch_size=8, batch_split=2, n_jobs=2,
                           warmup_coef=0.3, max_grad_norm=0.5, seed=0,
                           length_buckets=length_buckets,
                           hbm_preflight=preflight)
        torch.manual_seed(123)
        tt.train()
        runs.append(tt)
        rng_after.append(torch.random.get_rng_state())
    off, on = runs
    assert on.preflight_probes == (2 if length_buckets else 1)
    report = on.preflight_report
    assert report["applied"] is False and report["batch_split"] == 2
    need = report["buckets"][0]["bytes"] if length_buckets else report["bytes"]
    assert 0 < need <= report["limit_bytes"]
    assert off.preflight_report is None and off.preflight_probes == 0
    assert len(on.history) == len(off.history) >= 2
    assert [h["loss"] for h in on.history] == [h["loss"] for h in off.history]
    for (name, a), (_, b) in zip(off.model.state_dict().items(),
                                 on.model.state_dict().items()):
        assert torch.equal(a, b), name
    for a, b in zip(off.optimizer.state_tensors(),
                    on.optimizer.state_tensors()):
        assert torch.equal(a, b)
    assert torch.equal(*rng_after)


def test_real_probe_raises_the_split_when_the_need_is_over(
        train_stack, cpu_allocator, monkeypatch):
    """The probe itself (no fake compile_fn): a need over the limit raises
    batch_split and measures again at the smaller micro-batch."""
    _, tds = _datasets(train_stack)
    tt = _port_trainer(train_stack, tds, train_batch_size=8, batch_split=1,
                       n_jobs=2)
    inputs, labels = make_collate_fun(train_stack.tok,
                                      max_seq_len=MAX_SEQ_LEN)(
        [tds[i] for i in range(8)])[:2]
    seen = []
    real = hbm.measure

    def measure(fn, device, *, argument_bytes):
        result, analysis = real(fn, device, argument_bytes=argument_bytes)
        seen.append(tt.batch_split)
        analysis.output_size_in_bytes = 0
        analysis.temp_size_in_bytes = 4000 // tt.batch_split
        return result, analysis

    monkeypatch.setattr(hbm, "measure", measure)
    args = hbm.tensor_bytes(tt.model.parameters())
    report = tt.preflight_train_step(inputs, labels,
                                     limit_bytes=10 ** 9)
    base = report["bytes"] - 4000
    assert report["applied"] is False and base > args
    report = tt.preflight_train_step(inputs, labels,
                                     limit_bytes=base + 1500)
    assert report["applied"] is True
    assert seen[1:] == [1, 2, 4] and tt.batch_split == 4
    assert report["bytes_before"] == base + 4000
    assert report["bytes"] == base + 1000
    assert tt.preflight_probes == 4
    assert all(p.grad is None for p in tt.model.parameters())


# -- two processes agree ----------------------------------------------------------------

_AGREE = """
import json, sys, torch
import torch.distributed as dist
from types import SimpleNamespace
from ml_recipe_tpu_torch.train.trainer import Trainer
rank, port = int(sys.argv[1]), int(sys.argv[2])
needs = json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
me = SimpleNamespace(process_count=2, device=torch.device("cpu"))
print(json.dumps([Trainer._agree(me, n, oom) for n, oom in needs]))
dist.destroy_process_group()
"""


def test_ranks_agree_on_the_largest_need():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # (need, ran out of memory) on each rank
    needs = {0: [[100, False], [5, False], [None, False], [7, True]],
             1: [[90, False], [50, True], [3, False], [None, False]]}
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _AGREE, str(rank), str(port),
         json.dumps(needs[rank])], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert got[0] == got[1] == [[100, False], [50, True], [None, False],
                                [None, True]]
    single = SimpleNamespace(process_count=1, device=torch.device("cpu"))
    assert Trainer._agree(single, 12, False) == (12, False)


# -- running out of memory is the verdict, not a missing analysis --------------------------

def test_measure_turns_out_of_memory_into_a_verdict(monkeypatch):
    """On the card, a probe that runs out of memory returns an analysis
    marked ``out_of_memory`` (its lower bound: the peak reached and the
    allocation refused) and hands the allocator's cache back; the CUDA
    allocator's numbers are stood in here."""
    calls = []
    stats = {"allocated": 1000, "peak": 0}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: stats["allocated"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda device=None: stats.update(peak=0))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: stats["peak"])
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("empty_cache"))

    def step():
        stats["peak"] = 1000 + 5000
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 MiB. GPU 0 has a "
            "total capacity of 79.19 GiB")

    result, analysis = hbm.measure(step, torch.device("cuda"),
                                   argument_bytes=300)
    assert result is None and calls == ["empty_cache"]
    assert analysis.out_of_memory
    need = hbm.preflight_bytes(analysis)
    assert need == 300 + 5000 + (2 << 20)
    # over the limit whatever the limit: the step did not run
    assert hbm.exceeds(analysis, need, 10 ** 12)
    assert not hbm.exceeds(hbm.MemoryAnalysis(300, 0, 5000), 5300, 10 ** 12)


def _out_of_memory(rows_that_fit):
    """A measured bucket: a small need, marked out of memory above
    ``rows_that_fit`` rows."""
    def measure_bucket(bucket):
        return hbm.MemoryAnalysis(
            argument_size_in_bytes=bucket.batch, output_size_in_bytes=0,
            temp_size_in_bytes=0,
            out_of_memory=bucket.batch > rows_that_fit)
    return measure_bucket


@pytest.mark.parametrize("spec,fit,kept,dropped", [
    ("2x64,8x64", 2, ["2x64"], ["8x64"]),
    ("2x64,4x64", 1, ["4x64"], ["2x64"]),      # the last one is kept
])
def test_serve_preflight_drops_a_bucket_that_ran_out_of_memory(
        serve_stack, monkeypatch, spec, fit, kept, dropped):
    """A bucket whose measured forward ran out of memory does not fit,
    though its lower bound is far under the limit: it is dropped (never
    the last one), and the grid that is left answers."""
    _, engine = _engines(serve_stack, spec)
    try:
        monkeypatch.setattr(engine, "_measure_bucket", _out_of_memory(fit))
        report = engine.warmup(hbm_preflight=True, limit_bytes=10 ** 9)
        assert report["buckets"] == kept and report["dropped"] == dropped
        for name in dropped:
            assert report["preflight"][name] == {
                "bytes": int(name.split("x")[0]), "limit": 10 ** 9,
                "fits": False, "out_of_memory": True}
        got = engine.submit(_QUESTION, _DOCUMENT).result(timeout=60)
        assert got.label in labels2id
    finally:
        engine.close()


def test_real_probe_raises_the_split_when_it_runs_out_of_memory(
        train_stack, monkeypatch):
    """The probe ran out of memory at splits 1 and 2 (a lower bound under
    the limit): the split is raised until the probe runs."""
    _, tds = _datasets(train_stack)
    tt = _port_trainer(train_stack, tds, train_batch_size=8, batch_split=1,
                       n_jobs=2)
    inputs, labels = make_collate_fun(train_stack.tok,
                                      max_seq_len=MAX_SEQ_LEN)(
        [tds[i] for i in range(8)])[:2]
    real = hbm.measure

    def measure(fn, device, *, argument_bytes):
        result, analysis = real(fn, device, argument_bytes=argument_bytes)
        analysis.output_size_in_bytes = 0
        analysis.temp_size_in_bytes = 0
        analysis.out_of_memory = tt.batch_split < 4
        return result, analysis

    monkeypatch.setattr(hbm, "measure", measure)
    report = tt.preflight_train_step(inputs, labels, limit_bytes=10 ** 12)
    assert report["applied"] is True and tt.batch_split == 4
    assert report["batch_split_before"] == 1 and report["batch_split"] == 4
    assert report["bytes"] <= report["limit_bytes"]
    assert tt.preflight_probes == 3
    assert all(p.grad is None for p in tt.model.parameters())
