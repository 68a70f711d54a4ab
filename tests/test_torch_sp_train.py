"""Sequence-parallel training (the mesh ``data:1,seq:2``, ring attention)
in the port, against the JAX package's ``Trainer`` and against the port's
own one-process step, on the CPU.

The port's pairs are gloo processes of ``tests/torch_ddp_worker.py``:
``sp`` (dropout 0) and ``sp_drop`` (hidden and attention dropout 0.1),
both the tiny trainer on ``data:1,seq:2`` (each rank embeds and attends
its 24 of the 48 tokens, the heads and the loss see the gathered
sequence), 2 debug steps of 2 micro-batches. Then:

- the JAX ``Trainer`` on the mesh ``data:1,seq:2`` with
  ``attention_impl='ring'``, from the same weights on the same items,
  dropout 0: step losses to ``rtol=2e-5`` and end parameters to
  ``atol=5e-5`` (the JAX package's own pins, ``tests/test_dp_equivalence.py``);
- the seq:2 first-step gradients (all-reduced, before the clip) equal the
  one-process (seq:1) trainer's on the same batch to a relative L2 of
  ``GRAD_REL = 1e-5``: a loss counted once per rank of the ``seq`` group
  would double them;
- with dropout live, and with sequence packing (``sp_packed``: segment ids
  crossing the blocks, the q-side ids resident and the k-side ids
  rotating with each block), the seq:2 steps equal the one-process
  trainer's (the
  hidden-dropout masks are drawn at the whole sequence's shape and the
  attention keep-bits hashed by absolute position): step values to
  ``rtol=1e-5``, gradients to ``GRAD_REL``, end parameters to
  ``PARAM_ATOL = 2e-6`` (``tests/test_torch_ddp.py``'s);
- both ranks of the ``seq`` group end with equal parameters;
- ``config/longdoc.cfg`` runs through ``cli.train`` as two ranks
  (bert-tiny flags), ring attention auto-selected; its flags pass
  ``check_train_flags`` (``--zero1_overlap bucketed`` inert), while a
  ``model`` axis and ``pipe`` beside ``seq`` are refused, naming the item.
"""

import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import torch_ddp_worker as worker
from helpers import write_vocab
from ml_recipe_tpu.data.collate import make_collate_fun as jax_collate
from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh as jax_build_mesh
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu_torch.config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.models import to_jax_params
from ml_recipe_tpu_torch.tokenizer import Tokenizer

RTOL, PARAMS_ATOL = 2e-5, 5e-5          # against JAX
GRAD_REL, PARAM_ATOL = 1e-5, 2e-6       # against the port's own seq:1
REPO = Path(__file__).resolve().parent.parent


def _jax_trainer(tmp, mesh_spec, attention_impl, batch_split, steps,
                 **trainer_kw):
    """The JAX package's tiny trainer (the worker's sizes, items, loss and
    weights), dropout 0, from the port's seed-0 weights."""
    tok = JaxTokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    ttok = Tokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    init = to_jax_params(worker.tiny_model(len(ttok), dropout=0.0).state_dict())
    mesh = jax_build_mesh(mesh_spec)
    cfg = JaxEncoderConfig(vocab_size=len(tok), hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0, **worker.TINY_MODEL)
    tp, weights = worker.trainer_params(), worker.train_weights()
    return init, JaxTrainer(
        model=JaxQAModel(cfg, attention_impl=attention_impl, mesh=mesh,
                         ln_impl="fused"),
        params=init, loss=jax_build_loss(tp, weights),
        collate_fun=jax_collate(tok, max_seq_len=worker.MAX_SEQ_LEN),
        trainer_params=tp,
        train_dataset=worker.VariedDataset(tok, worker.N_TRAIN, seed=1,
                                           item=JaxItem),
        mesh=mesh, train_batch_size=worker.TRAIN_BATCH,
        batch_split=batch_split, n_jobs=1, warmup_coef=0.0,
        max_grad_norm=worker.MAX_GRAD_NORM, train_weights=weights,
        debug=True, seed=0, hbm_preflight=False,
        on_train_metrics=lambda meters, step: steps.append(
            {k: float(v) if k == "lr" else float(v())
             for k, v in meters.items()}),
        **trainer_kw)


def _longdoc_argv(tmp):
    vocab = tmp / "vocab.txt"
    if not vocab.exists():
        from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

        write_synthetic_bert_vocab(str(vocab), size=300)
    return ["-c", str(REPO / "config" / "longdoc.cfg"), "--dummy_dataset",
            "--debug", "--vocab_file", str(vocab), "--dump_dir",
            str(tmp / "results"), "--device", "cpu", "--model", "bert-tiny",
            "--max_seq_len=128", "--max_position_embeddings=128",
            "--max_question_len", "16", "--train_batch_size", "4",
            "--batch_split", "2", "--test_batch_size", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    cli = tmp / "cli"
    cli.mkdir()
    argv = _longdoc_argv(cli)

    def cli_argv(rank, port):
        return [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train", *argv,
                "--dist_world_size", "2", "--local_rank", str(rank),
                "--dist_init_method", f"tcp://127.0.0.1:{port}"]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        pairs = pool.submit(worker.worker_pairs, "sp", "sp_drop", "sp_packed",
                            out=tmp)
        cli_run = pool.submit(worker.run_pairs, cli_argv)
        steps = []
        init, jt = _jax_trainer(tmp, "data:1,seq:2", "ring",
                                worker.BATCH_SPLIT, steps)
        jt.train()
        jax_params = jax.tree_util.tree_map(np.asarray, jt.params)
        for results in pairs.result() + cli_run.result():
            for rc, err in results:
                assert rc == 0, err[-3000:]
        cli_logs = [err for err in (e for r in cli_run.result() for _, e in r)]
    port = {mode: [torch.load(tmp / mode / f"rank{r}.pt") for r in range(2)]
            for mode in ("sp", "sp_drop", "sp_packed")}
    oracles = {mode: worker.oracle_whole(
        tmp / f"oracle_{mode}", port[mode][0],
        dropout=0.0 if mode == "sp" else 0.1,
        **(worker.PACKING if mode == "sp_packed" else {})) for mode in port}
    return dict(jax_steps=steps, jax_params=jax_params, init=init, port=port,
                oracles=oracles, cli_logs=cli_logs)


def test_seq2_steps_equal_the_jax_ring_trainer(runs):
    want, port = runs["jax_steps"], runs["port"]["sp"][0]
    assert len(want) == len(port["values"]) == 2
    for step, (got, ref) in enumerate(zip(port["values"], want)):
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")
    got = to_jax_params(port["params"])
    paths = jax.tree_util.tree_leaves_with_path
    moved = 0
    for (path, a), (_, b), (_, c) in zip(paths(got), paths(runs["jax_params"]),
                                         paths(runs["init"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=PARAMS_ATOL,
                                   err_msg=str(path))
        moved += not np.array_equal(b, c)
    assert moved > len(paths(got)) // 2


@pytest.mark.parametrize("mode", ["sp", "sp_drop", "sp_packed"])
def test_seq2_gradients_equal_seq1_gradients(runs, mode):
    port, oracle = runs["port"][mode][0], runs["oracles"][mode]
    assert set(port["grads"]) == set(oracle.grads)
    assert worker.rel_l2(port["grads"], oracle.grads) < GRAD_REL


@pytest.mark.parametrize("mode", ["sp", "sp_drop", "sp_packed"])
def test_seq2_steps_equal_the_one_process_step(runs, mode):
    port, oracle = runs["port"][mode], runs["oracles"][mode]
    for got, ref in zip(port[0]["values"], oracle.values):
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                       err_msg=key)
    for name, p in oracle.params.items():
        np.testing.assert_allclose(port[0]["params"][name], p,
                                   atol=PARAM_ATOL, err_msg=name)
        # the two ranks of the seq group stay replicas
        assert torch.equal(port[0]["params"][name], port[1]["params"][name])
    assert port[0]["values"] == port[1]["values"]


def test_longdoc_cfg_runs_as_two_ranks(runs):
    for log in runs["cli_logs"]:
        assert "attention_impl auto-selected 'ring'" in log
        assert "Built process mesh {'data': 1, 'seq': 2}" in log
        assert log.count("Training was interrupted because of debug mode") == 2
    assert "Test metrics after epoch 2" in runs["cli_logs"][0]


def _flags(tmp, *extra, world=2):
    return get_params((get_trainer_parser, get_model_parser), [
        *_longdoc_argv(tmp), "--dist_world_size", str(world),
        "--local_rank", "0", *extra])[1]


@pytest.mark.parametrize("extra,refused", [
    (["--mesh", "data:1,seq:2,model:1"], True),
    # pipe is ported, but not beside seq (as in the JAX package)
    (["--mesh", "pipe:2,seq:2"], True),
    # accepted: bucketing is inert on a seq mesh (the trainer logs so)
    (["--zero1_overlap", "bucketed"], False)],
    ids=["model", "pipe", "zero1_overlap"])
def test_longdoc_flags_accepted_and_the_rest_refused(tmp_path, extra,
                                                     refused):
    params, model_params = _flags(tmp_path)
    assert params.mesh == "data:1,seq:2" and params.shard_optimizer
    check_train_flags(params, model_params)
    params, model_params = _flags(tmp_path, "--flash_attention", "ring")
    check_train_flags(params, model_params)
    params, model_params = _flags(tmp_path, *extra)
    if refused:
        with pytest.raises(NotImplementedError,
                           match="Parallelism beyond data parallelism"):
            check_train_flags(params, model_params)
    else:
        check_train_flags(params, model_params)
    params, model_params = _flags(tmp_path, world=4)
    with pytest.raises(ValueError, match="needs 2 processes"):
        check_train_flags(params, model_params)
