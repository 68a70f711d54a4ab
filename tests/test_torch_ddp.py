"""Data-parallel training of the port, two gloo processes on the CPU.

The invariant: a W-rank step equals a one-process step on the same global
batch with its rows in rank-order grouping (``parallel.regroup_for_world``),
dropout included.

- two processes of ``tests/torch_ddp_worker.py`` train a tiny ``Trainer``
  (batch_split 2, hidden and attention dropout 0.1, the fused LayerNorm's
  plain path, weighted CE over no-answer spans, a weighted sampler, a clip
  that bites) for two steps with an eval after each; a one-process
  ``Trainer`` built the same way takes the same steps on the regrouped
  global batches. Each step's losses, the first step's gradients where
  they reach the clip (summed over the world and scaled, not yet
  clipped), the eval metrics and the final parameters agree at
  ``rtol=1e-5`` (f32 on both sides, in other summation orders:
  micro-batches of 2 rows per process against 4, and the gradient sum
  split at the all-reduce), the accuracies and mAP exactly, and the two
  replicas are ``torch.equal``. That oracle is the port's own:
  ``tests/test_torch_ddp_jax.py`` holds the two processes to the JAX
  package's two-process ``Trainer``;
- a planted fault (rank 1 keeps its own gradients and adds zeros to rank
  0's) fails that comparison by far and breaks the replicas: the gate
  catches a missing all-reduce;
- a peer that leaves ends its partner's next collective with an error;
- ``python -m ml_recipe_tpu_torch.cli.train --dist_world_size 2`` on an NQ
  corpus: rank 0 alone writes the log, the cfg files, the TensorBoard
  events and ``last.ch``; with ``--sharded_checkpoint`` the manifest
  records ``process_count`` 2 over two shard files, and both layouts read
  back equal in a one-process port ``Trainer`` and through the JAX
  package's reader.

Each pair of processes has its own deadline and is killed past it.
"""

import re
import sys

import numpy as np
import pytest
import torch

import jax
from ml_recipe_tpu.train.checkpoint import load_state_dict as jax_load_state
from ml_recipe_tpu_torch.cli import train as train_cli
from ml_recipe_tpu_torch.config.parser import (
    get_model_parser,
    get_params,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.models import to_jax_params
from ml_recipe_tpu_torch.train.checkpoint import MANIFEST, read_state
from ml_recipe_tpu_torch.utils.msgpack import unpackb

import torch_ddp_worker as worker
from helpers import write_vocab
from test_torch_nq_data import write_mixed_corpus
from torch_ddp_worker import oracle, rel_l2, run_pairs, worker_pairs

# f32 on both sides, in other summation orders (see the module docstring)
RTOL, ATOL = 1e-5, 1e-7
# end parameters: an Adam step moves a parameter by ~lr * g / (|g| + eps),
# so a gradient that is rounding noise on both sides (the attention key
# bias's, whose true gradient is 0) moves it by up to ~lr * 1e-3 per step
PARAM_ATOL = 2e-6


# -- the trainer -------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    modes = ("trainer", "trainer_fault")
    for results in worker_pairs(*modes, out=tmp):
        for rc, err in results:
            assert rc == 0, err[-3000:]
    return tmp, {mode: [torch.load(tmp / mode / f"rank{r}.pt")
                        for r in range(2)] for mode in modes}


def test_two_process_steps_equal_the_one_process_step(dp_runs):
    tmp, runs = dp_runs
    record = runs["trainer"]
    assert len(record[0]["batches"]) == len(record[0]["values"]) == 2
    # each process held 4 of the 8 rows of each global batch
    assert all(b[0]["input_ids"].shape[0] == worker.TRAIN_BATCH // 2
               for r in record for b in r["batches"])
    ref = oracle(tmp, record)
    values, metrics, params = ref.values, ref.metrics, ref.params
    for step, (got, want) in enumerate(zip(record[0]["values"], values)):
        assert got == record[1]["values"][step]    # all-reduced: one value
        assert got["lr"] == want["lr"]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{step} {key}")
    assert values[1]["lr"] > 0    # both steps moved the parameters
    for name, want in ref.grads.items():
        np.testing.assert_allclose(record[0]["grads"][name], want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        assert torch.equal(record[0]["grads"][name],
                           record[1]["grads"][name]), name
    for name, want in params.items():
        np.testing.assert_allclose(record[0]["params"][name], want,
                                   rtol=RTOL, atol=PARAM_ATOL, err_msg=name)
    # the replicas are bit-identical
    for name in params:
        assert torch.equal(record[0]["params"][name],
                           record[1]["params"][name]), name
    # eval: every process's rows gathered in rank order (the last global
    # batch is a pad_last tail of 4 real rows of 6)
    for epoch, (got, want) in enumerate(zip(record[0]["metrics"], metrics)):
        assert got == record[1]["metrics"][epoch]
        for key in ("start_class", "end_class", "start_reg", "end_reg",
                    "cls", "loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        for key in ("s_acc", "e_acc", "c_acc", "map"):
            assert got[key] == want[key], key


def test_planted_fault_fails_the_oracle_and_the_replicas(dp_runs):
    """Rank 1 skips the gradient all-reduce (it adds zeros to rank 0's
    and keeps its own): the gate above would fail by far."""
    tmp, runs = dp_runs
    record = runs["trainer_fault"]
    ref = oracle(tmp / "fault", record)
    # rank 0 applied its own half of the sum: about half the gradient
    assert rel_l2(record[0]["grads"], ref.grads) > 0.1
    params = ref.params
    worst = max(float((record[0]["params"][n] - p).abs().max())
                for n, p in params.items())
    assert worst > 100 * PARAM_ATOL, worst
    assert not all(torch.equal(record[0]["params"][n],
                               record[1]["params"][n]) for n in params)


def test_a_peer_that_leaves_ends_the_run_with_an_error(tmp_path):
    [(rc0, err0), (rc1, _)] = worker_pairs("dead_peer", out=tmp_path)[0]
    assert rc1 == 0 and rc0 != 0
    assert "Error" in err0


# -- the CLI -------------------------------------------------------------------------

MAX_SEQ_LEN, MAX_Q_LEN = 64, 16


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two ranks of ``cli.train`` on an NQ corpus, single-file and
    sharded."""
    tmp = tmp_path_factory.mktemp("ddp_cli")
    raw = write_mixed_corpus(tmp)
    vocab = write_vocab(tmp)
    common = ["--model", "bert-tiny", "--device", "cpu", "--vocab_file",
              str(vocab), "--data_path", str(raw), "--max_seq_len",
              str(MAX_SEQ_LEN),
              "--max_question_len", str(MAX_Q_LEN), "--doc_stride", "16",
              "--split_by_sentence", "--truncate", "--train_label_weights",
              "--train_sampler_weights", "--n_epochs", "1",
              "--train_batch_size", "8", "--test_batch_size", "4",
              "--batch_split", "2", "--n_jobs", "1", "--lr", "1e-3",
              "--seed", "0", "--length_buckets", "auto"]
    layouts = {"single": [], "sharded": ["--sharded_checkpoint"]}
    # rank 0 of each run preprocesses the corpus into its own directory
    argv = {layout: (lambda rank, port, layout=layout: [
        sys.executable, "-m", "ml_recipe_tpu_torch.cli.train", *common,
        "--processed_data_path", str(tmp / layout / "proc"), "--dump_dir",
        str(tmp / layout), "--experiment_name", "nq", "--dist_world_size",
        "2", "--local_rank", str(rank), "--dist_init_method",
        f"tcp://127.0.0.1:{port}", *layouts[layout]]) for layout in layouts}
    runs = {}
    for layout, results in zip(layouts, run_pairs(*argv.values())):
        for rc, err in results:
            assert rc == 0, err[-3000:]
        runs[layout] = (tmp / layout, [err for _, err in results])
    return tmp, common, runs


def test_cli_rank_zero_alone_writes_the_log_cfgs_events_and_checkpoint(
        cli_runs):
    _, _, runs = cli_runs
    dump, (err0, err1) = runs["single"]
    exp = dump / "nq"
    assert len(list(exp.glob("*.log"))) == 1
    assert (exp / "trainer.cfg").exists() and (exp / "model.cfg").exists()
    assert len(list((dump / "board" / "nq").glob("events.out.tfevents.*"))) == 1
    assert (exp / "last.ch").is_file()
    assert not list(exp.glob("last.ch.*"))
    # the eval ran on both ranks, and rank 0 logged its metrics
    assert len(re.findall("Test metrics after epoch", err0)) == 1
    assert "Test metrics" not in err1
    assert "Data parallel: process 1 of 2" in err1
    state = read_state(exp / "last.ch")
    assert state["mesh_axes"] == {"data": 2} and state["global_step"] > 0
    log = next(exp.glob("*.log")).read_text()
    assert "process 0 of 2" in log and "process 1 of 2" not in log


def _same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


def test_cli_sharded_checkpoint_reads_back_in_both_packages(cli_runs):
    _, common, runs = cli_runs
    single = runs["single"][0] / "nq" / "last.ch"
    sharded = runs["sharded"][0] / "nq" / "last.ch"
    with open(sharded / MANIFEST, "rb") as fh:
        manifest = unpackb(fh.read())
    assert manifest["process_count"] == 2
    assert manifest["extra"]["mesh_axes"] == {"data": 2}
    assert sorted(p.name for p in sharded.glob("shard-*")) == [
        "shard-00000.msgpack", "shard-00001.msgpack"]
    # the two runs trained the same steps: the layouts hold the same state
    a, b = read_state(single), read_state(sharded)
    assert a["global_step"] == b["global_step"] > 0
    _same_tree(a["model"], b["model"])
    _same_tree(a["optimizer"], b["optimizer"])
    # a one-process port trainer resumes it
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        [*common, "--processed_data_path", str(runs["sharded"][0] / "proc"),
         "--dump_dir", str(runs["sharded"][0] / "resume"), "--last",
         str(sharded)])
    trainer = train_cli.build_trainer(params, model_params)
    assert trainer.process_count == 1
    assert trainer.global_step == a["global_step"]
    _same_tree(to_jax_params(trainer.model.state_dict()), a["model"])
    trainer.close()
    # and so does the JAX package's reader, from either layout
    template = jax.tree_util.tree_map(np.zeros_like, a["model"])
    for path in (single, sharded):
        restored, _, _, step = jax_load_state(path, params=template)
        assert step == a["global_step"]
        _same_tree(jax.tree_util.tree_map(np.asarray, restored), a["model"])
