"""``scripts/worker_torch.sh``, the port's per-rank launcher.

Two ranks started through the script (``MASTER_IP`` / ``MASTER_PORT`` /
``LOCAL_RANK`` / ``WORLD_SIZE``, the native readiness handshake when
``native/build/qacoord`` can be built, gloo with ``--device cpu``) train on
an NQ corpus beside a direct ``cli.train --dist_world_size 2`` pair with
the same flags: rank 0's files are the same set, the checkpoints hold
equal states and the logged test metrics are equal. The script names no
module of the JAX package. Each pair has its own deadline
(``torch_ddp_worker.run_pairs``).
"""

import re
import sys

import numpy as np

import jax
from ml_recipe_tpu_torch.train.checkpoint import read_state

from helpers import write_vocab
from test_torch_nq_data import write_mixed_corpus
from torch_ddp_worker import REPO, run_pairs

SCRIPT = REPO / "scripts" / "worker_torch.sh"


def test_script_names_the_port_only():
    text = SCRIPT.read_text()
    assert "ml_recipe_tpu_torch.cli.train" in text
    assert not re.search(r"ml_recipe_tpu\.", text)
    assert "--dist_backend" not in text.split("exec python", 1)[1]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and p.suffix != ".log"
                  and "events.out" not in p.name)


def test_two_ranks_through_the_script_equal_a_direct_pair(tmp_path):
    raw = write_mixed_corpus(tmp_path)
    vocab = write_vocab(tmp_path)
    common = ["--model", "bert-tiny", "--device", "cpu", "--vocab_file",
              str(vocab), "--data_path", str(raw), "--max_seq_len", "64",
              "--max_question_len", "16", "--doc_stride", "16",
              "--split_by_sentence", "--truncate", "--n_epochs", "1",
              "--train_batch_size", "8", "--test_batch_size", "4",
              "--batch_split", "2", "--n_jobs", "1", "--lr", "1e-3",
              "--seed", "0", "--experiment_name", "nq"]

    def direct(rank, port):
        out = tmp_path / "direct"
        return [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train", *common,
                "--processed_data_path", str(out / "proc"), "--dump_dir",
                str(out), "--dist_world_size", "2", "--local_rank", str(rank),
                "--dist_init_method", f"tcp://127.0.0.1:{port}"]

    def script(rank, port):
        out = tmp_path / "script"
        return ["env", f"LOCAL_RANK={rank}", "WORLD_SIZE=2",
                f"MASTER_PORT={port}", "MASTER_IP=127.0.0.1",
                "bash", str(SCRIPT), *common,
                "--processed_data_path", str(out / "proc"), "--dump_dir",
                str(out)]

    results = run_pairs(direct, script)
    for pair in results:
        for rc, err in pair:
            assert rc == 0, err[-3000:]
    (_, direct_err), (_, script_err) = results[0][0], results[1][0]
    runs = [tmp_path / "direct", tmp_path / "script"]
    assert _files(runs[0]) == _files(runs[1])
    a, b = (read_state(run / "nq" / "last.ch") for run in runs)
    assert a["global_step"] == b["global_step"] > 0
    for key in ("model", "optimizer"):
        la = jax.tree_util.tree_leaves_with_path(a[key])
        lb = jax.tree_util.tree_leaves_with_path(b[key])
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert np.array_equal(np.asarray(x), np.asarray(y)), path
    metrics = [re.findall(r"Test metrics after epoch.*", err)
               for err in (direct_err, script_err)]
    assert metrics[0] == metrics[1] and len(metrics[0]) == 1
    assert "Data parallel: process 0 of 2" in script_err
