"""One rank of the data-parallel tests' gloo world on the CPU (no JAX).

    python tests/torch_ddp_worker.py MODE RANK WORLD PORT OUT [DEVICE]

- ``trainer``: joins the world, builds :func:`tiny_trainer` (bert-tiny
  sized, batch_split 2, hidden and attention dropout 0.1, the fused
  LayerNorm on its plain path, weighted CE and a weighted sampler, a clip
  that bites) and trains it in debug mode (2 epochs of one step, an eval
  after each); writes ``OUT/rank<RANK>.pt`` with the local batch of each
  step, the step values, the first step's gradients (summed over the
  world and scaled by ``1/batch_split``, before the clip), the eval
  metrics and the final parameters. On a CUDA ``DEVICE`` the ranks share
  the card and reduce over gloo;
- ``trainer_nodrop``: the same with dropout 0, for the comparison with the
  JAX package's two-process ``Trainer`` (``tests/jax_ddp_worker.py``),
  whose dropout streams the port cannot reproduce;
- ``trainer_fault``: the same with a planted fault, rank 1 skipping the
  gradient all-reduce (:func:`skip_gradient_all_reduce`);
- ``dead_peer``: rank 1 leaves right after joining, rank 0 then reduces a
  tensor, which must fail (the run ends with an error, not a hang).

The tests start the pairs (:func:`run_pairs`) and build the one-process
oracle (:func:`oracle`) with the same :func:`tiny_trainer`; this module
imports no JAX, so the card's tests use it too. The JAX worker takes its
data, sizes and weights from here (:class:`VariedDataset`,
:data:`TINY_MODEL`, :func:`train_weights`).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# run as a script: the repository root and tests/ on the path
_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE.parent), str(_HERE)]

from helpers import write_vocab  # noqa: E402
from ml_recipe_tpu_torch.data.collate import make_collate_fun  # noqa: E402
from ml_recipe_tpu_torch.data.datasets import DatasetItem  # noqa: E402
from ml_recipe_tpu_torch.data.labels import labels2id  # noqa: E402
from ml_recipe_tpu_torch.losses import build_loss  # noqa: E402
from ml_recipe_tpu_torch.models import (  # noqa: E402
    EncoderConfig,
    QAModel,
    init_weights,
)
from ml_recipe_tpu_torch.parallel import collectives  # noqa: E402
from ml_recipe_tpu_torch.parallel import dist as pdist  # noqa: E402
from ml_recipe_tpu_torch.parallel import regroup_for_world  # noqa: E402
from ml_recipe_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from ml_recipe_tpu_torch.train.callback import (  # noqa: E402
    AccuracyCallback,
    MAPCallback,
)
from ml_recipe_tpu_torch.train import trainer as trainer_module  # noqa: E402
from ml_recipe_tpu_torch.train.trainer import Trainer  # noqa: E402

REPO = _HERE.parent
PAIR_DEADLINE_S = 120
MAX_SEQ_LEN, MAX_Q_LEN = 48, 8
TRAIN_BATCH, TEST_BATCH, BATCH_SPLIT = 8, 6, 2
N_TRAIN, N_TEST = 40, 22
# collectives of a test world give up after this long
TIMEOUT_S = 60.0
# the encoder's sizes (heads of 32: the attention kernels' smallest)
TINY_MODEL = dict(hidden_size=64, num_layers=2, num_heads=2,
                  intermediate_size=128, max_position_embeddings=MAX_SEQ_LEN,
                  num_labels=5)
MAX_GRAD_NORM = 0.5


class VariedDataset:
    """Deterministic QA items (a pure function of the index, as the oracle
    needs): ragged lengths, no-answer spans (-1) on every third item, the
    five classes in turn. ``item`` is the ``DatasetItem`` class of the
    package that reads them."""

    def __init__(self, tokenizer, n: int, seed: int, item=DatasetItem):
        self.tokenizer, self.n, self.seed = tokenizer, n, seed
        self.item = item

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> DatasetItem:
        tok = self.tokenizer
        rng = np.random.default_rng([self.seed, int(index)])
        q = rng.integers(5, len(tok), int(rng.integers(2, MAX_Q_LEN)))
        doc = rng.integers(5, len(tok),
                           int(rng.integers(4, MAX_SEQ_LEN - MAX_Q_LEN - 3)))
        ids = ([tok.cls_token_id, *q.tolist(), tok.sep_token_id,
                *doc.tolist(), tok.sep_token_id])
        first = len(q) + 2
        if index % 3 == 0:
            start = end = -1
        else:
            start = int(rng.integers(first, first + len(doc)))
            end = int(rng.integers(start, first + len(doc)))
        return self.item(
            example_id=str(index), input_ids=ids, start_id=start, end_id=end,
            label_id=int(index % 5), start_position=float(rng.random()),
            end_position=float(rng.random()))


def trainer_params():
    return SimpleNamespace(
        loss="ce", smooth_alpha=0.01, focal_alpha=1.0, focal_gamma=2.0,
        w_start=1, w_end=1, w_start_reg=0.5, w_end_reg=0.5, w_cls=1, lr=1e-3,
        weight_decay=0.01, warmup_coef=0.3, optimizer="adam", finetune=False)


def train_weights() -> dict:
    """Class weights for the CE loss and the weighted sampler's."""
    sampler_weights = np.linspace(1.0, 2.0, N_TRAIN)
    return {"label_weights": np.asarray([0.1, 0.3, 0.2, 0.25, 0.15]),
            "sampler_weights": sampler_weights / sampler_weights.sum()}


def tiny_model(vocab_size: int, device: str = "cpu",
               dropout: float = 0.1) -> QAModel:
    """The tiny encoder, its weights drawn from seed 0."""
    cfg = EncoderConfig(vocab_size=vocab_size, hidden_dropout_prob=dropout,
                        attention_probs_dropout_prob=dropout, **TINY_MODEL)
    model = QAModel(cfg, dtype=torch.float32, device=device, ln_impl="fused")
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def tiny_trainer(tmp: Path, device: str = "cpu",
                 dropout: float = 0.1) -> Trainer:
    """The same tiny trainer in every process; the world (if any) is the
    one joined."""
    tok = Tokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    model = tiny_model(len(tok), device, dropout)
    train = VariedDataset(tok, N_TRAIN, seed=1)
    weights = train_weights()
    tp = trainer_params()
    return Trainer(model, build_loss(tp, weights),
                   make_collate_fun(tok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=tp, train_dataset=train,
                   test_dataset=VariedDataset(tok, N_TEST, seed=2),
                   train_batch_size=TRAIN_BATCH, test_batch_size=TEST_BATCH,
                   batch_split=BATCH_SPLIT, n_jobs=1, warmup_coef=0.0,
                   max_grad_norm=MAX_GRAD_NORM, train_weights=weights,
                   debug=True,
                   seed=0)


def callbacks():
    return [MAPCallback(list(labels2id.keys())), AccuracyCallback()]


@contextmanager
def first_step_gradients(trainer: Trainer):
    """Yields a dict that the first step fills with its gradients as they
    reach the clip: summed over the world and scaled by ``1/batch_split``,
    their magnitude intact (a clip that bites would leave only their
    direction to compare)."""
    grads, clip = {}, trainer_module.clip_by_global_norm_
    names = list(trainer.optimizer.params)

    def capture(tensors, max_norm):
        if not grads:
            grads.update((n, g.detach().cpu().clone())
                         for n, g in zip(names, tensors))
        return clip(tensors, max_norm)

    trainer_module.clip_by_global_norm_ = capture
    try:
        yield grads
    finally:
        trainer_module.clip_by_global_norm_ = clip


def run_trainer(out: Path, rank: int, device: str,
                dropout: float = 0.1) -> None:
    vocab_dir = out / f"vocab{rank}"
    vocab_dir.mkdir(parents=True, exist_ok=True)
    trainer = tiny_trainer(vocab_dir, device, dropout)
    record = {"batches": [], "values": [], "metrics": []}
    step = trainer.train_step

    def capture(inputs, labels):
        record["batches"].append((
            {k: v.cpu().clone() for k, v in inputs.items()},
            {k: v.cpu().clone() for k, v in labels.items()}))
        values = step(inputs, labels)
        record["values"].append(values)
        return values

    trainer.train_step = capture
    with first_step_gradients(trainer) as grads:
        trainer.train(after_epoch_funcs=[
            lambda epoch: record["metrics"].append(
                trainer.test(epoch, callbacks=callbacks()))])
    record["grads"] = grads
    record["params"] = {n: p.detach().cpu().clone()
                        for n, p in trainer.model.named_parameters()}
    torch.save(record, out / f"rank{rank}.pt")


def skip_gradient_all_reduce(named_params, *args, **kwargs) -> int:
    """A planted fault: this rank adds zeros to the others' gradient sum
    and keeps its own gradients."""
    named_params = list(named_params)
    own = [p.grad for _, p in named_params]
    for _, p in named_params:
        p.grad = torch.zeros_like(p)
    buckets = ALL_REDUCE_GRADIENTS(named_params, *args, **kwargs)
    for (_, p), grad in zip(named_params, own):
        p.grad = grad
    return buckets


ALL_REDUCE_GRADIENTS = collectives.all_reduce_gradients


def run_dead_peer(rank: int) -> None:
    if rank == 1:
        os._exit(0)
    collectives.all_reduce_sum_(torch.ones(4))
    collectives.all_reduce_sum_(torch.ones(4))


# -- the test side: the pair of processes and the oracle -----------------------

# CPU threads of every process this script starts (see run_pairs)
CPU_THREADS = 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pairs(*argv_ofs, deadline=PAIR_DEADLINE_S, drop_env=()):
    """Start, for each ``argv_of``, ``argv_of(rank, port)`` for ranks 0 and
    1 on a free port of its own, all at once, and wait for every process,
    killing them past ``deadline``; one retry of the lot when a rendezvous
    port was taken meanwhile. The processes get this one's environment
    without the variables in ``drop_env``. Returns ``[(rc, stderr)]`` per
    pair. Each process computes on one CPU thread (``OMP_NUM_THREADS``):
    with two OpenMP threads, a process's first ``torch.exp`` has come out
    up to 1.5e-4 off in half its elements now and then (its second call
    on the same input exact), and Adam turns such an error into flipped
    updates, so two runs that should agree bit for bit parted."""
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_THREADS),
               PYTHONPATH=str(REPO))
    for name in drop_env:
        env.pop(name, None)
    for attempt in range(2):
        procs = []
        for argv_of in argv_ofs:
            port = free_port()
            procs += [subprocess.Popen(
                argv_of(rank, port), cwd=str(REPO), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                for rank in range(2)]
        end = time.monotonic() + deadline
        out = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=max(1.0, end - time.monotonic()))
                out.append((p.returncode, err))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"a pair of processes outlived its "
                                 f"{deadline}s deadline") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if attempt == 0 and any("address already in use" in err.lower()
                                or "failed to bind" in err.lower()
                                for _, err in out):
            continue
        break
    return [out[i:i + 2] for i in range(0, len(out), 2)]


def worker_pairs(*modes, out: Path, device: str = "cpu"):
    """:func:`run_pairs` of this script's ``modes``, each writing into
    ``out / mode``."""
    def argv_of(mode):
        (out / mode).mkdir(parents=True, exist_ok=True)
        return lambda rank, port: [
            sys.executable, str(Path(__file__).resolve()), mode, str(rank),
            "2", str(port), str(out / mode), device]

    return run_pairs(*map(argv_of, modes))


def oracle(tmp: Path, record, device: str = "cpu"):
    """The one-process trainer on the regrouped global batches of
    ``record`` (rank 0's and rank 1's local batches): its step values,
    first-step gradients, eval metrics and parameters."""
    (tmp / "oracle").mkdir(parents=True, exist_ok=True)
    trainer = tiny_trainer(tmp / "oracle", device)
    values, metrics = [], []
    with first_step_gradients(trainer) as grads:
        for step, (b0, b1) in enumerate(zip(record[0]["batches"],
                                            record[1]["batches"])):
            trainer.global_step = step
            inputs, labels = (
                {k: v.to(device) for k, v in regroup_for_world(
                    {k: torch.cat([x[k], y[k]]) for k in x}, 2,
                    BATCH_SPLIT).items()}
                for x, y in zip(b0, b1))
            values.append(trainer.train_step(inputs, labels))
            metrics.append(trainer.test(step + 1, callbacks=callbacks()))
    params = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
    return SimpleNamespace(values=values, grads=grads, metrics=metrics,
                           params=params)


def rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradient sets."""
    a = torch.cat([got[n].reshape(-1) for n in sorted(want)])
    b = torch.cat([want[n].reshape(-1) for n in sorted(want)])
    return float((a - b).norm() / b.norm())


def main(argv) -> None:
    mode, rank, world, port, out, *device = argv
    rank, world = int(rank), int(world)
    device = device[0] if device else "cpu"
    torch.set_num_threads(CPU_THREADS)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=device, timeout_s=TIMEOUT_S)
    try:
        if mode == "trainer":
            run_trainer(Path(out), rank, device)
        elif mode == "trainer_nodrop":
            run_trainer(Path(out), rank, device, dropout=0.0)
        elif mode == "trainer_fault":
            if rank == 1:
                collectives.all_reduce_gradients = skip_gradient_all_reduce
            run_trainer(Path(out), rank, device)
        elif mode == "dead_peer":
            run_dead_peer(rank)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
