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
- ``trainer_packed``: the same with sequence packing (:data:`PACKING`:
  ``--sequence_packing on --pack_splitting fill``), each rank collating its
  row slice of every planned global batch of packed rows;
- ``trainer_fault``: the same with a planted fault, rank 1 skipping the
  gradient all-reduce (:func:`skip_gradient_all_reduce`);
- ``trainer_options``: the same with ``--optimizer adamod
  --apex_loss_scale dynamic`` (:data:`OPTIONS`);
- ``trainer_overflow``: ``trainer_options`` with a planted overflow, an
  inf in rank 1's first gradient before the all-reduce
  (:func:`plant_inf_once`): both ranks must skip that step;
- ``async_sharded``: ``trainer_options`` with ``async_checkpoint`` and
  ``sharded_checkpoint``, which then saves ``OUT/ckpt`` synchronously
  and records the warnings it logged;
- ``dead_peer``: rank 1 leaves right after joining, rank 0 then reduces a
  tensor, which must fail (the run ends with an error, not a hang);
- ``ring``: a world of WORLD ranks on the mesh ``seq:WORLD`` runs
  ``ops.ring_attention.ring_attention`` on its blocks of the inputs in
  ``OUT/inputs.pt`` (:func:`run_ring`) and writes ``OUT/ring<RANK>.pt``;
- ``sp`` / ``sp_drop``: the tiny trainer on the mesh ``data:1,seq:2``
  (ring attention, the loss on the gathered sequence), dropout 0 / 0.1;
  ``sp_packed``: ``sp_drop`` with :data:`PACKING` (segment ids crossing
  the two ranks' blocks);
- ``zero1`` / ``zero1_off``: the tiny trainer on ``data:2`` at
  ``batch_split`` 1 with ``optimizer_sharding`` zero1 (every leaf planned:
  ``zero_min_size`` 0) / off, dropout 0; then (:func:`run_zero1`) its
  checkpoints, single-file and sharded, and its optimizer state after
  loading each of the JAX package's in ``OUT/jax.ch`` and ``OUT/jax_dir``
  when they are there;
- ``zero1_bucketed``: ``zero1`` with ``zero1_overlap='bucketed'`` at
  ``zero1_bucket_mb`` :data:`BUCKET_MB` (a bucket of a few leaves);
  ``zero1_bucketed_options``: ``trainer_options`` (``batch_split`` 2,
  dropout 0.1, adamod, dynamic loss scaling) under ZeRO-1, every leaf
  planned, bucketed likewise. Each also records the exchange's bucket
  count and, per step, the exchange's ``stats`` (buckets issued while the
  backward still owed gradients, and the rest; :func:`run_bucketed`).

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


# the trainer flags of the options modes
OPTIONS = dict(optimizer="adamod", apex_loss_scale="dynamic")
# the Trainer arguments of the packed mode: rows of MAX_SEQ_LEN holding up
# to 4 items, chunks split to fill holes of 4 tokens and more
PACKING = dict(sequence_packing="on", pack_splitting="fill",
               pack_max_segments=4, pack_min_fragment=4)


def trainer_params(**options):
    return SimpleNamespace(**{**dict(
        loss="ce", smooth_alpha=0.01, focal_alpha=1.0, focal_gamma=2.0,
        w_start=1, w_end=1, w_start_reg=0.5, w_end_reg=0.5, w_cls=1, lr=1e-3,
        weight_decay=0.01, warmup_coef=0.3, optimizer="adam", finetune=False,
        apex_loss_scale=None), **options})


def train_weights() -> dict:
    """Class weights for the CE loss and the weighted sampler's."""
    sampler_weights = np.linspace(1.0, 2.0, N_TRAIN)
    return {"label_weights": np.asarray([0.1, 0.3, 0.2, 0.25, 0.15]),
            "sampler_weights": sampler_weights / sampler_weights.sum()}


def tiny_model(vocab_size: int, device: str = "cpu",
               dropout: float = 0.1, mesh=None) -> QAModel:
    """The tiny encoder, its weights drawn from seed 0; sequence-parallel
    (ring attention) when ``mesh`` has a ``seq`` axis."""
    cfg = EncoderConfig(vocab_size=vocab_size, hidden_dropout_prob=dropout,
                        attention_probs_dropout_prob=dropout, **TINY_MODEL)
    ring = mesh is not None and mesh.seq_size > 1
    model = QAModel(cfg, dtype=torch.float32, device=device, ln_impl="fused",
                    attention_impl="ring" if ring else "auto", mesh=mesh)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def tiny_trainer(tmp: Path, device: str = "cpu", dropout: float = 0.1,
                 options: dict = None, batch_split: int = BATCH_SPLIT,
                 **trainer_kw) -> Trainer:
    """The same tiny trainer in every process; the world (if any) is the
    one joined. ``options``: trainer flags over :func:`trainer_params`'s;
    ``trainer_kw``: more ``Trainer`` arguments (a ``mesh`` also reaches the
    model)."""
    tok = Tokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    model = tiny_model(len(tok), device, dropout, trainer_kw.get("mesh"))
    train = VariedDataset(tok, N_TRAIN, seed=1)
    weights = train_weights()
    tp = trainer_params(**(options or {}))
    return Trainer(model, build_loss(tp, weights),
                   make_collate_fun(tok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=tp, train_dataset=train,
                   test_dataset=VariedDataset(tok, N_TEST, seed=2),
                   train_batch_size=TRAIN_BATCH, test_batch_size=TEST_BATCH,
                   batch_split=batch_split, n_jobs=1, warmup_coef=0.0,
                   max_grad_norm=MAX_GRAD_NORM, train_weights=weights,
                   debug=True,
                   seed=0, **trainer_kw)


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


def run_trainer(out: Path, rank: int, device: str, dropout: float = 0.1,
                options: dict = None, **trainer_kw) -> Trainer:
    vocab_dir = out / f"vocab{rank}"
    vocab_dir.mkdir(parents=True, exist_ok=True)
    trainer = tiny_trainer(vocab_dir, device, dropout, options, **trainer_kw)
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
    record["optimizer_count"] = trainer.optimizer.count
    torch.save(record, out / f"rank{rank}.pt")
    return trainer


def plant_inf_once(named_params, *args, **kwargs) -> int:
    """A planted overflow: the first call puts an inf into this rank's
    first gradient before it is summed over the world."""
    named_params = list(named_params)
    if not PLANTED:
        PLANTED.append(True)
        named_params[0][1].grad.view(-1)[0] = float("inf")
    return ALL_REDUCE_GRADIENTS(named_params, *args, **kwargs)


PLANTED = []


def run_async_sharded(out: Path, rank: int, device: str) -> None:
    """``trainer_options`` with an async sharded save at world size 2:
    synchronous, with one warning, and the checkpoint complete at once."""
    import logging

    warnings = []

    class Collect(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    logging.getLogger("ml_recipe_tpu_torch").addHandler(Collect())
    trainer = run_trainer(out, rank, device, options=OPTIONS,
                          async_checkpoint=True, sharded_checkpoint=True)
    trainer.debug = False
    for _ in range(2):
        trainer.save_state_dict(out / "ckpt")
        # synchronous: nothing in flight, the directory complete on return
        assert not trainer._async_ckpt.pending()
    torch.save({"warnings": warnings,
                "complete": (out / "ckpt" / "manifest.msgpack").exists()},
               out / f"async{rank}.pt")


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


def run_ring(out: Path, rank: int, world: int) -> None:
    """Every case of ``OUT/inputs.pt`` (a list of dicts: ``q, k, v, g``
    ``[B, L, H, D]``, a ``mask`` and ``seg`` ids (or None) ``[B, L]``, the
    ``seed`` and the ``rate``) through ring attention on this rank's
    blocks: the output and the gradients of ``sum(out * g)``."""
    from ml_recipe_tpu_torch.ops.ring_attention import ring_attention
    from ml_recipe_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(f"seq:{world}")
    results = []
    for case in torch.load(out.parent / "inputs.pt"):
        L = case["q"].shape[1]
        block = slice(rank * L // world, (rank + 1) * L // world)
        q, k, v = (case[n][:, block].clone().requires_grad_()
                   for n in ("q", "k", "v"))
        seg = case["seg"]
        got = ring_attention(q, k, v, case["mask"][:, block], mesh=mesh,
                             rate=case["rate"], seed=case["seed"],
                             segment_ids=None if seg is None else seg[:, block])
        (got * case["g"][:, block]).sum().backward()
        results.append({"out": got.detach(), "dq": q.grad, "dk": k.grad,
                        "dv": v.grad})
    torch.save({"results": results, "hops": mesh.ring.stats["hops"]},
               out / f"ring{rank}.pt")


def run_zero1(out: Path, rank: int, device: str, mode: str) -> None:
    """``zero1`` / ``zero1_off`` (see the module docstring)."""
    from ml_recipe_tpu_torch.train.checkpoint import read_state

    trainer = run_trainer(out, rank, device, dropout=0.0, batch_split=1,
                          optimizer_sharding=mode, zero_min_size=0)
    record = {"opt_bytes": sum(t.numel() * t.element_size() for t in
                               trainer.optimizer.state_tensors()),
              "buckets": trainer.zero1_bucket_count,
              "exchange": trainer._exchange is not None,
              "state": trainer.optimizer.flax_state(copy=True)}
    trainer.debug = False
    trainer.save_state_dict(out / "port.ch")
    trainer.sharded_checkpoint = True
    trainer.save_state_dict(out / "port_dir")
    for name in ("jax.ch", "jax_dir"):
        if (out.parent / name).exists():
            trainer.load_state_dict(out.parent / name)
            record[name] = trainer.optimizer.flax_state(copy=True)
    if rank == 0:
        record["saved"] = read_state(out / "port.ch")["optimizer"]
    torch.save(record, out / f"zero{rank}.pt")


def run_dead_peer(rank: int) -> None:
    if rank == 1:
        os._exit(0)
    collectives.all_reduce_sum_(torch.ones(4))
    collectives.all_reduce_sum_(torch.ones(4))


# -- the test side: the pair of processes and the oracle -----------------------

def run_bucketed(out: Path, rank: int, device: str, mode: str) -> None:
    """``zero1_bucketed`` / ``zero1_bucketed_options`` (see the module
    docstring)."""
    kw = dict(optimizer_sharding="zero1", zero_min_size=0,
              zero1_overlap="bucketed", zero1_bucket_mb=BUCKET_MB)
    if mode == "zero1_bucketed":
        kw.update(dropout=0.0, batch_split=1)
    else:
        kw.update(options=OPTIONS)
    exchange_stats = []
    step = Trainer.train_step

    def counted(self, inputs, labels):
        values = step(self, inputs, labels)
        exchange_stats.append(dict(self._exchange.stats))
        return values

    Trainer.train_step = counted
    try:
        trainer = run_trainer(out, rank, device, **kw)
    finally:
        Trainer.train_step = step
    torch.save({"buckets": trainer.zero1_bucket_count,
                "stats": exchange_stats}, out / f"buckets{rank}.pt")


# f32 MB per gradient bucket of the bucketed modes: ~260 f32 elements, so
# the tiny model's 40 leaves fall into buckets of one to a few leaves
BUCKET_MB = 0.001

# CPU threads of every process this script starts (see run_pairs)
CPU_THREADS = 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pairs(*argv_ofs, deadline=PAIR_DEADLINE_S, drop_env=(), ranks=2):
    """Start, for each ``argv_of``, ``argv_of(rank, port)`` for ranks 0 and
    1 (``0 .. ranks - 1``) on a free port of its own, all at once, and wait
    for every process,
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
                for rank in range(ranks)]
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
    return [out[i:i + ranks] for i in range(0, len(out), ranks)]


def worker_pairs(*modes, out: Path, device: str = "cpu", ranks: int = 2):
    """:func:`run_pairs` of this script's ``modes``, each writing into
    ``out / mode``."""
    def argv_of(mode):
        (out / mode).mkdir(parents=True, exist_ok=True)
        return lambda rank, port: [
            sys.executable, str(Path(__file__).resolve()), mode, str(rank),
            str(ranks), str(port), str(out / mode), device]

    return run_pairs(*map(argv_of, modes), ranks=ranks)


def oracle(tmp: Path, record, device: str = "cpu", options: dict = None,
           **trainer_kw):
    """The one-process trainer (with the trainer flags ``options`` and the
    ``Trainer`` arguments ``trainer_kw``) on the regrouped global batches of
    ``record`` (rank 0's and rank 1's local batches): its step values,
    first-step gradients, eval metrics and parameters."""
    (tmp / "oracle").mkdir(parents=True, exist_ok=True)
    trainer = tiny_trainer(tmp / "oracle", device, options=options,
                           **trainer_kw)
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


def oracle_whole(tmp: Path, record, device: str = "cpu",
                 dropout: float = 0.1, **trainer_kw):
    """The one-process trainer on ``record``'s batches as they are (a rank
    of ``data:1``, whose batches are the whole global batches): its step
    values, first-step gradients and parameters."""
    tmp.mkdir(parents=True, exist_ok=True)
    trainer = tiny_trainer(tmp, device, dropout, **trainer_kw)
    values = []
    with first_step_gradients(trainer) as grads:
        for step, (inputs, labels) in enumerate(record["batches"]):
            trainer.global_step = step
            values.append(trainer.train_step(
                {k: v.to(device) for k, v in inputs.items()},
                {k: v.to(device) for k, v in labels.items()}))
    params = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
    return SimpleNamespace(values=values, grads=grads, params=params)


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
        elif mode == "trainer_packed":
            run_trainer(Path(out), rank, device, **PACKING)
        elif mode == "trainer_fault":
            if rank == 1:
                collectives.all_reduce_gradients = skip_gradient_all_reduce
            run_trainer(Path(out), rank, device)
        elif mode == "trainer_options":
            run_trainer(Path(out), rank, device, options=OPTIONS)
        elif mode == "trainer_overflow":
            if rank == 1:
                collectives.all_reduce_gradients = plant_inf_once
            run_trainer(Path(out), rank, device, options=OPTIONS)
        elif mode == "async_sharded":
            run_async_sharded(Path(out), rank, device)
        elif mode == "dead_peer":
            run_dead_peer(rank)
        elif mode == "ring":
            run_ring(Path(out), rank, world)
        elif mode in ("sp", "sp_drop", "sp_packed"):
            from ml_recipe_tpu_torch.parallel.mesh import build_mesh

            run_trainer(Path(out), rank, device,
                        dropout=0.0 if mode == "sp" else 0.1,
                        mesh=build_mesh("data:1,seq:2"),
                        **(PACKING if mode == "sp_packed" else {}))
        elif mode in ("zero1", "zero1_off"):
            run_zero1(Path(out), rank, device,
                      "zero1" if mode == "zero1" else "off")
        elif mode in ("zero1_bucketed", "zero1_bucketed_options"):
            run_bucketed(Path(out), rank, device, mode)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
