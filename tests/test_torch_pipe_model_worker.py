"""One rank of the pipe x model tests' gloo worlds on the CPU (no JAX); it
holds no test of its own.

    python tests/test_torch_pipe_model_worker.py MODE RANK WORLD PORT OUT [DEVICE]

Every trainer is :mod:`torch_ddp_worker`'s tiny one (2 layers, 2 heads of
32, 128 MLP columns: at ``pipe:2,model:2`` a rank holds one layer, one
head and 64 columns). Each run writes ``OUT/<run>_rank<RANK>.pt``: the
local batches, each step's values, the first step's gradients as they
reach the clip and as it leaves them (this rank's slices of its stage's
leaves), the parameters this rank stores after the run and, gathered over
its ``model`` group, the whole ones, the moments, the most micro-batches
its stage held at once, the mesh coordinates, its model group's ranks and
the transport's counts.

- ``quad`` (4 ranks, ``pipe:2,model:2``, dropout 0 unless named):
  ``gpipe`` / ``1f1b`` one epoch of 5 steps through ``Trainer.train``
  (its debug cap lifted) and an eval after it, the runs the JAX trainer
  is held to; on the first batch: ``saver`` two GPipe steps, then its
  single-file save ``OUT/full.ch`` and its sharded save ``OUT/ckpt``;
  ``replicated`` the same two steps with ``--pipe_param_sharding
  replicated``; ``drop`` two steps at dropout 0.1.
- ``pair`` (2 ranks, beside ``quad``): ``pipe2`` (``pipe:2``) and
  ``model2`` (``model:2``) two steps on ``quad``'s first batch at dropout
  0; ``pipe2_drop`` ``drop`` on ``pipe:2``.
- ``octo`` (8 ranks, ``data:2,pipe:2,model:2``): ``zero1`` one step on
  its first batch with ZeRO-1 (every leaf planned).
- ``resume`` (4 ranks, ``pipe:2,model:2``, after ``quad``): ``jax``
  restores the JAX package's sharded ``pipe:2,model:2`` save
  ``OUT/jax_ckpt`` and takes one step; ``full`` restores ``OUT/full.ch``
  likewise (a checkpoint whose leaves are whole, onto the split stages).
- ``card`` (4 ranks on ``pipe:2,model:2``, for a CUDA ``DEVICE``):
  ``gpipe`` and ``1f1b`` two steps on the first batch at dropout 0, with
  the model group's transport statistics.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

import torch_ddp_worker as worker
from ml_recipe_tpu_torch.parallel import dist as pdist
from ml_recipe_tpu_torch.parallel.mesh import build_mesh
from ml_recipe_tpu_torch.train import trainer as trainer_module

MESH = "pipe:2,model:2"
ZERO1 = dict(optimizer_sharding="zero1", zero_min_size=0)


def build(out: Path, rank: int, device: str, mesh: str, *, dropout=0.0,
          **kw):
    vocab = out / f"vocab{rank}"
    vocab.mkdir(parents=True, exist_ok=True)
    return worker.tiny_trainer(vocab, device, dropout, mesh=build_mesh(mesh),
                               **kw)


def first_batch(trainer):
    """The trainer's first placed training batch (this rank's rows)."""
    loader = trainer.train_dataloader
    loader.set_epoch(1)
    batches, prefetcher = trainer._batches(loader, "test")
    placed = next(iter(batches)).ready()
    if prefetcher is not None:
        prefetcher.close()
    return trainer._seq_consistent(placed)


def capture_clip(trainer, record: dict):
    """Record the first step's gradients as they reach the clip
    (``grads``) and as it leaves them (``clipped``)."""
    clip = trainer_module.clip_by_global_norm_
    names = list(trainer.optimizer.params)

    def capture(tensors, max_norm, **kw):
        first = not record["grads"]
        if first:
            record["grads"].update((n, g.detach().cpu().clone())
                                   for n, g in zip(names, tensors))
        norm = clip(tensors, max_norm, **kw)
        if first:
            record["clipped"].update((n, g.detach().cpu().clone())
                                     for n, g in zip(names, tensors))
        return norm

    trainer_module.clip_by_global_norm_ = capture
    return lambda: setattr(trainer_module, "clip_by_global_norm_", clip)


def run(out: Path, rank: int, name: str, trainer, *, steps: int = 1,
        batch=None, train: bool = False) -> dict:
    """``steps`` steps of ``trainer`` on ``batch`` (its first when None),
    or with ``train`` one epoch of ``Trainer.train`` with an eval after
    it; writes and returns the record."""
    record = {"batches": [], "values": [], "metrics": [], "grads": {},
              "clipped": {}}
    restore = capture_clip(trainer, record)
    mesh = trainer.mesh
    transport = mesh.model_transport
    if transport is not None:
        transport.reset()
    try:
        if train:
            step = trainer.train_step

            def recorded(inputs, labels):
                record["batches"].append((
                    {k: v.cpu().clone() for k, v in inputs.items()},
                    {k: v.cpu().clone() for k, v in labels.items()}))
                values = step(inputs, labels)
                record["values"].append(values)
                return values

            trainer.train_step = recorded
            # one whole epoch: the debug cap of one step lifted
            trainer.debug, trainer.n_epochs = False, 1
            trainer.train(after_epoch_funcs=[
                lambda epoch: record["metrics"].append(
                    trainer.test(epoch, callbacks=worker.callbacks()))])
        else:
            batch = batch if batch is not None else first_batch(trainer)
            for _ in range(steps):
                record["batches"].append(tuple(
                    {k: v.cpu().clone() for k, v in batch[part].items()}
                    for part in ("inputs", "labels")))
                record["values"].append(trainer.train_step(batch["inputs"],
                                                           batch["labels"]))
                trainer.global_step += 1
    finally:
        restore()
    split = trainer.tp
    stored = {n: p.detach() for n, p in trainer.model.named_parameters()
              if p.device.type != "meta"}
    record["params"] = {n: p.cpu().clone() for n, p in stored.items()}
    record["whole"] = ({n: split.gather(n, p).cpu() for n, p in
                        stored.items()} if split is not None
                       else dict(record["params"]))
    record["mu"] = {n: t.detach().cpu().clone()
                    for n, t in trainer.optimizer.mu.items()}
    record["dims"] = dict(split.dims) if split is not None else {}
    record["in_flight"] = (trainer.pipe_runner.in_flight
                           if trainer.pipe_runner is not None else None)
    record["layout"] = trainer.pipe_param_layout
    record["coords"] = dict(pipe=mesh.pipe_index, data=mesh.data_index,
                            model=mesh.model_index)
    record["model_ranks"] = tuple(mesh.model_ranks)
    record["transport"] = (dict(transport.stats) if transport is not None
                           else None)
    record["preflight"] = trainer.preflight_report
    record["preflight_probes"] = trainer.preflight_probes
    torch.save(record, out / f"{name}_rank{rank}.pt")
    return record


def run_quad(out: Path, rank: int, device: str) -> None:
    for schedule in ("gpipe", "1f1b"):
        run(out, rank, schedule, build(out, rank, device, MESH,
                                       pipe_schedule=schedule), train=True)
    run(out, rank, "replicated",
        build(out, rank, device, MESH, pipe_param_sharding="replicated"),
        steps=2)
    run(out, rank, "drop", build(out, rank, device, MESH, dropout=0.1),
        steps=2)
    saver = build(out, rank, device, MESH)
    run(out, rank, "saver", saver, steps=2)
    saver.debug = False
    saver.save_state_dict(out / "full.ch")
    saver.sharded_checkpoint = True
    saver.save_state_dict(out / "ckpt")


def run_pair(out: Path, rank: int, device: str) -> None:
    run(out, rank, "pipe2", build(out, rank, device, "pipe:2"), steps=2)
    run(out, rank, "model2", build(out, rank, device, "model:2"), steps=2)
    run(out, rank, "pipe2_drop", build(out, rank, device, "pipe:2",
                                       dropout=0.1), steps=2)


def run_octo(out: Path, rank: int, device: str) -> None:
    run(out, rank, "zero1", build(out, rank, device, "data:2," + MESH,
                                  **ZERO1))


def run_resume(out: Path, rank: int, device: str) -> None:
    for name, path in (("jax", out / "jax_ckpt"), ("full", out / "full.ch")):
        trainer = build(out, rank, device, MESH)
        trainer.load_state_dict(path)
        restored = dict(
            restored_step=trainer.global_step,
            restored={n: p.detach().cpu().clone()
                      for n, p in trainer.model.named_parameters()
                      if p.device.type != "meta"},
            restored_mu={n: t.detach().cpu().clone()
                         for n, t in trainer.optimizer.mu.items()})
        record = run(out, rank, name, trainer)
        torch.save({**record, **restored}, out / f"{name}_rank{rank}.pt")


def run_card(out: Path, rank: int, device: str) -> None:
    for schedule in ("gpipe", "1f1b"):
        run(out, rank, schedule, build(out, rank, device, MESH,
                                       pipe_schedule=schedule), steps=2)


def main(argv) -> None:
    mode, rank, world, port, out, *device = argv
    rank, world = int(rank), int(world)
    device = device[0] if device else "cpu"
    torch.set_num_threads(worker.CPU_THREADS)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=device, timeout_s=worker.TIMEOUT_S)
    try:
        {"quad": run_quad, "pair": run_pair, "octo": run_octo,
         "resume": run_resume, "card": run_card}[mode](Path(out), rank,
                                                       device)
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
