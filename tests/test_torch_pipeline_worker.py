"""One rank of the pipeline tests' gloo world on the CPU (no JAX); it holds
no test of its own.

    python tests/test_torch_pipeline_worker.py MODE RANK WORLD PORT OUT [DEVICE]

Every mode builds :mod:`torch_ddp_worker`'s tiny trainer (2 layers, so a
``pipe:2`` stage holds one) on one mesh after another in the same world
and writes ``OUT/<run>_rank<RANK>.pt`` per run: the local batches, each
step's values, the first step's gradients as they reach the clip, the
parameters this rank stores after the run, the most micro-batches a stage
held at once and the ZeRO-1 bucket count.

- ``train`` (4 ranks): on ``data:2,pipe:2``, dropout 0 unless named:
  ``trained`` GPipe at m = 4 through ``Trainer.train`` (2 debug steps and
  an eval after each, the run the JAX trainer is held to), then its memory
  pre-flight report on a stand-in measurement (``preflight_rank<R>.pt``); ``{gpipe,
  1f1b}{1,2,4}`` one step at m = 1, 2, 4 on one batch; ``replicated`` the
  ``gpipe2`` step with ``--pipe_param_sharding replicated``; ``zero1`` /
  ``zero1_off`` two steps at m = 2 with ZeRO-1 (``zero1_overlap
  bucketed``) / without; ``drop_a`` / ``drop_b`` / ``drop_1f1b`` four
  steps on one batch at dropout 0.1; ``save`` the ``zero1`` run, which
  then writes the sharded checkpoint ``OUT/ckpt`` (stage layout, GPipe),
  and ``saved_next`` one more step of it.
- ``resume`` (4 ranks, after ``train``): ``data4`` restores ``OUT/ckpt``
  on ``data:4`` with ZeRO-1; ``flip`` restores it on ``data:2,pipe:2``
  under 1F1B and takes the step ``saved_next`` took; ``jax`` restores the
  JAX package's pipe save ``OUT/jax_ckpt`` on ``data:2,pipe:2``.
- ``card`` (2 ranks on ``pipe:2``, for a CUDA ``DEVICE``): ``gpipe2`` one
  step at m = 2, dropout 0; ``gpipe8`` / ``1f1b8`` one step at m = 8, each
  with the step's peak CUDA memory (``peak``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import torch

import torch_ddp_worker as worker
from ml_recipe_tpu_torch.parallel import dist as pdist
from ml_recipe_tpu_torch.parallel.mesh import build_mesh
from ml_recipe_tpu_torch.train import trainer as trainer_module

MESH = "data:2,pipe:2"


def capture_clip(trainer, grads: dict):
    """Record the first step's gradients of the stage as they reach the
    clip (summed over ``data``, scaled by ``1/batch_split``)."""
    clip = trainer_module.clip_by_global_norm_
    names = list(trainer.optimizer.params)

    def capture(tensors, max_norm, **kw):
        if not grads:
            grads.update((n, g.detach().cpu().clone())
                         for n, g in zip(names, tensors))
        return clip(tensors, max_norm, **kw)

    trainer_module.clip_by_global_norm_ = capture
    return clip


def build(out: Path, rank: int, device: str, mesh: str, *, dropout=0.0,
          batch_split=2, **kw):
    vocab = out / f"vocab{rank}"
    vocab.mkdir(parents=True, exist_ok=True)
    return worker.tiny_trainer(vocab, device, dropout,
                               batch_split=batch_split,
                               mesh=build_mesh(mesh), **kw)


def first_batch(trainer):
    """The trainer's first placed training batch (this rank's rows)."""
    loader = trainer.train_dataloader
    loader.set_epoch(1)
    batches, prefetcher = trainer._batches(loader, "test")
    placed = next(iter(batches)).ready()
    if prefetcher is not None:
        prefetcher.close()
    return trainer._seq_consistent(placed)


def run(out: Path, rank: int, name: str, trainer, *, steps: int = 1,
        batch=None, train: bool = False) -> dict:
    """``steps`` steps of ``trainer`` on ``batch`` (its first when None),
    or with ``train`` its debug ``Trainer.train`` with an eval after each
    epoch; writes and returns the record."""
    record = {"batches": [], "values": [], "metrics": [], "grads": {}}
    clip = capture_clip(trainer, record["grads"])
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
        trainer_module.clip_by_global_norm_ = clip
    record["peak"] = torch.cuda.max_memory_allocated() if cuda else None
    record["params"] = {n: p.detach().cpu().clone()
                        for n, p in trainer.model.named_parameters()
                        if p.device.type != "meta"}
    record["in_flight"] = (trainer.pipe_runner.in_flight
                           if trainer.pipe_runner is not None else None)
    record["buckets"] = trainer.zero1_bucket_count
    record["layout"] = trainer.pipe_param_layout
    torch.save(record, out / f"{name}_rank{rank}.pt")
    return record


def _fake_compile(trainer):
    """A stand-in for the pre-flight's measurement (the JAX tests' double)."""
    return SimpleNamespace(memory_analysis=lambda: SimpleNamespace(
        argument_size_in_bytes=1_000, output_size_in_bytes=500,
        temp_size_in_bytes=4_000, alias_size_in_bytes=500))


def run_train(out: Path, rank: int, device: str) -> None:
    trained = build(out, rank, device, MESH, batch_split=4)
    run(out, rank, "trained", trained, train=True)
    torch.save(trained.preflight_train_step(
        None, None, compile_fn=_fake_compile, limit_bytes=10**9),
        out / f"preflight_rank{rank}.pt")
    for m in (1, 2, 4):
        for schedule in ("gpipe", "1f1b"):
            run(out, rank, f"{schedule}{m}",
                build(out, rank, device, MESH, batch_split=m,
                      pipe_schedule=schedule))
    run(out, rank, "replicated",
        build(out, rank, device, MESH,
              pipe_param_sharding="replicated"))
    run(out, rank, "zero1_off", build(out, rank, device, MESH), steps=2)
    zero1 = dict(optimizer_sharding="zero1", zero_min_size=0,
                 zero1_overlap="bucketed", sharded_checkpoint=True)
    run(out, rank, "zero1", build(out, rank, device, MESH, **zero1), steps=2)
    for name, schedule in (("drop_a", "gpipe"), ("drop_b", "gpipe"),
                           ("drop_1f1b", "1f1b")):
        run(out, rank, name, build(out, rank, device, MESH, dropout=0.1,
                                   pipe_schedule=schedule), steps=4)
    saver = build(out, rank, device, MESH, **zero1)
    batch = first_batch(saver)
    run(out, rank, "save", saver, steps=2, batch=batch)
    saver.debug = False
    saver.save_state_dict(out / "ckpt")
    run(out, rank, "saved_next", saver, batch=batch)


def run_resume(out: Path, rank: int, device: str) -> None:
    zero1 = dict(optimizer_sharding="zero1", zero_min_size=0)
    for name, mesh, kw, path in (
            ("data4", "data:4", zero1, out / "ckpt"),
            ("flip", MESH, dict(zero1, pipe_schedule="1f1b"), out / "ckpt"),
            ("jax", MESH, dict(zero1, batch_split=4), out / "jax_ckpt")):
        test_batch = worker.TEST_BATCH
        if name == "data4":   # four data ranks need an eval batch they divide
            worker.TEST_BATCH = 8
        try:
            trainer = build(out, rank, device, mesh, **kw)
        finally:
            worker.TEST_BATCH = test_batch
        trainer.load_state_dict(path)
        restored = dict(
            restored_step=trainer.global_step,
            mu={n: t.detach().cpu().clone()
                for n, t in trainer.optimizer.mu.items()},
            restored={n: p.detach().cpu().clone()
                      for n, p in trainer.model.named_parameters()
                      if p.device.type != "meta"})
        record = run(out, rank, name, trainer)
        torch.save({**record, **restored}, out / f"{name}_rank{rank}.pt")


def run_card(out: Path, rank: int, device: str) -> None:
    run(out, rank, "gpipe2", build(out, rank, device, "pipe:2"))
    for schedule in ("gpipe", "1f1b"):
        run(out, rank, f"{schedule}8",
            build(out, rank, device, "pipe:2", batch_split=8,
                  pipe_schedule=schedule))


def main(argv) -> None:
    mode, rank, world, port, out, *device = argv
    rank, world = int(rank), int(world)
    device = device[0] if device else "cpu"
    torch.set_num_threads(worker.CPU_THREADS)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=device, timeout_s=worker.TIMEOUT_S)
    try:
        {"train": run_train, "resume": run_resume,
         "card": run_card}[mode](Path(out), rank, device)
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
