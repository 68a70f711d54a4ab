"""One rank of the tensor-parallel tests' gloo worlds on the CPU (no JAX);
it holds no test of its own.

    python tests/test_torch_tensor_parallel_worker.py MODE RANK WORLD PORT OUT [DEVICE]

Every trainer is :mod:`torch_ddp_worker`'s tiny one (2 layers, 2 heads of
32, 128 MLP columns: one head and 64 columns a rank at ``model:2``). Each
run writes ``OUT/<run>_rank<RANK>.pt``: the local batches, each step's
values, the first step's gradients as they reach the clip (this rank's
slices), this rank's parameters after the run (and, gathered over its
``model`` group, the whole ones), the moments and the ZeRO-1 bucket
count.

- ``pair`` (2 ranks, ``model:2``): ``trained`` through ``Trainer.train``
  (2 debug steps of 2 micro-batches, dropout 0, an eval after each);
  ``drop_a`` / ``drop_b`` four steps on one batch at dropout 0.1; and
  ``attention``: one tensor-parallel ``SelfAttention`` on the weights and
  inputs of ``OUT/attention.pt``, its output at dropout 0 and, in
  training mode at dropout 0.1, the q, k, v and context of its heads.
- ``train`` (4 ranks, ``data:2,model:2``): ``zero1`` two debug steps with
  ZeRO-1 (every leaf planned), then its single-file save ``OUT/full.ch``
  and its sharded save ``OUT/ckpt``; ``bucketed`` the same with
  ``--zero1_overlap bucketed`` (inert).
- ``resume`` (4 ranks, ``data:2,model:2``, after ``train``): ``jax``
  restores the JAX package's sharded ``data:2,model:2`` save
  ``OUT/jax_ckpt`` with ZeRO-1 and takes one step; ``full`` restores
  ``OUT/full.ch`` likewise.
- ``card`` (2 ranks on ``model:2``, for a CUDA ``DEVICE``): ``trained`` as
  in ``pair``, with the transport's statistics.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

import torch_ddp_worker as worker
from ml_recipe_tpu_torch.parallel import dist as pdist
from ml_recipe_tpu_torch.parallel.mesh import build_mesh

MESH = "data:2,model:2"
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


def capture_clip(trainer, grads: dict):
    """Record the first step's gradients as they reach the clip."""
    from ml_recipe_tpu_torch.train import trainer as trainer_module

    clip = trainer_module.clip_by_global_norm_
    names = list(trainer.optimizer.params)

    def capture(tensors, max_norm, **kw):
        if not grads:
            grads.update((n, g.detach().cpu().clone())
                         for n, g in zip(names, tensors))
        return clip(tensors, max_norm, **kw)

    trainer_module.clip_by_global_norm_ = capture
    return lambda: setattr(trainer_module, "clip_by_global_norm_", clip)


def run(out: Path, rank: int, name: str, trainer, *, steps: int = 1,
        batch=None, train: bool = False) -> dict:
    """``steps`` steps of ``trainer`` on ``batch`` (its first when None),
    or with ``train`` its debug ``Trainer.train`` with an eval after each
    epoch; writes and returns the record."""
    record = {"batches": [], "values": [], "metrics": [], "grads": {}}
    restore = capture_clip(trainer, record["grads"])
    transport = trainer.mesh.model_transport
    transport.reset()
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
        restore()
    split = trainer.tp
    record["peak"] = torch.cuda.max_memory_allocated() if cuda else None
    record["transport"] = dict(transport.stats)
    record["params"] = {n: p.detach().cpu().clone()
                        for n, p in trainer.model.named_parameters()}
    record["whole"] = {n: split.gather(n, p.detach()).cpu()
                       for n, p in trainer.model.named_parameters()}
    record["mu"] = {n: t.detach().cpu().clone()
                    for n, t in trainer.optimizer.mu.items()}
    record["buckets"] = trainer.zero1_bucket_count
    record["preflight_probes"] = trainer.preflight_probes
    record["dims"] = dict(split.dims)
    record["model_index"] = trainer.mesh.model_index
    record["data_index"] = trainer.mesh.data_index
    torch.save(record, out / f"{name}_rank{rank}.pt")
    return record


def run_attention(out: Path, rank: int) -> None:
    """One ``SelfAttention`` of the tiny model's config at ``model:2`` on
    ``OUT/attention.pt`` (``params``: the JAX layer's flax tree,
    ``hidden`` ``[B, L, H]``, ``mask`` ``[B, L]``, ``seed`` an int): its
    output at dropout 0 (eval), then in training mode at dropout 0.1 from
    a generator seeded ``seed`` the q, k, v and context of this rank's
    heads."""
    from ml_recipe_tpu_torch.models import EncoderConfig, from_jax_params
    from ml_recipe_tpu_torch.models import encoder as enc

    case = torch.load(out / "attention.pt", weights_only=False)
    mesh = build_mesh("model:2")
    cfg = EncoderConfig(vocab_size=50, hidden_dropout_prob=0.1,
                        attention_probs_dropout_prob=0.1, **worker.TINY_MODEL)
    layer = enc.SelfAttention(cfg, dtype=torch.float32, device="cpu",
                              attention_impl="xla", ln_impl="fused",
                              tp=mesh)
    # under its flax name, which the tensor-parallel rules match
    state = from_jax_params({"attention": case["params"]},
                            model_index=mesh.model_index, model_size=2)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    layer.eval()
    with torch.no_grad():
        out_eval = layer(case["hidden"], case["mask"])
    seen = {}
    attention = enc.dot_product_attention

    def capture(q, k, v, mask, **kw):
        ctx = attention(q, k, v, mask, **kw)
        seen.update(q=q, k=k, v=v, ctx=ctx, seed=kw["seed"])
        return ctx

    enc.dot_product_attention = capture
    try:
        layer.train()
        with torch.no_grad():
            layer(case["hidden"], case["mask"],
                  torch.Generator().manual_seed(int(case["seed"])))
    finally:
        enc.dot_product_attention = attention
    torch.save({"out": out_eval, **{k: v.detach().clone()
                                    for k, v in seen.items()}},
               out / f"attention_rank{rank}.pt")


def run_pair(out: Path, rank: int, device: str) -> None:
    run(out, rank, "trained", build(out, rank, device, "model:2"),
        train=True)
    for name in ("drop_a", "drop_b"):
        run(out, rank, name, build(out, rank, device, "model:2",
                                   dropout=0.1), steps=4)
    run_attention(out, rank)


def run_train(out: Path, rank: int, device: str) -> None:
    run(out, rank, "bucketed",
        build(out, rank, device, MESH, zero1_overlap="bucketed", **ZERO1),
        train=True)
    saver = build(out, rank, device, MESH, **ZERO1)
    run(out, rank, "zero1", saver, train=True)
    saver.debug = False
    saver.save_state_dict(out / "full.ch")
    saver.sharded_checkpoint = True
    saver.save_state_dict(out / "ckpt")


def run_resume(out: Path, rank: int, device: str) -> None:
    for name, path in (("jax", out / "jax_ckpt"), ("full", out / "full.ch")):
        trainer = build(out, rank, device, MESH, **ZERO1)
        trainer.load_state_dict(path)
        restored = dict(
            restored_step=trainer.global_step,
            restored={n: p.detach().cpu().clone()
                      for n, p in trainer.model.named_parameters()},
            restored_mu={n: t.detach().cpu().clone()
                         for n, t in trainer.optimizer.mu.items()})
        record = run(out, rank, name, trainer)
        torch.save({**record, **restored}, out / f"{name}_rank{rank}.pt")


def run_card(out: Path, rank: int, device: str) -> None:
    run(out, rank, "trained", build(out, rank, device, "model:2"),
        train=True)


def main(argv) -> None:
    mode, rank, world, port, out, *device = argv
    rank, world = int(rank), int(world)
    device = device[0] if device else "cpu"
    torch.set_num_threads(worker.CPU_THREADS)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=device, timeout_s=worker.TIMEOUT_S)
    try:
        {"pair": run_pair, "train": run_train, "resume": run_resume,
         "card": run_card}[mode](Path(out), rank, device)
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
