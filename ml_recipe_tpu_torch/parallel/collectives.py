"""The collectives of data-parallel training, and the batch layout they
imply (the port of ``ml_recipe_tpu/parallel/collectives.py`` ``pmean`` /
``psum_scalar`` and ``parallel/sharding.py`` ``gather_to_host`` /
``make_global_array(..., batch_axis=1)``).

- :func:`all_reduce_gradients`: every parameter's f32 ``.grad`` summed over
  the world, once per optimizer step. The gradients are flattened into
  buckets of :data:`BUCKET_NUMEL` elements in one parameter order (sorted
  by name, the same on every rank whatever order a checkpoint load left);
  a parameter without a gradient contributes zeros, so every rank has the
  same layout. Each bucket is one ``all_reduce`` with SUM, whose result is
  the same on every rank, so the replicas stay bit-identical.
- :func:`broadcast_parameters`: rank 0's parameters onto every rank, in the
  same buckets.
- :func:`all_reduce_sum_`: a small tensor (the loss denominators, the
  logged losses) summed in place.
- :func:`gather_to_host`: each rank's rows of a dict of tensors,
  concatenated in rank order on the CPU. Gloo gathers no CUDA tensors, so
  over gloo the rows go through the CPU first.
- :func:`regroup_for_world`: the one-process batch whose consecutive
  micro-batches are the W-rank step's global micro-batches.

Every function here runs its collective whenever a process group exists,
also a group of one; the trainer calls them only at world size > 1.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import dist as pdist

# f32 elements per all-reduce bucket (16 MiB)
BUCKET_NUMEL = 1 << 22


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the world in place; returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def bucket_plan(named_params: Iterable[Tuple[str, torch.Tensor]],
                bucket_numel: int = BUCKET_NUMEL
                ) -> List[List[Tuple[str, torch.Tensor]]]:
    """``named_params`` sorted by name and cut into consecutive buckets of
    at most ``bucket_numel`` elements (a larger tensor gets a bucket of its
    own)."""
    buckets: List[List[Tuple[str, torch.Tensor]]] = []
    size = 0
    for name, p in sorted(named_params, key=lambda item: item[0]):
        n = p.numel()
        if not buckets or size + n > bucket_numel:
            buckets.append([])
            size = 0
        buckets[-1].append((name, p))
        size += n
    return buckets


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def all_reduce_gradients(named_params: Iterable[Tuple[str, torch.Tensor]],
                         bucket_numel: int = BUCKET_NUMEL) -> int:
    """Sum every parameter's ``.grad`` over the world in place, bucket by
    bucket (see the module docstring); a missing ``.grad`` is summed as
    zeros and then holds the sum. Returns the number of buckets."""
    buckets = bucket_plan(named_params, bucket_numel)
    for bucket in buckets:
        params = [p for _, p in bucket]
        flat = _flat([p.grad if p.grad is not None else torch.zeros_like(p)
                      for p in params])
        all_reduce_sum_(flat)
        for p, chunk in zip(params, flat.split([p.numel() for p in params])):
            chunk = chunk.view_as(p).to(p.dtype)
            if p.grad is None:
                p.grad = chunk.clone()
            else:
                p.grad.copy_(chunk)
    return len(buckets)


@torch.no_grad()
def broadcast_parameters(named_params: Iterable[Tuple[str, torch.Tensor]],
                         src: int = 0,
                         bucket_numel: int = BUCKET_NUMEL) -> int:
    """Overwrite every parameter with rank ``src``'s, bucket by bucket;
    returns the number of buckets."""
    buckets = bucket_plan(named_params, bucket_numel)
    for bucket in buckets:
        params = [p for _, p in bucket]
        flat = _flat([p.detach() for p in params])
        dist.broadcast(flat, src=src)
        for p, chunk in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(chunk.view_as(p))
    return len(buckets)


def gather_to_host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's ``[rows, ...]`` tensors, concatenated in rank order on
    the CPU (every rank calls it with the same keys and shapes, and gets
    the whole)."""
    world = pdist.process_count()
    via_host = pdist.backend() != "nccl"
    out = {}
    for key in sorted(tree):
        x = tree[key].detach().contiguous()
        if via_host:
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        out[key] = torch.cat(parts).cpu()
    return {key: out[key] for key in tree}


def regroup_for_world(batch: dict, world: int, batch_split: int) -> dict:
    """The global batch reordered so that a one-process step's consecutive
    micro-batches are the W-rank step's global micro-batches.

    Rank r holds rows ``[r*B/W, (r+1)*B/W)`` of the global batch of B rows
    and splits them into ``batch_split`` micro-batches of ``m = B/(W *
    batch_split)`` rows; global micro-batch g is the concatenation, in rank
    order, of each rank's micro-batch g (the JAX package's
    ``make_global_array(..., batch_axis=1)``). ``batch`` maps names to
    ``[B, ...]`` numpy arrays or tensors (nested dicts allowed)."""
    if isinstance(batch, dict):
        return {k: regroup_for_world(v, world, batch_split)
                for k, v in batch.items()}
    rows = batch.shape[0]
    if rows % (world * batch_split):
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{world} ranks x {batch_split} micro-batches")
    local, m = rows // world, rows // (world * batch_split)
    order = np.concatenate([
        np.arange(r * local + g * m, r * local + (g + 1) * m)
        for g in range(batch_split) for r in range(world)])
    if isinstance(batch, torch.Tensor):
        return batch[torch.from_numpy(order).to(batch.device)]
    return np.asarray(batch)[order]
