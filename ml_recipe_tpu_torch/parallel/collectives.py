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

The bucketed ZeRO-1 exchange (``--zero1_overlap bucketed``, the JAX
package's ``plan_grad_buckets``): :func:`plan_grad_buckets` cuts the
leaves, in the JAX package's ``tree_leaves`` order, into contiguous
:class:`GradBucket` runs of about ``bucket_bytes`` of f32 gradient, and
:class:`BucketedExchange` sums each bucket over the ``data`` ranks with
one reduce-scatter, issued (``async_op``) as soon as the last
micro-batch's backward has produced every gradient in it. Each bucket is
laid out as ``W`` equal chunks, chunk ``r`` holding, leaf after leaf,
rank ``r``'s ZeRO-1 slice of a sharded leaf and the whole gradient of a
leaf that stays whole, so the reduce-scatter leaves every rank exactly its
slices and the sums of the whole leaves. Under NCCL that is
``reduce_scatter_tensor``; gloo has none, so there it is an all-reduce of
the bucket and a slice. The buckets are issued in plan order on every
rank, whatever order autograd completes them in: a rank that issued
another order would deadlock its peers.

The mesh's collectives (``parallel/mesh.py``), each over one group of it:

- :func:`all_gather_cat`: one tensor from each rank of a group,
  concatenated along a dimension (the ZeRO-1 parameter all-gather over
  ``data``, the ``seq`` gather of the hidden states);
- :class:`SeqGather`: that gather over ``seq`` under autograd; its
  backward is the sum over the group of each rank's gradient of the whole,
  sliced to this rank's block (a reduce-scatter, run as an all-reduce and
  a slice: gloo has no reduce-scatter);
- :class:`RingTransport`: one hop of ring attention, each rank sending
  tensors to the next rank of its ``seq`` ring and receiving the previous
  rank's. Under NCCL a hop is ``batch_isend_irecv`` of the device tensors;
  gloo's point-to-point takes CPU tensors only, so there a hop of device
  tensors stages them through pinned host buffers (compute stays on the
  card). Each transport logs its kind once and counts its hops, the bytes
  it sent, the bytes it staged through the host and its seconds
  (``RingTransport.stats``);
- :class:`StageTransport`: a pipeline stage's hand-offs, activations to
  the next stage of its ``pipe`` group and their gradients back to the
  previous one, one tensor at a time (the JAX package's ``ppermute`` over
  ``pipe``). Sends are issued without waiting (NCCL ``isend`` of the
  device tensor; over gloo an ``isend`` of a host copy) and drained at the
  step's end (:meth:`StageTransport.drain`); a receive blocks until its
  tensor is there, so a stage whose peer is gone fails at the process
  group's timeout instead of running on alone. It keeps ``stats`` as the
  ring's transport does;
- :func:`all_reduce_sum_` over the ``pipe`` group: the squared norms of
  the stages' gradients, summed into the global-norm clip
  (``train/optim.py``);
- :class:`ModelTransport`: the all-reduce of a ``model`` group (tensor
  parallelism), under autograd as the two conjugate operators of the
  Megatron split: :func:`copy_to_model` (identity forward, all-reduce of
  the gradient backward) before the column-split products, and
  :func:`reduce_from_model` (all-reduce forward, identity backward) after
  the row-split ones. Under NCCL it all-reduces the device tensor; over
  gloo a CUDA tensor is staged through a pinned host buffer and reduced
  there in its own dtype (bf16 included). It logs its kind once and
  counts its all-reduces (forward and backward), the bytes reduced, the
  bytes staged through the host and its seconds (``stats``). A failed
  all-reduce raises: nothing falls back to a replicated layer.

Every function here runs its collective whenever a process group exists,
also a group of one; the trainer calls them only at world size > 1.
"""

from __future__ import annotations

import functools
import logging
import math
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import dist as pdist

logger = logging.getLogger(__name__)

# f32 elements per all-reduce bucket (16 MiB)
BUCKET_NUMEL = 1 << 22


def all_reduce_sum_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the world (or ``group``) in place; returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``tensor`` overwritten in place by global rank ``src``'s, over the
    world or ``group``; returns it."""
    dist.broadcast(tensor, src=src, group=group)
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
                         bucket_numel: int = BUCKET_NUMEL,
                         group=None) -> int:
    """Sum every parameter's ``.grad`` over the world (or ``group``) in
    place, bucket by bucket (see the module docstring); a missing ``.grad``
    is summed as zeros and then holds the sum. Returns the number of
    buckets."""
    buckets = bucket_plan(named_params, bucket_numel)
    for bucket in buckets:
        params = [p for _, p in bucket]
        flat = _flat([p.grad if p.grad is not None else torch.zeros_like(p)
                      for p in params])
        all_reduce_sum_(flat, group)
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
                         bucket_numel: int = BUCKET_NUMEL,
                         group=None) -> int:
    """Overwrite every parameter with global rank ``src``'s (over the world
    or ``group``), bucket by bucket; returns the number of buckets."""
    buckets = bucket_plan(named_params, bucket_numel)
    for bucket in buckets:
        params = [p for _, p in bucket]
        flat = _flat([p.detach() for p in params])
        dist.broadcast(flat, src=src, group=group)
        for p, chunk in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(chunk.view_as(p))
    return len(buckets)


def gather_to_host(tree: Dict[str, torch.Tensor],
                   group=None) -> Dict[str, torch.Tensor]:
    """Each rank's ``[rows, ...]`` tensors, concatenated in rank order on
    the CPU (every rank of the world, or of ``group``, calls it with the
    same keys and shapes, and gets the whole)."""
    out = {}
    for key in sorted(tree):
        out[key] = all_gather_cat(tree[key].detach(), group).cpu()
    return {key: out[key] for key in tree}


def all_gather_cat(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) of the world or ``group``,
    concatenated along ``dim`` in group order, on ``x``'s device. Over gloo
    the pieces cross through the CPU (gloo gathers no CUDA tensors)."""
    size = dist.get_world_size(group)
    src = x.contiguous()
    if pdist.backend() != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


class SeqGather(torch.autograd.Function):
    """``[B, L_loc, ...]`` blocks of a ``seq`` group gathered into the whole
    ``[B, L, ...]`` along dim 1, differentiably: the backward sums the
    group's gradients of the whole and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, index: int, size: int):
        ctx.group, ctx.index, ctx.size = group, index, size
        return all_gather_cat(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        all_reduce_sum_(g, ctx.group)
        block = g.shape[1] // ctx.size
        return g.narrow(1, ctx.index * block, block), None, None, None


def seq_gather(x: torch.Tensor, group, index: int, size: int) -> torch.Tensor:
    """:class:`SeqGather` (``x`` itself at ``size`` 1)."""
    if size <= 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return SeqGather.apply(x, group, index, size)
    return all_gather_cat(x, group, dim=1)


class RingTransport:
    """One rank's hops around its ``seq`` ring (the JAX package's
    ``ppermute`` to ``(i + 1) % n``): :meth:`hop` sends tensors to the
    next rank and returns the previous rank's, of the same shapes and
    dtypes. See the module docstring for the two transports; ``stats``
    counts hops, bytes sent, bytes staged through host memory and the
    seconds inside hops."""

    def __init__(self, ring: Sequence[int], rank: int):
        self.ring = tuple(int(r) for r in ring)
        i = self.ring.index(int(rank))
        self.next = self.ring[(i + 1) % len(self.ring)]
        self.prev = self.ring[(i - 1) % len(self.ring)]
        self.nccl = pdist.backend() == "nccl"
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self.reset()
        logger.info("Ring attention transport: ring of %d ranks %s, %s.",
                    len(self.ring), list(self.ring),
                    "batch_isend_irecv of device tensors (nccl)" if self.nccl
                    else "gloo isend/irecv, CUDA tensors staged through "
                         "pinned host buffers (attention stays on the card)")

    def reset(self) -> None:
        self.stats = {"hops": 0, "bytes": 0, "staged_bytes": 0,
                      "seconds": 0.0}

    def _host(self, t: torch.Tensor, slot: int) -> torch.Tensor:
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        return buf

    def hop(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        tensors = [t.contiguous() for t in tensors]
        device = tensors[0].device
        sent = sum(t.numel() * t.element_size() for t in tensors)
        if self.nccl:
            recv = [torch.empty_like(t) for t in tensors]
            ops = [dist.P2POp(dist.isend, t, self.next) for t in tensors]
            ops += [dist.P2POp(dist.irecv, r, self.prev) for r in recv]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        else:
            staged = device.type != "cpu"
            if staged:
                send = [self._host(t, 2 * i).copy_(t)
                        for i, t in enumerate(tensors)]
                recv = [self._host(t, 2 * i + 1)
                        for i, t in enumerate(tensors)]
                self.stats["staged_bytes"] += 2 * sent
            else:
                send = tensors
                recv = [torch.empty_like(t) for t in tensors]
            reqs = [dist.isend(t, self.next) for t in send]
            reqs += [dist.irecv(r, self.prev) for r in recv]
            for req in reqs:
                req.wait()
            if staged:
                recv = [r.to(device, copy=True) for r in recv]
        self.stats["hops"] += 1
        self.stats["bytes"] += sent
        self.stats["seconds"] += time.perf_counter() - t0
        return recv


class StageTransport:
    """One pipeline stage's hand-offs over its ``pipe`` group: ``stages``
    are the group's global ranks in stage order, ``rank`` this process's.
    :meth:`send_forward` / :meth:`recv_forward` move activations from stage
    k to k + 1, :meth:`send_backward` / :meth:`recv_backward` their
    gradients from k + 1 to k. See the module docstring for the two
    transports; ``stats`` counts hops (sends), bytes sent, bytes staged
    through host memory and the seconds spent in sends and receives."""

    def __init__(self, stages: Sequence[int], rank: int):
        self.stages = tuple(int(r) for r in stages)
        self.index = self.stages.index(int(rank))
        K = len(self.stages)
        self.next = self.stages[self.index + 1] if self.index + 1 < K else None
        self.prev = self.stages[self.index - 1] if self.index > 0 else None
        self.nccl = pdist.backend() == "nccl"
        self._pending: List[tuple] = []
        self.reset()
        logger.info("Pipeline stage transport: stage %d of %d over ranks %s, "
                    "%s.", self.index, K, list(self.stages),
                    "isend/irecv of device tensors (nccl)" if self.nccl
                    else "gloo isend/recv, CUDA tensors staged through host "
                         "buffers (the stages compute on their device)")

    def reset(self) -> None:
        self.stats = {"hops": 0, "bytes": 0, "staged_bytes": 0,
                      "seconds": 0.0}

    def _send(self, t: torch.Tensor, dst: int) -> None:
        t0 = time.perf_counter()
        t = t.detach().contiguous()
        nbytes = t.numel() * t.element_size()
        if not self.nccl and t.device.type != "cpu":
            t = t.to("cpu")
            self.stats["staged_bytes"] += nbytes
        self._pending.append((dist.isend(t, dst), t))
        self.stats["hops"] += 1
        self.stats["bytes"] += nbytes
        self.stats["seconds"] += time.perf_counter() - t0

    def _recv(self, shape, dtype, device, src: int) -> torch.Tensor:
        t0 = time.perf_counter()
        device = torch.device(device)
        staged = not self.nccl and device.type != "cpu"
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if staged else device)
        dist.recv(buf, src)
        if staged:
            self.stats["staged_bytes"] += buf.numel() * buf.element_size()
            buf = buf.to(device)
        self.stats["seconds"] += time.perf_counter() - t0
        return buf

    def send_forward(self, t: torch.Tensor) -> None:
        self._send(t, self.next)

    def recv_forward(self, shape, dtype, device) -> torch.Tensor:
        return self._recv(shape, dtype, device, self.prev)

    def send_backward(self, t: torch.Tensor) -> None:
        self._send(t, self.prev)

    def recv_backward(self, shape, dtype, device) -> torch.Tensor:
        return self._recv(shape, dtype, device, self.next)

    def drain(self) -> None:
        """Wait for every send issued so far (and release their buffers)."""
        t0 = time.perf_counter()
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()
        self.stats["seconds"] += time.perf_counter() - t0


class ModelTransport:
    """The all-reduce of one ``model`` group (see the module docstring):
    ``ranks`` are the group's global ranks, ``group`` its process group
    (None: the world). :meth:`all_reduce` returns the group's sum of a
    tensor, a new tensor of its shape, dtype and device."""

    def __init__(self, ranks: Sequence[int], rank: int, group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.nccl = pdist.backend() == "nccl"
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self.reset()
        logger.info("Tensor-parallel transport: model group of %d ranks %s, "
                    "%s.", len(self.ranks), list(self.ranks),
                    "all_reduce of device tensors (nccl)" if self.nccl
                    else "gloo all_reduce, CUDA tensors staged through pinned "
                         "host buffers in their own dtype (the layers stay "
                         "on the card)")

    def reset(self) -> None:
        self.stats = {"all_reduces": 0, "forward": 0, "backward": 0,
                      "bytes": 0, "staged_bytes": 0, "seconds": 0.0}

    def all_reduce(self, x: torch.Tensor, kind: str = "forward"
                   ) -> torch.Tensor:
        """The sum of ``x`` over the group; ``kind`` (``forward`` or
        ``backward``) is the counter it adds to."""
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        staged = not self.nccl and x.device.type != "cpu"
        if staged:
            # the copy to the host waits for the queue anyway: the clock
            # starts once the card has produced x
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        if staged:
            key = (tuple(x.shape), x.dtype)
            host = self._pinned.get(key)
            if host is None:
                host = self._pinned[key] = torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
            out = host.to(x.device, copy=True)
            self.stats["staged_bytes"] += 2 * nbytes
        else:
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.stats["all_reduces"] += 1
        self.stats[kind] += 1
        self.stats["bytes"] += nbytes
        self.stats["seconds"] += time.perf_counter() - t0
        return out


class CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the ``model``
    group (each rank's columns of the next products gave it a part)."""

    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transport.all_reduce(g, "backward"), None


class ReduceFromModel(torch.autograd.Function):
    """The sum over the ``model`` group forward (each rank's rows of the
    product gave a part of it); identity backward."""

    @staticmethod
    def forward(ctx, x, transport):
        return transport.all_reduce(x, "forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, transport: Optional[ModelTransport]
                  ) -> torch.Tensor:
    """:class:`CopyToModel` (``x`` itself without a transport)."""
    if transport is None:
        return x
    return CopyToModel.apply(x, transport)


def reduce_from_model(x: torch.Tensor, transport: Optional[ModelTransport]
                      ) -> torch.Tensor:
    """:class:`ReduceFromModel` (``x`` itself without a transport)."""
    if transport is None:
        return x
    return ReduceFromModel.apply(x, transport)


class GradBucket(NamedTuple):
    """One contiguous run of flattened-tree leaves whose gradients travel
    together: ``lo``/``hi`` index the leaf list (``leaves[lo:hi]``),
    ``size`` is the total element count of the bucket's accumulation
    vector, ``nbytes`` its f32 footprint."""

    lo: int
    hi: int
    size: int
    nbytes: int


def plan_grad_buckets(sizes: Sequence[int], *, bucket_bytes: int,
                      itemsize: int = 4) -> List[GradBucket]:
    """Partition per-leaf element counts into size-targeted CONTIGUOUS
    buckets (the JAX package's ``plan_grad_buckets``): leaves are walked in
    order and a bucket closes once it reaches ``bucket_bytes`` of f32
    payload, so a single oversized leaf gets a bucket of its own and small
    leaves coalesce."""
    bucket_bytes = max(1, int(bucket_bytes))
    buckets: List[GradBucket] = []
    lo = 0
    acc = 0

    def close(hi: int, nbytes: int) -> None:
        buckets.append(
            GradBucket(lo, hi, sum(int(s) for s in sizes[lo:hi]), nbytes))

    for i, size in enumerate(sizes):
        nbytes = int(size) * itemsize
        if nbytes >= bucket_bytes and acc > 0:
            # an oversized leaf gets a bucket of its OWN: close the running
            # bucket first instead of swallowing the small leaves
            close(i, acc)
            lo, acc = i, 0
        acc += nbytes
        if acc >= bucket_bytes:
            close(i + 1, acc)
            lo, acc = i + 1, 0
    if lo < len(sizes):
        close(len(sizes), acc)
    return buckets


def reduce_scatter_(flat: torch.Tensor, group=None,
                    async_op: bool = False):
    """``flat`` (``W`` equal chunks, one per rank of the world or
    ``group``) summed over the ranks; rank ``r`` keeps chunk ``r``. Returns
    ``(chunk, work)`` (``work`` None unless ``async_op``; the chunk is
    valid after ``work.wait()``). NCCL: ``reduce_scatter_tensor``; gloo: an
    all-reduce of ``flat`` in place and a view of chunk ``r``."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if pdist.backend() == "nccl":
        out = flat.new_empty(flat.numel() // size)
        work = dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM,
                                          group=group, async_op=async_op)
        return out, work
    work = dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)
    return flat.view(size, -1)[rank], work


class BucketedExchange:
    """The per-bucket gradient exchange of one optimizer step (see the
    module docstring).

    ``leaves``: ``(name, parameter, slice)`` in plan order, ``slice`` a
    ``parallel.sharding.ParamSlice`` (axis None: the leaf stays whole);
    ``buckets``: :class:`GradBucket` ranges over ``leaves``; ``index`` and
    ``size``: this rank's place on the ``data`` axis, ``group`` its group.
    Each trainable parameter gets a post-accumulate-grad hook once; between
    :meth:`arm` (before the last micro-batch's backward) and
    :meth:`finish` a hook marks its leaf done, and every bucket whose
    leaves are all done is issued, in plan order. :meth:`finish` issues
    the rest (a leaf without a gradient contributes zeros), waits for
    every handle and returns this rank's reduced gradients by name: a
    sharded leaf's padded slice, a whole leaf's whole. Of the last step,
    ``stats["early"]`` counts the buckets issued while the backward still
    owed gradients (the exchanges that can overlap it) and
    ``stats["late"]`` those issued at its last gradient or by
    :meth:`finish`."""

    def __init__(self, leaves, buckets: Sequence[GradBucket], *, index: int,
                 size: int, group=None):
        self.leaves = list(leaves)
        self.buckets = list(buckets)
        self.index, self.size, self.group = int(index), int(size), group
        self._bucket_of = {}
        for b, bucket in enumerate(self.buckets):
            for k in range(bucket.lo, bucket.hi):
                self._bucket_of[self.leaves[k][0]] = b
        self._armed = False
        self._reset()
        for name, p, _ in self.leaves:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(
                    functools.partial(self._on_grad, name))

    def _reset(self) -> None:
        self.stats = {"early": 0, "late": 0}
        self._missing = [sum(1 for k in range(b.lo, b.hi)
                             if self.leaves[k][1].requires_grad)
                         for b in self.buckets]
        self._owed = sum(self._missing)
        self._next = 0
        self._pending: List[tuple] = []

    def arm(self) -> None:
        """The next backward is the step's last: issue buckets as it fills
        them."""
        self._reset()
        self._armed = True

    def _on_grad(self, name: str, _param) -> None:
        if not self._armed:
            return
        b = self._bucket_of[name]
        self._missing[b] -= 1
        self._owed -= 1
        while (self._next < len(self.buckets)
               and self._missing[self._next] == 0):
            self._issue(self._next)
            self.stats["early" if self._owed else "late"] += 1

    @torch.no_grad()
    def _rows(self, p: torch.Tensor, z) -> torch.Tensor:
        """``[size, n]``: row r is rank r's part of ``p.grad`` flattened
        (its padded slice, or the whole gradient of a whole leaf)."""
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = g.float()
        if z.axis is None:
            return g.reshape(1, -1).expand(self.size, -1)
        from .sharding import pad_to

        g = pad_to(g, z.axis, z.padded)
        shape = list(g.shape)
        shape[z.axis:z.axis + 1] = [self.size, z.padded // self.size]
        return g.reshape(shape).movedim(z.axis, 0).reshape(self.size, -1)

    def _issue(self, b: int) -> None:
        bucket = self.buckets[b]
        leaves = self.leaves[bucket.lo:bucket.hi]
        flat = torch.cat([self._rows(p, z) for _, p, z in leaves],
                         dim=1).reshape(-1)
        chunk, work = reduce_scatter_(flat, self.group, async_op=True)
        self._pending.append((leaves, chunk, work))
        self._next = b + 1

    def finish(self) -> Dict[str, torch.Tensor]:
        """Issue the buckets the hooks did not, wait for every exchange and
        unpack this rank's reduced gradients by name (f32)."""
        self._armed = False
        while self._next < len(self.buckets):
            self._issue(self._next)
            self.stats["late"] += 1
        out: Dict[str, torch.Tensor] = {}
        for leaves, chunk, work in self._pending:
            if work is not None:
                work.wait()
            offset = 0
            for name, p, z in leaves:
                shape = list(p.shape)
                if z.axis is not None:
                    shape[z.axis] = z.padded // self.size
                n = math.prod(shape)
                out[name] = chunk.narrow(0, offset, n).view(shape)
                offset += n
        self._pending = []
        return out


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
