"""Training runtime (the port of ``ml_recipe_tpu/train/trainer.py``): the
sequential accumulation step, on one device or as one of W data-parallel
processes (``parallel/``).

Per optimizer step, as the JAX ``_build_train_step`` computes it:

1. the batch splits into ``batch_split`` micro-batches of consecutive rows;
2. each micro-batch runs forward with dropout, the ``WeightedLoss`` and
   ``loss.backward()``, which accumulates into the f32 ``.grad`` of the f32
   master weights (the JAX step's f32 accumulation carry);
3. the gradients are scaled by ``1/batch_split``, clipped to
   ``c / max(norm, c)`` with ``c = max_grad_norm``, and the optimizer
   (``train/optim.py``: ``adam`` or ``adamod``) updates the parameters in
   place at ``schedule(count)``.

Under ``--apex_loss_scale`` (``train/loss_scale.py``) each micro-batch
loss is multiplied by the scale before ``backward()``; after the mean over
the micro-batches the gradients are unscaled and checked, in JAX's order:
a step with a non-finite gradient skips the clip and the optimizer, so
the parameters, the moments and the counts stay bit for bit as they were,
and the scale backs off. Under ``--finetune`` the frozen modules have no
gradient at all (``requires_grad_(False)``, ``build_optimizer``). The
logged ``lr`` is ``schedule(global_step)``, or with loss scaling the
schedule at the optimizer's own count, which overflow steps do not
advance; ``loss_scale`` and ``grads_finite`` are logged beside the losses.

Dropout is reproducible from ``(seed, step)``: each step seeds one CPU
generator from them (numpy ``SeedSequence``), and draws from it one seed per
micro-batch for a generator on the model's device, which the model's every
dropout and attention-dropout seed come from.

With W processes (the JAX package's multi-process semantics): each process
holds its row slice ``[r*B/W, (r+1)*B/W)`` of every global batch (the
samplers and loaders slice it) and splits it into ``batch_split``
micro-batches of m rows. Global micro-batch g is the rank-order
concatenation of every process's micro-batch g, and the step is that of
one process on those global micro-batches
(``parallel.regroup_for_world``):

- each loss divides by its global denominator: the ``[batch_split, heads]``
  denominators are computed from the labels before the first forward and
  summed over the world in one all-reduce, so the processes' losses sum to
  the global micro-batch's loss;
- dropout is drawn at the global micro-batch's shape from the same
  generator on every process, each keeping its rows
  (``global_rows=(r*m, W*m)``, ``models/encoder.py``);
- after the accumulation the gradients are summed over the world in buckets
  (``parallel.all_reduce_gradients``), then scaled and clipped, so every
  replica takes the same update; the parameters are broadcast from rank 0
  when the trainer is built and after a checkpoint is loaded;
- the logged losses are summed over the world; eval gathers every
  process's predictions and labels in rank order before the loss, the
  meters and the callbacks; the writer, the logged metrics and the
  single-file checkpoints are rank 0's, and a sharded checkpoint is written
  by every process.

The loaders are the JAX package's (bucketed when ``length_buckets``;
packed when ``sequence_packing``, which supersedes the buckets: the loss
becomes ``PackedWeightedLoss``, each micro-batch's heads are per segment,
and the epoch meters weigh each step by its real segments), and
``device_prefetch`` stages batches onto the device on a background thread
(``data/device_prefetch.py``). ``test`` runs the eval loop under
``torch.inference_mode`` with the callbacks; ``debug`` takes one step per
epoch over two epochs and 11 eval batches, and skips checkpoint writes, as
in the JAX trainer. ``sharded_checkpoint`` writes the JAX package's
sharded-directory layout instead of one file; a resume reads either
(``train/checkpoint.py``). With ``async_checkpoint`` a save blocks only for
the host snapshot, and the write runs on a background thread
(``resilience/checkpoint_async.py``) that ``finish_pending_checkpoint``
waits for; a sharded save in a world of several processes stays
synchronous (its barriers must not run beside the step's collectives).

The mesh (``parallel/mesh.py``, ``--mesh data:D,seq:S``, by default
``data:W``): the W = D*S processes sit at ``(data_index, seq_index)``.
Everything above that speaks of processes' rows speaks of the data
coordinate: the samplers and loaders slice the global batch by
``data_index`` of D (the S ranks of a ``seq`` group receive the same
rows), the dropout rows and the loss denominators are the data group's.
With S > 1 the model runs sequence-parallel (``attention_impl='ring'``,
``models/encoder.py``): each rank of a ``seq`` group computes the whole
loss of its data group's rows, so each loss is scaled by ``1/S`` before
``backward()`` and the world's gradient sum is the gradient of the global
loss (``sum`` over ``seq``, the data group's partial losses summed over
``data``, one all-reduce over the world). Eval runs the same ring and
gathers the predictions over the ``data`` group.

ZeRO-1 (``optimizer_sharding='zero1'``, active when D > 1, as the JAX
trainer's ``zero_enabled``): the optimizer keeps the moments of this
rank's padded slice of each planned parameter (``train/optim.py``), after
the same all-reduce and clip, and all-gathers the updated slices over
``data``. With ``zero1_overlap='bucketed'`` the all-reduce becomes
``zero1_bucket_count`` reduce-scatters of about ``zero1_bucket_mb`` each,
over the JAX package's leaf order, each issued as soon as the last
micro-batch's backward has produced every gradient in it
(``parallel.collectives.BucketedExchange``); every rank then holds the sum
of its slices and of the whole leaves, the global-norm clip runs over the
whole gradient from them (one all-reduced scalar), and the optimizer
updates the slices it got. Bucketing is inert, and logged so, without an
active ZeRO-1 layout (off, or a data axis of 1) and on a ``seq`` mesh.
Checkpoints record ``opt_sharding`` ``'zero1'`` (only then) and
the mesh's axes as ``mesh_axes``, and hold the padded moments the JAX
trainer writes at the same mesh: the single file gathers them (every
process takes part, rank 0 writes), the sharded directory has each
``seq_index`` 0 process write its pieces. A resume crops or zero-fills
any saved layout onto the live one.

The runtime subsystems (``cli/train.py`` builds them from the flags), all
off by default and none of them changing the arithmetic:

- ``watchdog`` (``resilience/watchdog.py``): one frame per train epoch and
  eval pass, ticked per step, and a frame of 8x the timeout around each
  checkpoint save and persist wait; ``note_progress`` after each step;
- the trace spans (``metrics/trace.py``, the process-global tracer):
  ``data_wait``, ``place``, ``step``, ``prefetch_stage``,
  ``checkpoint_save``, ``ckpt_snapshot``, ``checkpoint_restore`` and the
  ``_train``/``_test`` units;
- ``telemetry`` (``train/telemetry.py``): each step's ``data_wait`` /
  ``host`` / ``device`` breakdown, its scalars, the checkpoint, eval and
  ZeRO-1 observers, and the first step's kernel-library loads;
- ``trace_dir``: a ``torch.profiler`` capture of steps 2-4 of epoch 1
  (from step 0 in debug runs and epochs shorter than 5 steps; the next
  steps after a capture without CUDA activity,
  ``metrics.trace.ProfilerWindow``);
- the fault sites ``trainer.step`` and ``trainer.eval_step``, before each
  step and eval batch (``resilience/faults.py``).

With telemetry or a tracer installed the step synchronizes CUDA before it
reads the clock, so ``device`` is execution, not launches (the JAX rule);
without them the step keeps its launches and syncs.

The memory pre-flight (``hbm_preflight``, the JAX trainer's HBM
pre-flight): before the first step of a run, one forward and backward at
the micro-batch shape, with no optimizer update, measured by the CUDA
allocator (``utils/hbm.py``); a need above the card's memory raises
``batch_split`` to the next legal split (``next_batch_split``) and measures
again. On the bucketed path every bucket is measured before the first batch
is drawn, largest seq first, and a raised split re-derives the loader's
bucket batches. The probe restores every generator it touches and leaves
the loader where it was, so a run whose plan fits trains bit for bit as
without it. With several processes the ranks all-reduce the largest need
and so take one decision. ``preflight_probes`` counts the probes (each
launches the kernels of one training micro-batch).

A restore from a sharded checkpoint saved under another mesh warns
("ELASTIC RESUME / topology change") and records ``mesh_shrunk`` in the
flight recorder (``_warn_topology_change``). ``in_step`` is True from the
start of an optimizer step to its end; a SIGTERM handler that finds it set
sets ``interrupt_pending``, and the loop raises ``KeyboardInterrupt`` at
the step's end (``cli/train.py``).

Tensor parallelism (``--mesh model:T``, ``data:D,model:T``; the JAX
trainer on a ``model`` mesh): every rank of a ``model`` group steps on one
set of rows (``_seq_consistent`` broadcasts the batch from the group's
first rank) through its slices of the attention and MLP blocks
(``models/encoder.py``); the leaves every rank holds whole get the same
gradient on each rank of the group, a split leaf's gradient is the slice
of the whole one. So a split leaf's gradient is summed over the ``data``
group, never the world (a world sum would add other ranks' slices
together), and a whole leaf's over the world and divided by T (the
group's copies stay one); the logged values are counted once a group
(``1/T``, as ``1/S`` for ``seq``); the clip sums the squares of the split
leaves over the ``model`` group and counts the whole ones once; the
loss-scale finiteness flag is agreed over the group. ZeRO-1 slices each rank's ``model`` slice over ``data`` (the
JAX plan, ``model`` first), and ``--zero1_overlap bucketed`` is inert on a
``model`` mesh, logged as the JAX trainer logs it. The parameters are
broadcast over the ``data`` row from its first rank (its ranks hold the
same slices). The single-file checkpoint gathers the group's slices into
whole leaves (every process takes part, rank 0 writes); in the sharded
directory each ``data`` index 0 rank writes its slices as pieces bounded
in the whole leaf (``shards`` T, or D*T for a ZeRO-1 moment). Eval gathers
the predictions over the ``data`` group.

Pipeline stages of tensor-parallel layers (``--mesh pipe:K,model:T``,
``data:D,pipe:K,model:T``; the JAX trainer's ``pipe x model``): each
stage runs its layers over its own ``model`` group inside the schedule
(``_pipe_train_step``); the batch reaches every rank of a data row's
stages and slices (``_seq_consistent``: the ``pipe`` group's broadcast,
then the ``model`` group's); a split leaf's gradient is summed over
``data``, a whole leaf's over the stage's ``data`` x ``model`` ranks
(``mesh.stage_group``) and divided by T; the logged values are the last
stage's model rank 0's; the clip sums the split leaves' squares over
``model``, then the stages' totals over ``pipe``; a checkpoint cuts each
rank's ``model`` pieces along the stage layout's pipe dimension
(``_pipe_groups``). The start-up line names the ``model`` axis beside the
stage, as the pre-flight report's ``mesh_axes`` does.

Left out (their flags are refused by ``config.parser.check_train_flags``,
or accepted and ignored where they change no result): a ``model`` axis
beside ``seq``.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from collections import defaultdict, deque
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.bucketing import (
    BucketedBatch,
    BucketedDataLoader,
    parse_length_buckets,
    synthetic_qa_batch,
)
from ..data.device_prefetch import BatchPlacer, DevicePrefetcher, resolve_depth
from ..data.loader import DataLoader, ShardedBatchSampler
from ..data.packing import (
    DEFAULT_MAX_SEGMENTS,
    DEFAULT_MIN_FRAGMENT,
    PackedBatch,
    PackedDataLoader,
    parse_pack_splitting,
    parse_sequence_packing,
)
from ..losses import PackedWeightedLoss
from ..metrics import trace as trace_mod
from ..metrics.meters import AverageMeter
from ..metrics.trace import ProfilerWindow, time_profiler
from ..models.convert import merge_jax_params
from ..ops import cuda_build
from ..parallel import collectives
from ..parallel import dist as pdist
from ..parallel import pipeline
from ..parallel.mesh import build_mesh
from ..parallel.plan import ParallelPlan
from ..parallel.sharding import (
    MIN_SIZE,
    Zero1,
    opt_state_bytes_per_chip,
    tree_order,
    zero1_bucket_plan,
)
from ..resilience.checkpoint_async import AsyncCheckpointer
from ..resilience.faults import fire as _fault
from ..utils import hbm
from . import checkpoint as ckpt
from . import loss_scale as ls_lib
from .callback import TestCallback
from .optim import build_optimizer, clip_by_global_norm_, clip_sliced_
from .writer import init_writer

logger = logging.getLogger(__name__)


def checkpoint_extra(mesh_axes=None, zero1: bool = False,
                     pipe_schedule: Optional[str] = None,
                     pipe_param_layout: Optional[str] = None) -> dict:
    """Every checkpoint's topology record (the JAX trainer's
    ``_checkpoint_extra``): the optimizer layout that is live (``zero1``
    only when it shards), the mesh's axes (default ``data:1``), and under a
    ``pipe`` axis > 1 the schedule and the parameter layout (None
    otherwise)."""
    return {"opt_sharding": "zero1" if zero1 else "off",
            "mesh_axes": dict(mesh_axes or {"data": 1}),
            "pipe_schedule": pipe_schedule,
            "pipe_param_layout": pipe_param_layout}


def _console_str(meters: dict) -> str:
    return ", ".join(
        f"{k}: {v() if isinstance(v, AverageMeter) else v:.3e}"
        for k, v in meters.items())


def step_generators(seed: int, step: int, n: int,
                    device: torch.device) -> List[torch.Generator]:
    """The ``n`` micro-batch generators of optimizer step ``step``: one CPU
    generator seeded from ``(seed, step)``, and from it one seed per
    micro-batch for a generator on ``device``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    step_gen = torch.Generator().manual_seed(int(state) & ((1 << 63) - 1))
    seeds = torch.randint(0, 1 << 62, (n,), generator=step_gen).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def next_batch_split(train_batch_size: int, batch_split: int,
                     process_count: int, data_size: int) -> Optional[int]:
    """Smallest batch_split above ``batch_split`` (doubling) that divides
    the global batch AND each process's local batch (``train_batch_size //
    process_count``), and keeps the micro-batch divisible over the data
    axis: the JAX trainer's ``_next_batch_split``. ``None`` when no such
    split exists."""
    data_size = max(int(data_size), 1)
    local_batch = train_batch_size // max(int(process_count), 1)
    split = batch_split * 2
    while split <= local_batch:
        if (train_batch_size % split == 0 and local_batch % split == 0
                and (train_batch_size // split) % data_size == 0):
            return split
        split *= 2
    return None


def _normalize_batch(batch):
    """Loader item -> ``(inputs, labels, meta)``; ``meta`` is the
    BucketedBatch or PackedBatch on the bucketed or packed path, None on
    the pad-to-max path."""
    if isinstance(batch, (BucketedBatch, PackedBatch)):
        return batch.inputs, batch.labels, batch
    inputs, labels = batch[:2]
    return inputs, labels, None


class Trainer:
    def __init__(
        self,
        model,
        loss,
        collate_fun,
        *,
        trainer_params=None,
        train_dataset=None,
        test_dataset=None,
        writer_dir=None,
        n_epochs: int = 0,
        train_batch_size: int = 32,
        test_batch_size: int = 32,
        batch_split: int = 1,
        n_jobs: int = 4,
        warmup_coef: float = 0.01,
        max_grad_norm: Optional[float] = 1.0,
        train_weights: Optional[dict] = None,
        drop_optimizer: bool = False,
        debug: bool = False,
        seed: int = 0,
        length_buckets=None,
        device_prefetch=0,
        log_every: int = 10,
        on_train_metrics: Optional[Callable] = None,
        sharded_checkpoint: bool = False,
        async_checkpoint: bool = False,
        sequence_packing=False,
        pack_max_segments: int = DEFAULT_MAX_SEGMENTS,
        pack_splitting="off",
        pack_min_fragment: int = DEFAULT_MIN_FRAGMENT,
        mesh=None,
        optimizer_sharding: str = "off",
        zero_min_size: int = MIN_SIZE,
        zero1_overlap: str = "off",
        zero1_bucket_mb: float = 4.0,
        watchdog=None,
        telemetry=None,
        trace_dir=None,
        hbm_preflight: bool = True,
        pipe_schedule: str = "gpipe",
        pipe_param_sharding=None,
    ):
        self.model = model
        self.device = model.device
        self.loss = loss
        self.collate_fun = collate_fun
        self.n_epochs = 2 if debug else n_epochs
        self.batch_split = batch_split
        self.max_grad_norm = max_grad_norm
        self.drop_optimizer = drop_optimizer
        self.debug = debug
        self.seed = seed
        self.sharded_checkpoint = sharded_checkpoint
        self._async_ckpt = AsyncCheckpointer() if async_checkpoint else None
        self._async_fallback_logged = False
        # the last save's seconds: "save" (a synchronous one), or
        # "snapshot" (blocking) and "persist" (on the background thread)
        self.checkpoint_seconds: Dict[str, float] = {}
        self.device_prefetch = resolve_depth(device_prefetch)
        self.log_every = max(1, int(log_every))
        self.on_train_metrics = on_train_metrics
        # one record per optimizer step: its values, lr, rows and host
        # seconds (the step ends in a host read of its loss)
        self.history: List[dict] = []
        self.eval_batches = 0   # eval batches run, over every test() call
        self.watchdog = watchdog
        self.telemetry = telemetry
        self.trace_dir = trace_dir
        self.profiler_window: Optional[ProfilerWindow] = None
        self.train_batch_size = int(train_batch_size)
        self.hbm_preflight = bool(hbm_preflight)
        self._preflight_done = not self.hbm_preflight
        self.preflight_report: Optional[dict] = None
        self.preflight_probes = 0
        # library loads the telemetry has observed (the probe's and the
        # steps' loads land on the next observed step)
        self._loads_observed = len(cuda_build.load_events())

        self.process_index = pdist.process_index()
        self.process_count = pdist.process_count()
        self.is_primary = self.process_index == 0
        self.mesh = mesh if mesh is not None else build_mesh()
        self.plan = ParallelPlan.from_mesh(self.mesh)
        # rows follow the data coordinate: a seq (model) group shares its
        # rows
        world = self.plan.data_size
        self.seq_size = self.plan.seq_size
        self.model_size = self.plan.model_size
        # this rank's slices under a model axis (None without one)
        self.tp = (model.model_split() if hasattr(model, "model_split")
                   else None)
        if optimizer_sharding not in ("off", "zero1"):
            raise ValueError(f"optimizer_sharding must be 'off' or 'zero1'; "
                             f"got {optimizer_sharding!r}")
        self.opt_sharding_mode = optimizer_sharding
        self.zero_min_size = int(zero_min_size)
        # validated here: a typo must fail, not silently train monolithic
        mode = str(zero1_overlap or "off").strip().lower()
        if mode not in ("off", "bucketed"):
            raise ValueError(f"zero1_overlap must be 'off' or 'bucketed', "
                             f"got {zero1_overlap!r}")
        self.zero1_overlap = mode
        self.zero1_bucket_mb = float(zero1_bucket_mb)
        self.zero1_bucket_count = 0   # set when the exchange is built
        self._exchange: Optional[collectives.BucketedExchange] = None
        self.in_step = False
        self.interrupt_pending = False
        self._init_pipeline(model, pipe_schedule, pipe_param_sharding)
        if train_dataset is not None and (
                train_batch_size % world
                or (train_batch_size // world) % batch_split):
            raise ValueError(
                f"train_batch_size {train_batch_size} must split over {world} "
                f"data-parallel ranks into batch_split={batch_split} equal "
                f"micro-batches each")
        if test_dataset is not None and test_batch_size % world:
            raise ValueError(f"test_batch_size {test_batch_size} must divide "
                             f"over {world} data-parallel ranks")
        shard = dict(process_index=self.mesh.data_index, process_count=world)

        max_len = getattr(collate_fun, "keywords", {}).get("max_seq_len")
        self._packing = self._resolve_packing(
            sequence_packing, pack_splitting, length_buckets)
        self._seq_grid = (parse_length_buckets(length_buckets, max_len)
                          if length_buckets and not self._packing else None)
        if self._packing:
            # per-segment labels: every head's mean over real segments
            self.loss = PackedWeightedLoss(loss)
        pack_kw = dict(max_seq_len=max_len, max_segments=pack_max_segments,
                       splitting=pack_splitting,
                       min_fragment=pack_min_fragment, n_jobs=n_jobs)
        tokenizer = getattr(collate_fun, "keywords", {}).get("tokenizer")

        self.train_dataloader = None
        if train_dataset is not None:
            sampler_weights = (train_weights or {}).get("sampler_weights")
            if sampler_weights is not None:
                if len(sampler_weights) != len(train_dataset):
                    raise ValueError("sampler weights must cover the dataset")
                logger.info("Used train sampler: weighted-with-replacement.")
            else:
                logger.info("Used train sampler: shuffled.")
            sampler = ShardedBatchSampler(
                len(train_dataset), train_batch_size, shuffle=True,
                weights=sampler_weights, drop_last=True, seed=seed, **shard)
            if self._packing:
                self.train_dataloader = PackedDataLoader(
                    train_dataset, sampler, tokenizer,
                    rows_per_batch=train_batch_size, **pack_kw)
                logger.info("Sequence packing: %d rows x %d tokens per step, "
                            "max %d segments per row, splitting %s.",
                            train_batch_size, max_len, pack_max_segments,
                            self.train_dataloader.splitting)
            elif self._seq_grid is not None:
                self.train_dataloader = BucketedDataLoader(
                    train_dataset, sampler, collate_fun,
                    seq_grid=self._seq_grid,
                    token_budget=train_batch_size * self._seq_grid[-1],
                    batch_multiple=batch_split * world, n_jobs=n_jobs)
                logger.info("Length-bucketed batching: grid %s, token budget "
                            "%d, per-bucket batches %s.", self._seq_grid,
                            self.train_dataloader.token_budget,
                            self.train_dataloader.batch_sizes)
            else:
                self.train_dataloader = DataLoader(
                    train_dataset, sampler, collate_fun, n_jobs=n_jobs)
            logger.info(f"Train dataset len: {len(train_dataset)}. "
                        f"#JOBS: {n_jobs}.")

        self.test_dataloader = None
        if test_dataset is not None:
            self._test_sampler = ShardedBatchSampler(
                len(test_dataset), test_batch_size, shuffle=False,
                drop_last=False, pad_last=True, seed=seed, **shard)
            if self._packing:
                self.test_dataloader = PackedDataLoader(
                    test_dataset, self._test_sampler, tokenizer,
                    rows_per_batch=test_batch_size, pad_last=True, **pack_kw)
            elif self._seq_grid is not None:
                self.test_dataloader = BucketedDataLoader(
                    test_dataset, self._test_sampler, collate_fun,
                    seq_grid=self._seq_grid,
                    token_budget=test_batch_size * self._seq_grid[-1],
                    batch_multiple=world, n_jobs=n_jobs, pad_last=True)
            else:
                self.test_dataloader = DataLoader(
                    test_dataset, self._test_sampler, collate_fun,
                    n_jobs=n_jobs)
            logger.info(f"Test dataset len: {len(test_dataset)}. "
                        f"#JOBS: {n_jobs}.")

        self.optimizer = None
        self.loss_scale: Optional[ls_lib.LossScaleState] = None
        self.planned_steps_per_epoch = None
        self.plan_seconds = 0.0
        if self.train_dataloader is not None and trainer_params is not None:
            # the LR schedule is sized from the loader's PLANNED step count
            # (bucket batches carry more rows than the global batch)
            t0 = time.perf_counter()
            self.planned_steps_per_epoch = self._plan_schedule_steps()
            self.plan_seconds = time.perf_counter() - t0
            steps_per_epoch = (self.planned_steps_per_epoch
                               if self.planned_steps_per_epoch is not None
                               else len(self.train_dataloader))
            num_training_steps = max(self.n_epochs * steps_per_epoch, 1)
            if warmup_coef > 0:
                logger.info(f"Warmup schedule is used. #Training steps: "
                            f"{num_training_steps}. #Warmup steps: "
                            f"{int(num_training_steps * warmup_coef)}.")
            self.optimizer = build_optimizer(
                trainer_params, self._own_parameters(),
                num_training_steps=num_training_steps, warmup_coef=warmup_coef,
                zero=self._zero_layout(model), tp=self.tp)
            self.optimizer.stage_local = self.pipe is not None
            if self.optimizer.zero is not None:
                logger.info("ZeRO-1: optimizer state sharded over the %d-way "
                            "data axis (%.1f MB on this rank).", world,
                            opt_state_bytes_per_chip(self.optimizer) / 1e6)
            flag = getattr(trainer_params, "apex_loss_scale", None)
            if flag not in (None, "None"):
                self.loss_scale = ls_lib.init_state(flag)
                logger.info("Loss scaling enabled: %s.", "dynamic"
                            if self.loss_scale.dynamic else self.loss_scale.scale)

        buckets = self._build_exchange(model)
        if self.telemetry is not None:
            self.telemetry.observe_zero1_buckets(buckets)

        self.global_step = 0
        self.writer = init_writer(self.is_primary, writer_dir)
        if self.process_count > 1:
            if self.pipe is None:
                # the replicas start equal (the reference's DDP wrapper)
                self._broadcast_parameters()
            logger.info("Data parallel: process %d of %d, %d rows of every "
                        "global batch of %d, in %d micro-batches.",
                        self.process_index, self.process_count,
                        train_batch_size // world, train_batch_size,
                        batch_split)
            if self.seq_size > 1:
                logger.info("Mesh %s: process %d at data %d, seq %d of a "
                            "ring of %d over each row's tokens.",
                            self.plan.describe(), self.process_index,
                            self.mesh.data_index, self.mesh.seq_index,
                            self.seq_size)
            if self.tp is not None:
                cfg = model.cfg
                logger.info("Tensor parallelism: process %d at data %d, "
                            "model %d of %d: %d of %d heads and %d of %d MLP "
                            "columns a layer, %d split parameters.",
                            self.process_index, self.mesh.data_index,
                            self.mesh.model_index, self.model_size,
                            cfg.num_heads // self.model_size, cfg.num_heads,
                            cfg.intermediate_size // self.model_size,
                            cfg.intermediate_size, len(self.tp.dims))

    def _broadcast_parameters(self) -> None:
        """Every parameter from the first rank of this rank's ``data`` row
        (rank 0 without a ``model`` axis): the ranks of a row hold the same
        slices (under a ``pipe`` axis too: a row is one stage's)."""
        if self.tp is None:
            collectives.broadcast_parameters(self.model.named_parameters())
        elif self.plan.data_size > 1:
            collectives.broadcast_parameters(
                self.model.named_parameters(), src=self.mesh.data_ranks[0],
                group=self.mesh.data_group)

    def _init_pipeline(self, model, schedule, param_sharding) -> None:
        """The ``pipe`` axis (``parallel/pipeline.py``): the schedule, this
        rank's stage and its storage, the JAX trainer's start-up line with
        the modeled bubble (and, under a ``model`` axis, the stage's
        tensor-parallel split). Under ``stage`` the parameters of the other
        stages are released, after one broadcast from rank 0 (under a
        ``model`` axis, from each ``data`` row's first rank: the rows hold
        other slices) has made every replica equal."""
        self.pipe_stages = self.plan.pipe_size
        self.pipe_schedule = str(schedule or "gpipe").strip().lower()
        if self.pipe_schedule not in pipeline.PIPE_SCHEDULES:
            raise ValueError(f"--pipe_schedule must be 'gpipe' or '1f1b', "
                             f"got {schedule!r}")
        layout = pipeline.resolve_param_layout(param_sharding,
                                               self.pipe_stages)
        self.pipe: Optional[pipeline.StageLayout] = None
        self.pipe_runner: Optional[pipeline.PipelineStep] = None
        if self.pipe_stages <= 1:
            return
        pipeline.validate_pipeline_plan(self.plan, model,
                                        batch_split=self.batch_split,
                                        schedule=self.pipe_schedule)
        self.pipe = pipeline.StageLayout(model, stages=self.pipe_stages,
                                         index=self.mesh.pipe_index,
                                         layout=layout, split=self.tp)
        self.pipe_runner = pipeline.PipelineStep(
            self.pipe, self.mesh.stage, schedule=self.pipe_schedule,
            dtype=model.transformer.embeddings.word_embeddings.compute_dtype,
            device=self.device)
        if self.process_count > 1:
            if self.tp is None:
                collectives.broadcast_parameters(model.named_parameters())
            else:
                self._broadcast_parameters()
        self.pipe.release(model)
        cfg = model.cfg
        logger.info(
            "Pipeline parallelism: %d stages x %d layers over the pipe axis, "
            "%s schedule over %d micro-batch(es) (modeled bubble %.1f%%, "
            "stage-local params %s); this rank is stage %d (layers %d..%d)"
            "%s.",
            self.pipe_stages, self.pipe.hi - self.pipe.lo, self.pipe_schedule,
            self.batch_split, 100.0 * pipeline.modeled_bubble_fraction(
                self.pipe_stages, self.batch_split, self.pipe_schedule),
            "on" if layout == "stage" else "off", self.pipe.index,
            self.pipe.lo, self.pipe.hi - 1,
            "" if self.tp is None else
            f", model {self.mesh.model_index} of {self.model_size} within "
            f"it ({cfg.num_heads // self.model_size} of {cfg.num_heads} "
            f"heads, {cfg.intermediate_size // self.model_size} of "
            f"{cfg.intermediate_size} MLP columns a layer)")

    @property
    def pipe_param_layout(self) -> Optional[str]:
        """``'stage'`` or ``'replicated'`` under a pipe axis > 1, else
        None."""
        return None if self.pipe is None else self.pipe.layout

    def _own_parameters(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters this rank trains: all of them, or under a pipe
        axis its stage's."""
        named = dict(self.model.named_parameters())
        if self.pipe is None:
            return named
        return {n: named[n] for n in self.pipe.owned}

    def _stored_parameters(self) -> List[torch.Tensor]:
        """The parameters this rank stores (``meta`` ones hold nothing)."""
        return [p for p in self.model.parameters() if p.device.type != "meta"]

    def _pipe_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's ``pipe`` group, in place."""
        return collectives.all_reduce_sum_(t, self.mesh.pipe_group)

    def _model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's ``model`` group, in place."""
        return collectives.all_reduce_sum_(t, self.mesh.model_group)

    def _reduce_model_gradients(self, params: dict) -> None:
        """The gradients of one tensor-parallel step summed over the data:
        a rank's slices over its ``data`` row, never the world (other
        ranks' slices are other tensors); the leaves the ``model`` group
        holds whole over the ranks of its pipeline stage (``data`` x
        ``model``: the world without a ``pipe`` axis; another stage holds
        other leaves) and divided by the group's size. The group's copies
        of such a leaf got the same gradient, so that is their sum over
        ``data`` (exactly, at a size that is a power of two) and keeps the
        copies one where an atomic kernel (the embeddings' backward on the
        card) rounded them apart."""
        split = [(n, p) for n, p in params.items() if self.tp.sharded(n)]
        whole = [(n, p) for n, p in params.items() if not self.tp.sharded(n)]
        if self.plan.data_size > 1:
            collectives.all_reduce_gradients(split,
                                             group=self.mesh.data_group)
        collectives.all_reduce_gradients(whole, group=self.mesh.stage_group)
        grads = [p.grad for _, p in whole if p.grad is not None]
        if grads:
            torch._foreach_mul_(grads, 1.0 / self.model_size)

    def zero_enabled(self) -> bool:
        """``zero1`` requested and a data axis > 1 to shard over (at data
        size 1 it is inert, as in the JAX trainer)."""
        return self.opt_sharding_mode == "zero1" and self.plan.data_size > 1

    @property
    def effective_opt_sharding(self) -> str:
        return "zero1" if self.zero_enabled() else "off"

    def _zero_layout(self, model) -> Optional[Zero1]:
        if not self.zero_enabled():
            return None
        plan = self.plan.zero1(
            ((n, p.shape if self.tp is None
              else self.tp.whole_shape(n, p.shape))
             for n, p in self._own_parameters().items()),
            min_size=self.zero_min_size,
            stage_pipe=self.pipe_param_layout == "stage")
        return Zero1(plan, index=self.mesh.data_index,
                     size=self.plan.data_size, group=self.mesh.data_group,
                     owner=self.mesh.seq_index == 0, tp=self.tp)

    def _build_exchange(self, model) -> list:
        """The bucketed ZeRO-1 exchange of ``zero1_overlap='bucketed'``
        where it applies (the JAX trainer's three inert cases, logged as it
        logs them); returns its bucket plan (empty when inert or off)."""
        if self.zero1_overlap != "bucketed":
            return []
        if self.optimizer is None or self.optimizer.zero is None:
            logger.info("zero1_overlap=bucketed without an active zero1 "
                        "layout (--optimizer_sharding off or a data axis "
                        "of 1): nothing to bucket; the monolithic step runs "
                        "unchanged.")
            return []
        if self.seq_size > 1:
            logger.info("zero1_overlap=bucketed on a seq mesh: each rank's "
                        "gradient sums over the whole world, seq included, "
                        "in one exchange; bucketing is inert.")
            return []
        if self.pipe is not None:
            logger.info("zero1_overlap=bucketed under pipeline parallelism: "
                        "the pipelined backward yields each stage's whole "
                        "gradient at the schedule's end, with nothing left "
                        "to overlap; bucketing is inert (0 buckets), as in "
                        "the JAX trainer.")
            return []
        if self.tp is not None:
            logger.info("zero1_overlap=bucketed on a tensor-parallel mesh: "
                        "gradients already accumulate per-tensor (maximal "
                        "per-leaf independence); bucketing is inert (0 "
                        "buckets), as in the JAX trainer; the one-piece "
                        "exchange over the data group runs.")
            return []
        named = dict(model.named_parameters())
        names = tree_order(named)
        buckets = zero1_bucket_plan(((n, named[n].shape) for n in names),
                                    bucket_mb=self.zero1_bucket_mb)
        zero = self.optimizer.zero
        self._exchange = collectives.BucketedExchange(
            [(n, named[n], zero.plan[n]) for n in names], buckets,
            index=zero.index, size=zero.size, group=zero.group)
        self.zero1_bucket_count = len(buckets)
        logger.info("ZeRO-1 overlap: %d gradient bucket(s) at ~%.1f MB "
                    "target (per-bucket reduce-scatter, issued as the last "
                    "micro-batch's backward fills each).", len(buckets),
                    self.zero1_bucket_mb)
        return buckets

    def _resolve_packing(self, sequence_packing, pack_splitting,
                         length_buckets) -> bool:
        """``sequence_packing`` normalised (the splitting spec checked even
        when packing is off); packing needs the collate's tokenizer (without
        one: pad-to-max, with a warning, as in the JAX trainer) and static
        ``max_seq_len``, and supersedes ``length_buckets``."""
        parse_pack_splitting(pack_splitting)
        if not parse_sequence_packing(sequence_packing):
            return False
        kw = getattr(self.collate_fun, "keywords", {})
        if kw.get("tokenizer") is None:
            logger.warning("sequence_packing needs a tokenizer-bound "
                           "collate_fun (make_collate_fun); falling back to "
                           "pad-to-max batching.")
            return False
        if kw.get("max_seq_len") is None:
            raise ValueError("sequence_packing needs the collate's static "
                             "max_seq_len (make_collate_fun(..., "
                             "max_seq_len=...))")
        if self.process_count > 1:
            logger.info("sequence_packing: multi-process run, the per-epoch "
                        "pack plan derives from the shared length oracle, "
                        "each process collates its row slice.")
        if parse_length_buckets(length_buckets, kw["max_seq_len"]):
            logger.info("sequence_packing supersedes length_buckets: packed "
                        "rows are already nearly pad-free, and one shape "
                        "serves every step.")
        return True

    def _plan_schedule_steps(self) -> Optional[int]:
        loader = self.train_dataloader
        if not isinstance(loader, (BucketedDataLoader, PackedDataLoader)):
            return None
        planned = max(int(loader.planned_epoch_steps(1)), 1)
        upper = len(loader)
        if planned != upper:
            logger.info("LR schedule sized from the planned epoch step count: "
                        "%d steps/epoch (the pad-to-max upper bound would have "
                        "been %d).", planned, upper)
        return planned

    def _update_writer(self, meters: dict, *, prefix: str,
                       step: Optional[int] = None) -> None:
        if self.writer is None:
            return
        for k, v in meters.items():
            self.writer.add_scalar(
                f"{prefix}/{k}", v() if isinstance(v, AverageMeter) else v,
                global_step=self.global_step if step is None else step)

    def _watched(self, label: str, *, scale: float = 1.0):
        """Watchdog frame around a unit of host-side work, yielding a
        per-step ``tick``; ``scale`` multiplies the timeout for units that
        are legitimately slower than a step. No-op without a watchdog."""
        if self.watchdog is None:
            return nullcontext(lambda *_: None)
        timeout = self.watchdog.timeout * scale if scale != 1.0 else None
        return self.watchdog.watch(label, timeout)

    def _sync(self) -> None:
        """Wait for the device's queued work (CUDA only): the instrumented
        step reads its clock after it, so ``device`` is execution."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _placer(self, host_stats: Optional[deque] = None):
        """The placement of one loader batch. With ``host_stats`` (the
        instrumented train loop) each call appends ``(seconds, real tokens,
        total tokens)`` and emits a ``place`` span from the thread it ran
        on (the prefetch thread's track when prefetching)."""
        placer = BatchPlacer(self.device)

        def place(batch):
            t0 = time.perf_counter() if host_stats is not None else 0.0
            inputs, labels, meta = _normalize_batch(batch)
            placed = placer({"inputs": inputs, "labels": labels}, meta)
            if host_stats is not None:
                mask = inputs.get("attention_mask")
                real = int(np.asarray(mask).sum()) if mask is not None else 0
                total = int(np.asarray(mask).size) if mask is not None else 0
                t1 = time.perf_counter()
                host_stats.append((t1 - t0, real, total))
                trace_mod.complete("place", t0, t1, cat="train")
            return placed

        return place

    def _batches(self, loader, name: str, host_stats: Optional[deque] = None):
        """Placed batches of ``loader``: staged ``device_prefetch`` ahead on
        a background thread, or placed inline at depth 0. Returns
        ``(iterator, prefetcher or None)``."""
        place = self._placer(host_stats)
        if self.device_prefetch > 0:
            prefetcher = DevicePrefetcher(iter(loader), place,
                                          depth=self.device_prefetch, name=name)
            return iter(prefetcher), prefetcher
        return (place(b) for b in loader), None

    def _seq_consistent(self, tensors: dict) -> dict:
        """With a ``seq`` (``pipe``, ``model``) axis, the first rank's batch
        on every rank of its ``seq`` (``pipe``, ``model``) group
        (broadcast): the group computes blocks (stages, slices) of one set
        of rows, whatever a rank's own dataset drew (a chunk sampler
        without a seed draws per process). Under ``pipe`` and ``model``
        the pipeline's first, then each stage's ``model`` group's: every
        rank of a data row's stages and slices holds stage 0's model rank
        0's rows. Raises when the ranks' shapes differ."""
        mesh, groups = self.mesh, []
        if self.pipe is not None:
            groups.append((mesh.pipe_ranks, mesh.pipe_group))
        elif self.seq_size > 1:
            groups.append((mesh.seq_ranks, mesh.seq_group))
        if self.model_size > 1:
            groups.append((mesh.model_ranks, mesh.model_group))
        if not groups:
            return tensors
        flat = [(part, key) for part in ("inputs", "labels")
                for key in sorted(tensors[part])]
        for ranks, group in groups:
            shapes = torch.tensor([d for part, key in flat
                                   for d in (len(tensors[part][key].shape),
                                             *tensors[part][key].shape)])
            mine = shapes.clone()
            collectives.broadcast_(shapes, ranks[0], group)
            if not torch.equal(shapes, mine):
                raise RuntimeError(
                    f"the ranks of group {ranks} drew batches of different "
                    f"shapes; they must hold one set of rows")
            for part, key in flat:
                collectives.broadcast_(tensors[part][key], ranks[0], group)
        return tensors

    def _model_inputs(self, inputs: Dict[str, torch.Tensor]) -> dict:
        out = dict(input_ids=inputs["input_ids"].long(),
                   attention_mask=inputs["attention_mask"],
                   token_type_ids=inputs["token_type_ids"].long())
        # a packed batch's planes (data/packing.collate_packed)
        for key in ("position_ids", "segment_ids", "segment_starts"):
            if key in inputs:
                out[key] = inputs[key]
        return out

    # -- the memory pre-flight -------------------------------------------------

    def _next_batch_split(self) -> Optional[int]:
        """The next legal ``batch_split`` (:func:`next_batch_split`): each
        data rank holds ``1/D`` of the rows, and its micro-batches must
        divide them."""
        data = self.plan.data_size
        return next_batch_split(self.train_batch_size, self.batch_split,
                                process_count=data, data_size=data)

    def _pipe_fields(self) -> dict:
        """The pipeline's fields of the pre-flight reports (the JAX
        trainer's ``_preflight_pipe_fields``): the schedule, the layout,
        each stage's layers and each stage's bytes in the ownership view
        (the whole leaves, as the JAX trainer counts them under a ``model``
        axis too; the report's ``mesh_axes`` names that axis), None without
        a pipe axis > 1."""
        if self.pipe is None:
            return {"pipe_schedule": None, "pipe_param_layout": None,
                    "pipe_stage_layers": None, "pipe_stage_param_bytes": None}
        return {
            "pipe_schedule": self.pipe_schedule,
            "pipe_param_layout": self.pipe.layout,
            "pipe_stage_layers": self.plan.stage_map(self.pipe.num_layers),
            "pipe_stage_param_bytes": pipeline.stage_param_bytes(
                pipeline.shape_tree(self.pipe.whole),
                pipe_size=self.pipe_stages,
                model_size=self.model_size)["per_stage_bytes"],
        }

    def _preflight_fields(self, limit: int) -> dict:
        """The fields both pre-flight reports share (the JAX trainer's):
        the parameter bytes this rank stores, and the pipeline's."""
        return {
            "limit_bytes": int(limit),
            "batch_split_before": self.batch_split,
            "batch_split": self.batch_split,
            "applied": False,
            "mesh_axes": self.plan.describe(),
            "mesh_unused_devices": 0,
            "opt_sharding": self.effective_opt_sharding,
            "opt_state_bytes_per_chip": (
                opt_state_bytes_per_chip(self.optimizer)
                if self.optimizer is not None else None),
            "param_bytes": hbm.tensor_bytes(self._stored_parameters()),
            **self._pipe_fields(),
        }

    def _probe_step(self, inputs: Dict[str, torch.Tensor],
                    labels: Dict[str, torch.Tensor]) -> hbm.MemoryAnalysis:
        """One forward and backward of the first micro-batch of ``inputs``
        at the current ``batch_split``, measured (``utils/hbm.measure``):
        the arguments are the parameters, the optimizer state and the
        batch; the output the gradients the backward leaves. No optimizer
        update; the gradients are dropped, and the generators it draws
        from (the step's own, derived from ``(seed, step)``, and the global
        ones) are restored, so the run goes on as if it had not run."""
        rows = int(inputs["input_ids"].shape[0])
        micro = rows // self.batch_split
        world = self.plan.data_size
        model, params = self.model, self._stored_parameters()
        cpu_rng = torch.random.get_rng_state()
        cuda_rng = (torch.cuda.get_rng_state(self.device)
                    if self.device.type == "cuda" else None)
        was_training = model.training
        arguments = (hbm.tensor_bytes(params)
                     + (opt_state_bytes_per_chip(self.optimizer)
                        if self.optimizer is not None else 0)
                     + hbm.tensor_bytes(list(inputs.values())
                                        + list(labels.values())))

        def fwd_bwd():
            if self.pipe is not None:
                self._pipe_micro_batches(
                    {k: v[:micro] for k, v in inputs.items()},
                    {k: v[:micro] for k, v in labels.items()}, 1)
                return
            gen = step_generators(self.seed, self.global_step, 1,
                                  self.device)[0]
            preds = model(**self._model_inputs(
                {k: v[:micro] for k, v in inputs.items()}), generator=gen,
                global_rows=((self.mesh.data_index * micro, world * micro)
                             if world > 1 else None))
            total, _ = self.loss(preds, {k: v[:micro]
                                         for k, v in labels.items()})
            total.backward()

        for p in params:
            p.grad = None
        model.train()
        try:
            _, analysis = hbm.measure(fwd_bwd, self.device,
                                      argument_bytes=arguments)
        finally:
            for p in params:
                p.grad = None
            model.train(was_training)
            torch.random.set_rng_state(cpu_rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self.device)
        self.preflight_probes += 1
        return analysis

    def _agree(self, need: Optional[int],
               out_of_memory: bool) -> Tuple[Optional[int], bool]:
        """One decision for every process: the largest need of the world
        and whether any process ran out of memory, or None (stand down)
        when any process has no need."""
        if self.process_count < 2:
            return need, out_of_memory
        t = torch.tensor([need if need is not None else 0,
                          int(need is None), int(out_of_memory)],
                         dtype=torch.int64, device=self.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return (None if int(t[1]) else int(t[0])), bool(t[2])

    def _measured_need(self, analysis_fn, limit: int) -> Tuple[
            Optional[int], bool]:
        """``(need, over)``: ``preflight_bytes`` of ``analysis_fn()``'s
        analysis agreed over the world (None when it is unavailable), and
        whether it exceeds ``limit`` on any process (a probe that ran out
        of memory does, whatever its lower bound)."""
        try:
            analysis = analysis_fn()
        except Exception as e:  # noqa: BLE001 - analysis is best-effort
            logger.info("Memory pre-flight: analysis unavailable (%s); "
                        "skipping.", e)
            analysis = None
        need, out_of_memory = self._agree(
            hbm.preflight_bytes(analysis),
            bool(getattr(analysis, "out_of_memory", False)))
        return need, need is not None and (need > limit or out_of_memory)

    def _placed(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in host.items()}

    def preflight_train_step(self, host_inputs, host_labels, *,
                             compile_fn=None, limit_bytes=None):
        """The memory pre-flight at the current ``batch_split``: measure
        the step (:meth:`_probe_step`), and while its need exceeds the
        card's memory raise ``batch_split`` and measure again, so an
        over-committed configuration degrades to a running plan with a
        logged decision instead of running out of memory.

        ``host_inputs`` / ``host_labels``: this process's UNSPLIT batch
        (arrays or placed tensors). ``compile_fn(trainer)`` / ``limit_bytes``
        are the JAX signature's injection points (an object whose
        ``memory_analysis()`` stands in for the measurement, and the
        limit). Returns the decision report (also ``preflight_report``), or
        None when disabled or without a limit (the CPU)."""
        self._preflight_done = True
        if not self.hbm_preflight:
            return None
        limit = (limit_bytes if limit_bytes is not None
                 else hbm.device_hbm_bytes(self.device))
        if limit is None:
            logger.info("Memory pre-flight: device reports no memory limit; "
                        "skipping.")
            return None
        report = {**self._preflight_fields(limit), "bytes_before": None,
                  "bytes": None}
        if compile_fn is None:
            inputs, labels = self._placed(host_inputs), self._placed(host_labels)
        while True:
            need, over = self._measured_need(
                (lambda: compile_fn(self).memory_analysis())
                if compile_fn is not None
                else (lambda: self._probe_step(inputs, labels)), limit)
            if need is None:
                logger.info("Memory pre-flight: memory analysis unavailable; "
                            "skipping.")
                break
            report["bytes"] = int(need)
            if report["bytes_before"] is None:
                report["bytes_before"] = int(need)
            if not over:
                if report["applied"]:
                    logger.warning(
                        "Memory pre-flight: raised batch_split %d -> %d "
                        "(measured %.2f GB -> %.2f GB vs %.2f GB device "
                        "memory); proceeding with the raised split.",
                        report["batch_split_before"], self.batch_split,
                        report["bytes_before"] / 1e9, need / 1e9, limit / 1e9)
                break
            new_split = self._next_batch_split()
            if new_split is None:
                logger.warning(
                    "Memory pre-flight: step needs %.2f GB vs %.2f GB device "
                    "memory and batch_split %d cannot be raised further "
                    "(train_batch_size %d); proceeding.", need / 1e9,
                    limit / 1e9, self.batch_split, self.train_batch_size)
                break
            logger.warning(
                "Memory pre-flight: step at batch_split %d needs %.2f GB vs "
                "%.2f GB device memory; raising batch_split to %d.",
                self.batch_split, need / 1e9, limit / 1e9, new_split)
            self.batch_split = new_split
            report["batch_split"] = new_split
            report["applied"] = True
        self.preflight_report = report
        return report

    def preflight_bucket_steps(self, *, compile_fn=None, limit_bytes=None):
        """The per-bucket memory pre-flight: before the first bucketed step,
        measure ONE train step per bucket shape (largest seq first: the
        heaviest), and if any bucket exceeds the card's memory, raise
        ``batch_split`` and re-derive every bucket's batch
        (``BucketedDataLoader.rescale``) before measuring again.

        ``compile_fn(trainer, seq, batch)`` / ``limit_bytes`` are the test
        injection points. Returns the report (also ``preflight_report``);
        None when disabled, not bucketed, or without a limit (the CPU)."""
        self._preflight_done = True
        loader = self.train_dataloader
        if not self.hbm_preflight or not isinstance(loader, BucketedDataLoader):
            return None
        limit = (limit_bytes if limit_bytes is not None
                 else hbm.device_hbm_bytes(self.device))
        if limit is None:
            logger.info("Memory pre-flight: device reports no memory limit; "
                        "skipping.")
            return None
        data = self.plan.data_size
        report = {**self._preflight_fields(limit), "buckets": []}
        while True:
            over_bytes = None
            checked = []
            stand_down = False
            for seq in sorted(loader.batch_sizes, reverse=True):
                b = loader.batch_sizes[seq]
                if compile_fn is not None:
                    fn = (lambda seq=seq, b=b:
                          compile_fn(self, seq, b).memory_analysis())
                else:
                    # this process's rows of the bucket's global batch
                    inputs, labels = synthetic_qa_batch(b // data, seq)
                    fn = (lambda inputs=inputs, labels=labels:
                          self._probe_step(self._placed(inputs),
                                           self._placed(labels)))
                need, over = self._measured_need(fn, limit)
                if need is None:
                    logger.info("Memory pre-flight: memory analysis "
                                "unavailable; skipping.")
                    stand_down = True
                    break
                checked.append({"bucket": f"{b}x{seq}", "bytes": int(need)})
                if over:
                    over_bytes = int(need)
                    break
            report["buckets"] = checked
            if stand_down or over_bytes is None:
                break
            new_split = self._next_batch_split()
            if new_split is None:
                logger.warning(
                    "Memory pre-flight: bucket %s needs %.2f GB vs %.2f GB "
                    "device memory and batch_split %d cannot be raised "
                    "further; proceeding.", checked[-1]["bucket"],
                    over_bytes / 1e9, limit / 1e9, self.batch_split)
                break
            logger.warning(
                "Memory pre-flight: bucket %s at batch_split %d needs %.2f GB "
                "vs %.2f GB device memory; raising batch_split to %d and "
                "re-deriving bucket batches.", checked[-1]["bucket"],
                self.batch_split, over_bytes / 1e9, limit / 1e9, new_split)
            self.batch_split = new_split
            report["batch_split"] = new_split
            report["applied"] = True
            loader.rescale(new_split * max(data, 1))
        self.preflight_report = report
        return report

    # -- the train step --------------------------------------------------------

    def train_step(self, inputs: Dict[str, torch.Tensor],
                   labels: Dict[str, torch.Tensor]) -> dict:
        """One optimizer step on this process's placed rows of a global
        batch (the whole batch alone); returns the step's values (per-head
        losses and ``loss`` averaged over the micro-batches, of the global
        batch, and the applied ``lr``) as host floats."""
        rows = inputs["input_ids"].shape[0]
        if rows % self.batch_split:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{self.batch_split} micro-batches")
        if self.pipe is not None:
            return self._pipe_train_step(inputs, labels)
        micro = rows // self.batch_split
        world, S = self.plan.data_size, self.seq_size
        # each rank of a model group computed the same values
        counted = S * self.model_size
        model, params = self.model, self.optimizer.params
        model.train()
        for p in params.values():
            p.grad = None
        gens = step_generators(self.seed, self.global_step, self.batch_split,
                               self.device)
        labels_of = [{k: v[i * micro:(i + 1) * micro] for k, v in labels.items()}
                     for i in range(self.batch_split)]
        global_rows = denominators = None
        if world > 1:
            global_rows = (self.mesh.data_index * micro, world * micro)
            denominators = collectives.all_reduce_sum_(torch.stack(
                [self.loss.denominators(t) for t in labels_of]),
                self.mesh.data_group)
        scale = self.loss_scale
        exchange = self._exchange
        summed: Dict[str, torch.Tensor] = {}
        for i, gen in enumerate(gens):
            rows_i = slice(i * micro, (i + 1) * micro)
            preds = model(**self._model_inputs(
                {k: v[rows_i] for k, v in inputs.items()}), generator=gen,
                global_rows=global_rows)
            total, values = self.loss(
                preds, labels_of[i],
                None if denominators is None else denominators[i])
            if S > 1:
                # every rank of the seq group computed this same loss
                total = total / S
            if scale is not None:
                total = ls_lib.scale_loss(total, scale)
            if exchange is not None and i == len(gens) - 1:
                exchange.arm()
            total.backward()
            for k, v in values.items():
                v = v.detach().float() / counted
                summed[k] = summed[k] + v if k in summed else v

        if exchange is not None:
            # this rank's slices and the whole leaves, summed over data
            reduced = exchange.finish()
            grads = {n: reduced[n] for n in params}
        elif self.tp is not None:
            self._reduce_model_gradients(params)
        elif self.process_count > 1:
            collectives.all_reduce_gradients(params.items())
        if self.process_count > 1:
            keys = list(summed)
            reduced = collectives.all_reduce_sum_(
                torch.stack([summed[k] for k in keys]))
            summed = dict(zip(keys, reduced))
        inv = 1.0 / self.batch_split
        if exchange is None:
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for n, p in params.items()}
        torch._foreach_mul_(list(grads.values()), inv)
        finite = True
        if scale is not None:
            # after the all-reduce: every process sees the same flag
            ls_lib.unscale_(list(grads.values()), scale)
            finite = ls_lib.all_finite(list(grads.values()))
            if exchange is not None or self.tp is not None:
                # each rank checked its own slices: agree on the flag
                flag = collectives.all_reduce_sum_(torch.tensor(
                    [float(not finite)], device=self.device),
                    exchange.group if exchange is not None
                    else self.mesh.model_group)
                finite = not bool(flag.item())
            lr = self.optimizer.lr()
        else:
            lr = self.optimizer.schedule(self.global_step)
        if finite:
            if self.max_grad_norm is not None and self.max_grad_norm > 0:
                if exchange is not None:
                    clip_sliced_(grads, self.optimizer.zero,
                                 self.max_grad_norm)
                elif self.tp is not None:
                    clip_by_global_norm_(
                        list(grads.values()), self.max_grad_norm,
                        sharded=[self.tp.sharded(n) for n in grads],
                        model_sum=self._model_sum)
                else:
                    clip_by_global_norm_(list(grads.values()),
                                         self.max_grad_norm)
            self.optimizer.step(grads, local=exchange is not None)
        out = {k: float(v * inv) for k, v in summed.items()}
        out["lr"] = lr
        if scale is not None:
            self.loss_scale = ls_lib.update_state(scale, finite)
            out["loss_scale"] = self.loss_scale.scale
            out["grads_finite"] = float(finite)
        return out

    def _pipe_micro_batches(self, inputs: Dict[str, torch.Tensor],
                            labels: Dict[str, torch.Tensor],
                            batch_split: int) -> Dict[str, torch.Tensor]:
        """This stage's part of ``batch_split`` micro-batches' forward and
        backward on the schedule (``parallel/pipeline.PipelineStep``): the
        embeddings on stage 0, the stage's layers, and on the last stage
        the heads and the loss, each loss over its global denominators
        (summed over the last stage's ``data`` group). Dropout draws from
        the per-(micro-batch, layer) generators of
        ``pipeline.step_generator``. Returns the last stage's summed values
        (empty on the others)."""
        lay, model = self.pipe, self.model
        rows = inputs["input_ids"].shape[0]
        micro = rows // batch_split
        D = self.plan.data_size
        global_rows = (self.mesh.data_index * micro, D * micro) if D > 1 \
            else None
        x_all = self._model_inputs(inputs)
        x_of = [{k: v[i * micro:(i + 1) * micro] for k, v in x_all.items()}
                for i in range(batch_split)]
        labels_of = [{k: v[i * micro:(i + 1) * micro]
                      for k, v in labels.items()} for i in range(batch_split)]
        denominators = None
        if lay.last and D > 1:
            denominators = collectives.all_reduce_sum_(torch.stack(
                [self.loss.denominators(t) for t in labels_of]),
                self.mesh.data_group)
        step, scale = self.global_step, self.loss_scale
        summed: Dict[str, torch.Tensor] = {}

        def gen(i: int, slot: int) -> torch.Generator:
            return pipeline.step_generator(self.seed, step, i, slot,
                                           self.device)

        def forward(i: int, h: Optional[torch.Tensor]):
            x = x_of[i]
            mask = x["attention_mask"]
            if lay.first:
                h = model.embed(x["input_ids"], x["token_type_ids"],
                                gen(i, 0), global_rows, x.get("position_ids"))
            y = model.layers(h, mask, lay.lo, lay.hi,
                             lambda li: gen(i, 1 + li), global_rows,
                             x.get("segment_ids"))
            if not lay.last:
                return y
            preds = model.tail(y, mask, gen(i, 1 + lay.num_layers),
                               global_rows, x.get("segment_ids"),
                               x.get("segment_starts"))
            total, values = self.loss(
                preds, labels_of[i],
                None if denominators is None else denominators[i])
            for k, v in values.items():
                v = v.detach().float()
                summed[k] = summed[k] + v if k in summed else v
            return (total if scale is None
                    else ls_lib.scale_loss(total, scale))

        L = x_all["input_ids"].shape[1]
        H = model.cfg.hidden_size
        self.pipe_runner.run(batch_split, forward, lambda i: (micro, L, H))
        return summed

    def _pipe_train_step(self, inputs: Dict[str, torch.Tensor],
                         labels: Dict[str, torch.Tensor]) -> dict:
        """:meth:`train_step` of one pipeline stage: the schedule's
        micro-batches (:meth:`_pipe_micro_batches`), then the stage's
        gradients summed over its ``data`` group (under a ``model`` axis,
        :meth:`_reduce_model_gradients`: a rank's slices over ``data``, the
        leaves it holds whole over the stage's ``data`` x ``model`` ranks
        and divided by the group's size), scaled by ``1/batch_split``,
        clipped by the norm of the whole model's gradient (each stage's
        squares, those of the split leaves summed over ``model``, summed
        over the ``pipe`` group), and the stage's update; under
        ``replicated`` each stage's updated parameters are then broadcast
        over the ``pipe`` group. The logged values are the last stage's,
        one ``model`` rank's (its group computed the same), summed over
        the world."""
        model, params = self.model, self.optimizer.params
        model.train()
        for p in params.values():
            p.grad = None
        summed = self._pipe_micro_batches(inputs, labels, self.batch_split)
        keys = list(self.loss.keys) + ["loss"]
        values = torch.stack([summed.get(k, torch.zeros((), device=self.device))
                              for k in keys]).float()
        if self.mesh.model_index:
            values.zero_()
        if self.process_count > 1:
            # the last stage's values; the other stages (and the other
            # ranks of a model group) add zeros
            collectives.all_reduce_sum_(values)
        if self.tp is not None:
            self._reduce_model_gradients(params)
        elif self.plan.data_size > 1:
            collectives.all_reduce_gradients(params.items(),
                                             group=self.mesh.data_group)
        inv = 1.0 / self.batch_split
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        torch._foreach_mul_(list(grads.values()), inv)
        scale, finite = self.loss_scale, True
        if scale is not None:
            ls_lib.unscale_(list(grads.values()), scale)
            # every stage checked its own leaves: agree on the flag
            flag = collectives.all_reduce_sum_(torch.tensor(
                [float(not ls_lib.all_finite(list(grads.values())))],
                device=self.device))
            finite = not bool(flag.item())
            lr = self.optimizer.lr()
        else:
            lr = self.optimizer.schedule(self.global_step)
        if finite:
            if self.max_grad_norm is not None and self.max_grad_norm > 0:
                split = (None if self.tp is None else
                         dict(sharded=[self.tp.sharded(n) for n in grads],
                              model_sum=self._model_sum))
                clip_by_global_norm_(list(grads.values()), self.max_grad_norm,
                                     sum_over=self._pipe_sum, **(split or {}))
            self.optimizer.step(grads)
            if self.pipe.layout == "replicated":
                self._share_stage_parameters()
        out = {k: float(v * inv) for k, v in zip(keys, values)}
        out["lr"] = lr
        if scale is not None:
            self.loss_scale = ls_lib.update_state(scale, finite)
            out["loss_scale"] = self.loss_scale.scale
            out["grads_finite"] = float(finite)
        return out

    def _share_stage_parameters(self) -> None:
        """``replicated``: every stage's parameters broadcast from the
        stage's rank over the ``pipe`` group, so each rank holds the whole
        updated model."""
        named = dict(self.model.named_parameters())
        for k, src in enumerate(self.mesh.pipe_ranks):
            collectives.broadcast_parameters(
                ((n, named[n]) for n in named if self.pipe.owner[n] == k),
                src=src, group=self.mesh.pipe_group)

    def _pipe_eval(self, inputs: Dict[str, torch.Tensor]) -> dict:
        """The eval forward of a pipeline, the batch as one micro-batch; the
        last stage's predictions reach every rank of the ``pipe`` group
        (the JAX pipeline returns its outputs to every rank too)."""
        lay, model = self.pipe, self.model
        x = self._model_inputs(inputs)
        mask = x["attention_mask"]

        def forward(_, h):
            if lay.first:
                h = model.embed(x["input_ids"], x["token_type_ids"],
                                position_ids=x.get("position_ids"))
            y = model.layers(h, mask, lay.lo, lay.hi,
                             segment_ids=x.get("segment_ids"))
            if not lay.last:
                return y
            return model.tail(y, mask, segment_ids=x.get("segment_ids"),
                              segment_starts=x.get("segment_starts"))

        B, L = x["input_ids"].shape
        out = self.pipe_runner.run(1, forward,
                                   lambda _: (B, L, model.cfg.hidden_size),
                                   train=False)
        box = [{k: v.cpu() for k, v in out[0].items()} if lay.last else None]
        torch.distributed.broadcast_object_list(
            box, src=self.mesh.pipe_ranks[-1], group=self.mesh.pipe_group)
        return {k: v.to(self.device) for k, v in box[0].items()}

    # -- train loop ------------------------------------------------------------

    def train(self, after_epoch_funcs=None) -> None:
        if self.train_dataloader is None:
            logger.warning("No train dataset was provided; train() is a no-op.")
            return
        for epoch_i in range(1, self.n_epochs + 1):
            self._train(epoch_i)
            for func in after_epoch_funcs or []:
                func(epoch_i)
        if self.profiler_window is not None:
            self.profiler_window.finish()

    @time_profiler
    def _train(self, epoch_i: int) -> None:
        loader = self.train_dataloader
        loader.set_epoch(epoch_i)
        if isinstance(loader, BucketedDataLoader) and not self._preflight_done:
            # per-bucket plan BEFORE any batch is drawn: may raise
            # batch_split and re-derive the loader's bucket batch sizes
            self.preflight_bucket_steps()
        avg_meters: dict = defaultdict(AverageMeter)
        packed = isinstance(loader, PackedDataLoader)
        # steps of varying example counts: each step's mean weighs by its
        # rows (bucketed) or real segments (packed)
        weighted = packed or isinstance(loader, BucketedDataLoader)
        tele = self.telemetry
        tracer = trace_mod.current()
        # either observability plane times the step honestly: the step
        # synchronizes CUDA before the clock is read (off path untouched)
        instrument = tele is not None or tracer is not None
        # steady-state steps 2-4 when the first epoch has them; short or
        # debug epochs trace from step 0 instead of capturing nothing. A
        # capture without CUDA activity moves on to the next steps, into
        # the next epochs too
        window = self.profiler_window
        if self.trace_dir is not None and window is None:
            trace_from = 0 if self.debug or len(loader) < 5 else 2
            window = self.profiler_window = ProfilerWindow(
                self.trace_dir, start=trace_from, steps=3, device=self.device,
                process_index=self.process_index)
        if window is not None and window.done:
            window = None
        # FIFO-matched to batch order (one placement thread at most): place
        # appends, the step pops the stats of the batch it runs
        host_stats = deque() if instrument else None
        host_inline = self.device_prefetch == 0
        batches, prefetcher = self._batches(loader, "device-prefetch",
                                            host_stats)
        batches = iter(batches)
        last_step = None
        # one watchdog frame per epoch, ticked per step: its deadline covers
        # the loader wait, the placement and the step
        with self._watched(f"train epoch {epoch_i}") as tick:
            try:
                while True:
                    t_fetch = time.perf_counter() if instrument else 0.0
                    placed = next(batches, None)
                    if placed is None:
                        break
                    if instrument:
                        t_got = time.perf_counter()
                        trace_mod.complete("data_wait", t_fetch, t_got,
                                           cat="train")
                    _fault("trainer.step")
                    tick(f"train step {self.global_step} (epoch {epoch_i})")
                    tensors = None
                    if not self._preflight_done:
                        # the run's first batch: plan before its step (may
                        # raise batch_split), outside the step's clock and
                        # the profiler window
                        tensors = self._seq_consistent(placed.ready())
                        self.preflight_train_step(tensors["inputs"],
                                                  tensors["labels"])
                    if window is not None:
                        window.on_step_start()
                    t0 = time.perf_counter()
                    if tensors is None:
                        tensors = self._seq_consistent(placed.ready())
                    rows = (placed.meta.segments if packed
                            else int(tensors["inputs"]["input_ids"].shape[0])
                            * self.plan.data_size)   # the global batch's
                    self.in_step = True
                    values = self.train_step(tensors["inputs"],
                                             tensors["labels"])
                    if instrument:
                        self._sync()
                    seconds = time.perf_counter() - t0
                    if instrument:
                        self._observe_step(
                            tele, t0, seconds, t_got - t_fetch, host_stats,
                            host_inline, rows, values)
                    self.history.append(dict(values, step=self.global_step,
                                             rows=rows, seconds=seconds))
                    for k, v in values.items():
                        if k == "lr":
                            avg_meters["lr"] = v
                        else:
                            avg_meters[k].update(v, rows if weighted else 1)
                    if self.on_train_metrics is not None:
                        self.on_train_metrics(avg_meters,
                                              step=self.global_step)
                    last_step = self.global_step
                    if (self.is_primary
                            and (last_step + 1) % self.log_every == 0):
                        self._update_writer(avg_meters, prefix="train",
                                            step=last_step)
                        logger.info("Train epoch %d step %d: %s", epoch_i,
                                    last_step, _console_str(avg_meters))
                    if window is not None:
                        window.on_step_end()
                    self.global_step += 1
                    if self.watchdog is not None:
                        self.watchdog.note_progress(self.global_step)
                    self.in_step = False
                    if self.interrupt_pending:
                        self.interrupt_pending = False
                        raise KeyboardInterrupt(
                            f"signal deferred to the end of step "
                            f"{self.global_step - 1}")
                    if self.debug:
                        logger.info("Training was interrupted because of "
                                    "debug mode.")
                        break
            finally:
                self.in_step = False
                if prefetcher is not None:
                    prefetcher.close()
                if window is not None:   # close a window still open
                    window.abort()
                if (self.is_primary and last_step is not None
                        and (last_step + 1) % self.log_every):
                    self._update_writer(avg_meters, prefix="train",
                                        step=last_step)
                    logger.info("Train epoch %d step %d: %s", epoch_i,
                                last_step, _console_str(avg_meters))
                stats = loader.epoch_stats if weighted else None
                if self.is_primary and stats and packed:
                    logger.info("Packed epoch %d: %d batches, packing "
                                "efficiency %.2f%% (padding waste %.2f%%; "
                                "pad-to-max would waste %.2f%%; %d splits in "
                                "%d fragment rows).",
                                epoch_i, stats["batches"],
                                100.0 * stats.get("packing_efficiency", 0.0),
                                stats.get("padding_waste_pct", 0.0),
                                stats.get("padmax_waste_pct", 0.0),
                                stats.get("split_count", 0),
                                stats.get("fragment_rows", 0))
                elif self.is_primary and stats:
                    logger.info("Bucketed epoch %d: %d batches, padding "
                                "waste %.2f%% (pad-to-max would be %.2f%%).",
                                epoch_i,
                                stats["batches"],
                                stats.get("padding_waste_pct", 0.0),
                                stats.get("padmax_waste_pct", 0.0))
                if self.writer is not None:
                    self.writer.flush()

    def _observe_step(self, tele, t0: float, device_s: float, fetch_s: float,
                      host_stats: deque, host_inline: bool, rows: int,
                      values: dict) -> None:
        """The instrumented step's accounting: the ``step`` span, and with
        telemetry the kernel libraries loaded since the last observed step
        (the pre-flight's loads land on the first), its ``data_wait`` /
        ``host`` / ``device`` breakdown and its scalars. Inline placement
        runs inside the fetch wait, so it is subtracted: the three
        components partition the step wall."""
        host_s, real_tokens, total_tokens = (
            host_stats.popleft() if host_stats else (0.0, 0, 0))
        data_wait_s = max(0.0, fetch_s - host_s) if host_inline else fetch_s
        trace_mod.complete("step", t0, t0 + device_s, cat="train",
                           args={"step": self.global_step, "rows": rows})
        if tele is None:
            return
        events = cuda_build.load_events()
        for outcome, seconds in events[self._loads_observed:]:
            tele.observe_aot(outcome, seconds)
        self._loads_observed = len(events)
        tele.observe_step(
            self.global_step, data_wait_s=data_wait_s, host_s=host_s,
            device_s=device_s, examples=rows, real_tokens=real_tokens,
            total_tokens=total_tokens,
            # placement on the prefetch thread overlaps the previous
            # step's device time: it is not on the step wall
            host_overlapped=not host_inline)
        tele.observe_scalars(values)

    # -- test loop -------------------------------------------------------------

    def test(self, epoch_i: int, *, callbacks=None) -> Optional[dict]:
        if self.test_dataloader is None:
            logger.warning("No test dataset was provided; test() is a no-op.")
            return None
        if callbacks is not None and not isinstance(callbacks, (list, tuple)):
            callbacks = (callbacks,)
        if callbacks is not None and not all(
                isinstance(c, TestCallback) for c in callbacks):
            raise TypeError("callbacks must be TestCallback instances")
        self.model.eval()
        # eval wall time is badput under the goodput discipline (devices
        # busy, no training progress): the ledger gets it via telemetry
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                return self._test(epoch_i, callbacks)
        finally:
            if self.telemetry is not None:
                self.telemetry.observe_eval(time.perf_counter() - t0)

    @time_profiler
    def _test(self, epoch_i: int, callbacks) -> dict:
        avg_meters: dict = defaultdict(AverageMeter)
        batches, prefetcher = self._batches(self.test_dataloader,
                                            "device-prefetch-eval")
        with self._watched(f"test epoch {epoch_i}") as tick:
            try:
                for i, placed in enumerate(batches):
                    _fault("trainer.eval_step")
                    tick(f"eval step {i} (epoch {epoch_i})")
                    tensors = self._seq_consistent(placed.ready())
                    inputs, labels = tensors["inputs"], tensors["labels"]
                    preds = (self._pipe_eval(inputs) if self.pipe is not None
                             else self.model(**self._model_inputs(inputs)))
                    if self.plan.data_size > 1:
                        # every data rank's rows, in order: the global batch
                        preds, labels = (
                            {k: v.to(self.device) for k, v in
                             collectives.gather_to_host(
                                 tree, self.mesh.data_group).items()}
                            for tree in (preds, labels))
                    meta = placed.meta
                    if isinstance(meta, PackedBatch):
                        self._test_packed_batch(preds, labels, meta,
                                                avg_meters, callbacks)
                        if self.debug and i >= 10:
                            logger.info("Test was interrupted because of debug "
                                        "mode.")
                            break
                        continue
                    if meta is not None:
                        n_valid, batch_rows = meta.real_rows, meta.rows
                    else:
                        n_valid = self.test_dataloader.real_rows(i)
                        batch_rows = self._test_sampler.global_batch_size
                    if n_valid < batch_rows:
                        # the pad_last tail repeats its last row: meters and
                        # callbacks see the real rows only
                        preds = {k: v[:n_valid] for k, v in preds.items()}
                        labels = {k: v[:n_valid] for k, v in labels.items()}
                    _, values = self.loss(preds, labels)
                    for k, v in values.items():
                        avg_meters[k].update(float(v), n_valid)
                    self.eval_batches += 1
                    if callbacks is not None:
                        host_preds = {k: v.float().cpu().numpy()
                                      for k, v in preds.items()}
                        host_labels = {k: v.cpu().numpy()
                                       for k, v in labels.items()}
                        for callback in callbacks:
                            callback.at_iteration_end(host_preds, host_labels,
                                                      avg_meters)
                    if self.debug and i >= 10:
                        logger.info("Test was interrupted because of debug "
                                    "mode.")
                        break
            finally:
                if prefetcher is not None:
                    prefetcher.close()

        if callbacks is not None:
            for callback in callbacks:
                callback.at_epoch_end(avg_meters, self)
        self._update_writer(avg_meters, prefix="test")
        if self.writer is not None:
            self.writer.flush()
        metrics = {k: v() if isinstance(v, AverageMeter) else v
                   for k, v in avg_meters.items()}
        if self.is_primary:
            logger.info(f"Test metrics after epoch {epoch_i} - "
                        f"{_console_str(metrics)}")
        return metrics

    def _test_packed_batch(self, preds, labels, meta: PackedBatch,
                           avg_meters: dict, callbacks) -> None:
        """One packed eval batch: the loss is already a mean over real
        segments (pad rows carry mask 0), weighted by their count; the
        callbacks get per-chunk arrays, the ``[rows, S]`` segment planes
        read out in row-major order through ``segment_mask``."""
        _, values = self.loss(preds, labels)
        for k, v in values.items():
            avg_meters[k].update(float(v), meta.segments)
        self.eval_batches += 1
        if callbacks is None:
            return
        m = labels["segment_mask"].reshape(-1).cpu().numpy() > 0
        host_preds = {k: v.float().cpu().numpy() for k, v in preds.items()}
        host_preds = {k: v.reshape((-1,) + v.shape[2:])[m]
                      for k, v in host_preds.items()}
        host_labels = {k: v.cpu().numpy().reshape(-1)[m]
                       for k, v in labels.items() if k != "segment_mask"}
        for callback in callbacks:
            callback.at_iteration_end(host_preds, host_labels, avg_meters)

    # -- checkpointing ---------------------------------------------------------

    def _save_kwargs(self) -> dict:
        return dict(model=self.model, optimizer=self.optimizer,
                    loss_scale=self.loss_scale, global_step=self.global_step,
                    extra=checkpoint_extra(
                        self.plan.describe(), self.zero_enabled(),
                        self.pipe_schedule if self.pipe is not None else None,
                        self.pipe_param_layout))

    def _pipe_groups(self, *, copy: bool, local: bool) -> dict:
        """This stage's part of the checkpoint's groups. With ``local`` (a
        sharded save) each leaf is a list of :class:`LocalPiece` in the JAX
        stage layout's geometry (``StageLayout.pieces``): a stage's
        parameters and its whole moments are written by its ``data`` index
        0 rank (under a ``model`` axis, each slice of a split leaf by that
        rank of its ``model`` group, a leaf the group holds whole by its
        ``model`` index 0 rank), a ZeRO-1 moment's slices by every rank of
        the stage, the counts and the loss-scale state by rank 0. Without
        it, the stage's whole leaves (every rank of the stage takes part in
        the ZeRO-1 and ``model`` gathers) for rank 0 to merge."""
        from ..models.convert import jax_path, to_jax_params
        from ..parallel.sharding import LocalPiece

        lay, tp = self.pipe, self.tp
        named = {n: p for n, p in self.model.named_parameters()
                 if n in set(lay.owned)}
        # the rank that writes a leaf its model group holds whole
        writer = self.mesh.data_index == 0 and self.mesh.model_index == 0
        groups = {}
        if tp is not None and not local:
            # every rank of the model group gathers the split leaves
            named = {n: tp.gather(n, p.detach()) for n, p in named.items()}
        if writer or local:
            groups["model"] = to_jax_params(named, copy=copy)
        if self.optimizer is not None:
            optimizer = self.optimizer.flax_state(copy=copy, local=local)
            if writer or local:
                groups["optimizer"] = optimizer
        if self.loss_scale is not None and self.is_primary:
            groups["loss_scale"] = self.loss_scale.state_dict()
        if not local:
            return groups
        names = {jax_path(n): n for n in lay.owned}

        def cut(path, leaf):
            name = next((names[path[j:]] for j in range(len(path))
                         if path[j:] in names), None)
            if name is None:   # a count: the same on every stage
                return [LocalPiece(np.shape(leaf), tuple(
                    (0, int(d)) for d in np.shape(leaf)), np.asarray(leaf),
                    1, self.is_primary)]
            if not isinstance(leaf, LocalPiece):
                arr = np.asarray(leaf)
                if tp is not None and tp.sharded(name):   # a weight
                    leaf = tp.piece(name, arr)
                else:
                    leaf = LocalPiece(arr.shape, tuple((0, int(d))
                                                       for d in arr.shape),
                                      arr, 1, writer)
            return lay.pieces(name, leaf)

        def walk(tree, prefix=()):
            return {k: (walk(v, prefix + (k,)) if isinstance(v, dict) and v
                        else v if isinstance(v, dict)
                        else cut(prefix + (k,), v)) for k, v in tree.items()}

        return {g: (walk(t) if g != "loss_scale" else t)
                for g, t in groups.items()}

    def _save_pipe(self, path, *, copy: bool = False):
        """The pipeline's save: the sharded directory's part of this
        process (the manifests merged on rank 0), or the single file's
        state merged on rank 0 (None elsewhere). Every process calls it."""
        import torch.distributed as dist

        kw = self._save_kwargs()
        if self.sharded_checkpoint:
            snap = ckpt.snapshot_state_sharded(
                groups=self._pipe_groups(copy=copy, local=True),
                global_step=kw["global_step"], extra=kw["extra"],
                process_index=self.process_index,
                process_count=self.process_count)
            metas = [None] * self.process_count if self.is_primary else None
            dist.gather_object(snap["manifest"]["groups"], metas, dst=0)
            return (ckpt.merge_manifests(snap, metas) if self.is_primary
                    else snap)
        parts = [None] * self.process_count if self.is_primary else None
        dist.gather_object(self._pipe_groups(copy=copy, local=False), parts,
                           dst=0)
        if not self.is_primary:
            return None
        merged = merge_jax_params(*parts)
        state = {"model": merged["model"],
                 "optimizer": merged.get("optimizer"),
                 "scheduler": {"last_step": int(kw["global_step"])},
                 "global_step": int(kw["global_step"]), **kw["extra"]}
        if "loss_scale" in merged:
            state["loss_scale"] = merged["loss_scale"]
        return state

    def save_state_dict(self, path) -> None:
        """A checkpoint at ``path``: the single file by rank 0, or the
        sharded directory by every process; with ``async_checkpoint``, its
        write on the background thread where :meth:`_async_supported`."""
        if self.debug:
            logger.info(f"Model was not saved to {path} because of debug mode.")
            return
        if self._async_ckpt is not None and self._async_supported():
            return self._save_state_dict_async(path)
        # the sync save keeps the single-flight order: an earlier
        # background write lands first
        self.finish_pending_checkpoint()
        t0 = time.perf_counter()
        # its own watchdog frame of 8x the step timeout: a save writes the
        # whole state (and the sharded one crosses barriers, which nest
        # their frames in this budget); a slow save is not a hang
        with self._watched(f"checkpoint save {path}", scale=8.0), \
                trace_mod.span("checkpoint_save", cat="train",
                               args={"path": str(path),
                                     "step": self.global_step}):
            if self.pipe is not None:
                state = self._save_pipe(path)
                if self.sharded_checkpoint:
                    ckpt.persist_state_sharded(path, state)
                elif self.is_primary:
                    ckpt.persist_state(path, state)
            elif self.sharded_checkpoint:
                ckpt.save_state_dict_sharded(
                    path, process_index=self.process_index,
                    process_count=self.process_count, **self._save_kwargs())
            elif self.zero_enabled() or self.tp is not None:
                # the padded moments (the model's slices) are gathered by
                # every process
                state = ckpt.snapshot_state(**self._save_kwargs())
                if self.is_primary:
                    ckpt.persist_state(path, state)
            elif self.is_primary:
                ckpt.save_state_dict(path, **self._save_kwargs())
        seconds = time.perf_counter() - t0
        self.checkpoint_seconds = {"save": seconds}
        if self.telemetry is not None:
            self.telemetry.observe_checkpoint_save(seconds)

    def _async_supported(self) -> bool:
        """A sharded save of several processes crosses process barriers,
        which must not run on a background thread beside the step's
        collectives: it stays synchronous (logged once), the JAX trainer's
        rule (``ml_recipe_tpu/train/trainer.py`` ``_async_supported``)."""
        if self.pipe is not None:
            return False   # the stages' merge is a collective
        if not (self.sharded_checkpoint and self.process_count > 1):
            return True
        if not self._async_fallback_logged:
            self._async_fallback_logged = True
            logger.warning(
                "--async_checkpoint with --sharded_checkpoint on a "
                "multi-process world: the sharded persist crosses process "
                "barriers, which must not run on a background thread "
                "concurrently with training collectives — saving "
                "synchronously instead, as the JAX trainer does for a "
                "multi-host sharded checkpoint.")
        return False

    def _save_state_dict_async(self, path) -> None:
        """Block for the earlier write and the host snapshot (owned copies:
        the next step updates the parameters and moments in place), then
        write on the background thread."""
        t0 = time.perf_counter()
        copy = self.device.type == "cpu"
        with self._watched(f"checkpoint save {path}", scale=8.0), \
                trace_mod.span("checkpoint_save", cat="train",
                               args={"path": str(path),
                                     "step": self.global_step,
                                     "async": True}):
            self._async_ckpt.wait()
            with trace_mod.span("ckpt_snapshot", cat="train",
                                args={"step": self.global_step}):
                if self.sharded_checkpoint:
                    snap = ckpt.snapshot_state_sharded(
                        process_index=self.process_index,
                        process_count=self.process_count, copy=copy,
                        **self._save_kwargs())
                    persist = functools.partial(ckpt.persist_state_sharded,
                                                os.fspath(path), snap)
                elif (self.is_primary or self.zero_enabled()
                      or self.tp is not None):
                    # under ZeRO-1 (a model axis) every process takes part
                    # in the gather
                    state = ckpt.snapshot_state(copy=copy,
                                                **self._save_kwargs())
                    persist = (functools.partial(ckpt.persist_state,
                                                 os.fspath(path), state)
                               if self.is_primary else None)
                else:
                    persist = None
        blocking = time.perf_counter() - t0
        self.checkpoint_seconds = {"snapshot": blocking}
        if self.telemetry is not None:
            self.telemetry.observe_checkpoint_snapshot(blocking)
        if persist is None:
            return
        telemetry = self.telemetry

        def on_done(persist_s: float, stalled_s: float) -> None:
            self.checkpoint_seconds["persist"] = persist_s
            if telemetry is not None:
                telemetry.observe_checkpoint_persist(persist_s, stalled_s)

        self._async_ckpt.submit(path, persist, on_done=on_done)
        logger.info("Async checkpoint: step %d snapshot blocked %.3fs; "
                    "persist to %s running in the background.",
                    self.global_step, blocking, path)

    def finish_pending_checkpoint(self, *, raise_errors: bool = True) -> None:
        """The completion barrier of ``async_checkpoint``: block until the
        background write lands (a no-op without one) and re-raise its
        failure as ``AsyncCheckpointError``; with ``raise_errors=False``
        the failure is logged and consumed instead (a path that already
        handles an error, or an emergency save)."""
        if self._async_ckpt is not None:
            with self._watched("checkpoint persist wait", scale=8.0):
                self._async_ckpt.wait(raise_errors=raise_errors)

    def _warn_topology_change(self, path) -> None:
        """Name a topology change at restore time (the JAX trainer's rule):
        a sharded directory saved under another mesh (its manifest's
        ``mesh_axes``) is restored onto the live one loudly, and recorded
        as ``mesh_shrunk`` in the flight recorder. Single files are not
        peeked (a full read), as in the JAX trainer."""
        saved = ckpt.peek_mesh_axes(path)
        live = self.plan.describe()
        if not saved or saved == live:
            return
        logger.warning(
            f"ELASTIC RESUME / topology change: checkpoint {path} was saved "
            f"under mesh {saved}, restoring onto {live}. Optimizer state is "
            f"corner-cropped/zero-filled onto the live ZeRO-1 layout; the LR "
            f"schedule is keyed to the GLOBAL batch and global_step, so it "
            f"continues unchanged — at a smaller data axis each step "
            f"consumes the same global batch over fewer devices (slower "
            f"wall-clock, identical math).")
        flightrec = getattr(self.telemetry, "flightrec", None)
        if flightrec is not None:
            flightrec.record("mesh_shrunk", old=saved, new=live)

    def load_state_dict(self, path) -> None:
        """Restore a checkpoint of either layout and either package: the
        weights, and unless ``drop_optimizer`` the optimizer state and the
        loss-scale state. A loss-scale mode (or static value) that differs
        from ``--apex_loss_scale`` keeps the flag's state, with a
        warning."""
        # the last save must be on disk before anything is read
        self.finish_pending_checkpoint()
        t0 = time.perf_counter()
        with trace_mod.span("checkpoint_restore", cat="train",
                            args={"path": str(path)}):
            restored = ckpt.load_training_state(
                path, model=self.model, optimizer=self.optimizer,
                drop_optimizer=self.drop_optimizer,
                only=(self.pipe.owned if self.pipe_param_layout == "stage"
                      else None))
        if self.telemetry is not None:
            self.telemetry.observe_checkpoint_restore(time.perf_counter() - t0)
        if restored is None:
            return
        self.global_step = restored.global_step
        self._warn_topology_change(path)
        live = self.loss_scale
        if live is not None and restored.loss_scale is not None:
            saved = ls_lib.LossScaleState.from_state_dict(restored.loss_scale)
            if saved.dynamic != live.dynamic or (
                    not live.dynamic and saved.scale != live.scale):
                logger.warning("Checkpoint loss-scale state differs from "
                               "--apex_loss_scale; keeping the configured "
                               "scaling state.")
            else:
                self.loss_scale = saved
        if self.process_count > 1 and self.pipe is None:
            self._broadcast_parameters()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
