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
   (``train/optim.py``) updates the parameters in place at
   ``schedule(count)``.

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

The loaders are the JAX package's (bucketed when ``length_buckets``), and
``device_prefetch`` stages batches onto the device on a background thread
(``data/device_prefetch.py``). ``test`` runs the eval loop under
``torch.inference_mode`` with the callbacks; ``debug`` takes one step per
epoch over two epochs and 11 eval batches, and skips checkpoint writes, as
in the JAX trainer. ``sharded_checkpoint`` writes the JAX package's
sharded-directory layout instead of one file; a resume reads either
(``train/checkpoint.py``). Left out (their flags are refused by
``config.parser.check_train_flags``): data, pipeline, tensor and sequence
parallelism beyond data parallelism (ZeRO-1 is accepted at world size 1,
where it is inert), the AOT store, telemetry, the watchdog, async
checkpoints, loss scaling, packing and the HBM pre-flight.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.bucketing import BucketedBatch, BucketedDataLoader, parse_length_buckets
from ..data.device_prefetch import BatchPlacer, DevicePrefetcher, resolve_depth
from ..data.loader import DataLoader, ShardedBatchSampler
from ..metrics.meters import AverageMeter
from ..parallel import collectives
from ..parallel import dist as pdist
from .callback import TestCallback
from .checkpoint import load_training_state
from .checkpoint import save_state_dict as _save_ckpt
from .checkpoint import save_state_dict_sharded as _save_ckpt_sharded
from .optim import build_optimizer, clip_by_global_norm_
from .writer import init_writer

logger = logging.getLogger(__name__)


def checkpoint_extra(world: int = 1) -> dict:
    """Every checkpoint's topology record (the JAX trainer's
    ``_checkpoint_extra`` on a ``data:W`` mesh of one device per
    process)."""
    return {"opt_sharding": "off", "mesh_axes": {"data": int(world)},
            "pipe_schedule": None, "pipe_param_layout": None}


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


def _normalize_batch(batch):
    """Loader item -> ``(inputs, labels, meta)``; ``meta`` is the
    BucketedBatch on the bucketed path, None on the pad-to-max path."""
    if isinstance(batch, BucketedBatch):
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
        self.device_prefetch = resolve_depth(device_prefetch)
        self.log_every = max(1, int(log_every))
        self.on_train_metrics = on_train_metrics
        # one record per optimizer step: its values, lr, rows and host
        # seconds (the step ends in a host read of its loss)
        self.history: List[dict] = []
        self.eval_batches = 0   # eval batches run, over every test() call

        self.process_index = pdist.process_index()
        self.process_count = world = pdist.process_count()
        self.is_primary = self.process_index == 0
        if train_dataset is not None and (
                train_batch_size % world
                or (train_batch_size // world) % batch_split):
            raise ValueError(
                f"train_batch_size {train_batch_size} must split over {world} "
                f"processes into batch_split={batch_split} equal "
                f"micro-batches each")
        if test_dataset is not None and test_batch_size % world:
            raise ValueError(f"test_batch_size {test_batch_size} must divide "
                             f"over {world} processes")
        shard = dict(process_index=self.process_index, process_count=world)

        max_len = getattr(collate_fun, "keywords", {}).get("max_seq_len")
        self._seq_grid = (parse_length_buckets(length_buckets, max_len)
                          if length_buckets else None)

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
            if self._seq_grid is not None:
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
            if self._seq_grid is not None:
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
                trainer_params, dict(model.named_parameters()),
                num_training_steps=num_training_steps, warmup_coef=warmup_coef)

        self.global_step = 0
        self.writer = init_writer(self.is_primary, writer_dir)
        if world > 1:
            # the replicas start equal (the reference's DDP wrapper)
            collectives.broadcast_parameters(model.named_parameters())
            logger.info("Data parallel: process %d of %d, %d rows of every "
                        "global batch of %d, in %d micro-batches.",
                        self.process_index, world, train_batch_size // world,
                        train_batch_size, batch_split)

    def _plan_schedule_steps(self) -> Optional[int]:
        loader = self.train_dataloader
        if not isinstance(loader, BucketedDataLoader):
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

    def _placer(self):
        placer = BatchPlacer(self.device)

        def place(batch):
            inputs, labels, meta = _normalize_batch(batch)
            return placer({"inputs": inputs, "labels": labels}, meta)

        return place

    def _batches(self, loader, name: str):
        """Placed batches of ``loader``: staged ``device_prefetch`` ahead on
        a background thread, or placed inline at depth 0. Returns
        ``(iterator, prefetcher or None)``."""
        place = self._placer()
        if self.device_prefetch > 0:
            prefetcher = DevicePrefetcher(iter(loader), place,
                                          depth=self.device_prefetch, name=name)
            return iter(prefetcher), prefetcher
        return (place(b) for b in loader), None

    def _model_inputs(self, inputs: Dict[str, torch.Tensor]) -> dict:
        return dict(input_ids=inputs["input_ids"].long(),
                    attention_mask=inputs["attention_mask"],
                    token_type_ids=inputs["token_type_ids"].long())

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
        micro = rows // self.batch_split
        world = self.process_count
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
            global_rows = (self.process_index * micro, world * micro)
            denominators = collectives.all_reduce_sum_(torch.stack(
                [self.loss.denominators(t) for t in labels_of]))
        summed: Dict[str, torch.Tensor] = {}
        for i, gen in enumerate(gens):
            rows_i = slice(i * micro, (i + 1) * micro)
            preds = model(**self._model_inputs(
                {k: v[rows_i] for k, v in inputs.items()}), generator=gen,
                global_rows=global_rows)
            total, values = self.loss(
                preds, labels_of[i],
                None if denominators is None else denominators[i])
            total.backward()
            for k, v in values.items():
                v = v.detach().float()
                summed[k] = summed[k] + v if k in summed else v

        if world > 1:
            collectives.all_reduce_gradients(params.items())
            keys = list(summed)
            reduced = collectives.all_reduce_sum_(
                torch.stack([summed[k] for k in keys]))
            summed = dict(zip(keys, reduced))
        inv = 1.0 / self.batch_split
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        torch._foreach_mul_(list(grads.values()), inv)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            clip_by_global_norm_(list(grads.values()), self.max_grad_norm)
        lr = self.optimizer.step(grads)
        out = {k: float(v * inv) for k, v in summed.items()}
        out["lr"] = lr
        return out

    # -- train loop ------------------------------------------------------------

    def train(self, after_epoch_funcs=None) -> None:
        if self.train_dataloader is None:
            logger.warning("No train dataset was provided; train() is a no-op.")
            return
        for epoch_i in range(1, self.n_epochs + 1):
            self._train(epoch_i)
            for func in after_epoch_funcs or []:
                func(epoch_i)

    def _train(self, epoch_i: int) -> None:
        loader = self.train_dataloader
        loader.set_epoch(epoch_i)
        avg_meters: dict = defaultdict(AverageMeter)
        weighted = isinstance(loader, BucketedDataLoader)
        batches, prefetcher = self._batches(loader, "device-prefetch")
        last_step = None
        try:
            for placed in batches:
                t0 = time.perf_counter()
                tensors = placed.ready()
                rows = (int(tensors["inputs"]["input_ids"].shape[0])
                        * self.process_count)   # the global batch's
                values = self.train_step(tensors["inputs"], tensors["labels"])
                seconds = time.perf_counter() - t0
                self.history.append(dict(values, step=self.global_step,
                                         rows=rows, seconds=seconds))
                for k, v in values.items():
                    if k == "lr":
                        avg_meters["lr"] = v
                    else:
                        avg_meters[k].update(v, rows if weighted else 1)
                if self.on_train_metrics is not None:
                    self.on_train_metrics(avg_meters, step=self.global_step)
                last_step = self.global_step
                if self.is_primary and (last_step + 1) % self.log_every == 0:
                    self._update_writer(avg_meters, prefix="train",
                                        step=last_step)
                    logger.info("Train epoch %d step %d: %s", epoch_i,
                                last_step, _console_str(avg_meters))
                self.global_step += 1
                if self.debug:
                    logger.info("Training was interrupted because of debug "
                                "mode.")
                    break
        finally:
            if prefetcher is not None:
                prefetcher.close()
            if (self.is_primary and last_step is not None
                    and (last_step + 1) % self.log_every):
                self._update_writer(avg_meters, prefix="train", step=last_step)
                logger.info("Train epoch %d step %d: %s", epoch_i, last_step,
                            _console_str(avg_meters))
            if self.is_primary and weighted and loader.epoch_stats:
                stats = loader.epoch_stats
                logger.info("Bucketed epoch %d: %d batches, padding waste "
                            "%.2f%% (pad-to-max would be %.2f%%).", epoch_i,
                            stats["batches"],
                            stats.get("padding_waste_pct", 0.0),
                            stats.get("padmax_waste_pct", 0.0))
            if self.writer is not None:
                self.writer.flush()

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
        with torch.inference_mode():
            return self._test(epoch_i, callbacks)

    def _test(self, epoch_i: int, callbacks) -> dict:
        avg_meters: dict = defaultdict(AverageMeter)
        batches, prefetcher = self._batches(self.test_dataloader,
                                            "device-prefetch-eval")
        try:
            for i, placed in enumerate(batches):
                tensors = placed.ready()
                inputs, labels = tensors["inputs"], tensors["labels"]
                preds = self.model(**self._model_inputs(inputs))
                if self.process_count > 1:
                    # every process's rows, in rank order: the global batch
                    preds, labels = (
                        {k: v.to(self.device) for k, v in
                         collectives.gather_to_host(tree).items()}
                        for tree in (preds, labels))
                meta = placed.meta
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
                    host_labels = {k: v.cpu().numpy() for k, v in labels.items()}
                    for callback in callbacks:
                        callback.at_iteration_end(host_preds, host_labels,
                                                  avg_meters)
                if self.debug and i >= 10:
                    logger.info("Test was interrupted because of debug mode.")
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

    # -- checkpointing ---------------------------------------------------------

    def save_state_dict(self, path) -> None:
        """A checkpoint at ``path``: the single file by rank 0, or the
        sharded directory by every process."""
        if self.debug:
            logger.info(f"Model was not saved to {path} because of debug mode.")
            return
        kw = dict(model=self.model, optimizer=self.optimizer,
                  global_step=self.global_step,
                  extra=checkpoint_extra(self.process_count))
        if self.sharded_checkpoint:
            _save_ckpt_sharded(path, process_index=self.process_index,
                               process_count=self.process_count, **kw)
        elif self.is_primary:
            _save_ckpt(path, **kw)

    def load_state_dict(self, path) -> None:
        step = load_training_state(path, model=self.model,
                                   optimizer=self.optimizer,
                                   drop_optimizer=self.drop_optimizer)
        if step is not None:
            self.global_step = step
        if self.process_count > 1:
            collectives.broadcast_parameters(self.model.named_parameters())

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
