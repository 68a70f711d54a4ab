"""Optimizers, LR schedule and gradient clipping (the port of
``ml_recipe_tpu/train/optim.py``).

The JAX package builds one optax chain per ``--optimizer``
(``build_optimizer``); each class here is that chain over a dict of f32
parameters, updated in place with ``torch._foreach_*`` ops in the chain's
order and rounding, with ``lr = schedule(count)`` read BEFORE the count
advances (step 0 trains at ``schedule(0)``, 0 under warmup):

- :class:`AdamW` (``adam``): HF ``AdamW(correct_bias=False)`` moments with
  ``eps=1e-6``, ``add_decayed_weights`` under ``no_decay_mask``, then
  ``scale_by_learning_rate``::

      mu = b1*mu + (1-b1)*g;  nu = b2*nu + ((1-b2)*g)*g;  u = mu/(sqrt(nu)+eps)
      u = u + wd*p   (decaying leaves only);  p = p + u*(-lr)

  ``torch.optim.AdamW`` is not a substitute: it always bias-corrects and
  decays as ``p *= 1 - lr*wd``;
- :class:`AdaMod` (``adamod``): Adam moments with a bias-corrected step
  size bounded by its own beta3 EMA, and decoupled decay::

      s = lr*sqrt(1-b2^t)/(1-b1^t) / (sqrt(nu)+1e-8)
      ema = b3*ema + (1-b3)*s;  p = p + (-min(s, ema)*mu - wd*lr*p)

With ``--finetune``, ``trainable_mask`` names the modules that train
(``--finetune_transformer|position|position_reg|class``); the others get
``requires_grad_(False)``, so autograd computes no gradient for them and
the optimizer holds no state for them and never touches them. The JAX
package reaches the same result by zeroing their gradients and wrapping
the chain in ``masked(tx, trainable)`` + ``masked(set_to_zero, frozen)``.

:func:`clip_by_global_norm_` is the train step's clip, ``g * c / max(norm,
c)`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``).

``flax_state`` / ``load_flax_state`` read and write each chain's optax
state-dict layout (the masked wrapper included, a frozen leaf's moments as
``{}``), so checkpoints cross between the packages.

ZeRO-1 (``zero``, a ``parallel.sharding.Zero1``; the JAX trainer's
``--optimizer_sharding zero1`` step at ``trainer.py:1598-1624``): a rank
keeps the moments of its padded slice of each planned parameter only
(small parameters stay whole). The step runs the same elementwise chain on
the slices of the (all-reduced, clipped) gradient and of the parameter,
then all-gathers the updated slices over the ``data`` group into the
whole parameter on every rank, so the result is the unsharded step's bit
for bit. ``flax_state`` gathers the padded moments (the layout the JAX
package stores at the same mesh; ``local=True`` gives each rank's pieces
for a sharded checkpoint instead), and ``load_flax_state`` crops or
zero-fills any saved layout, padded at any data size or whole, onto this
one.

Tensor parallelism (``tp``, a ``parallel.sharding.ModelSplit``): the
parameters a ``model`` axis splits are this rank's slices, and so are
their moments (and, under ZeRO-1, the ``data`` slices of those). The
clip sums the squares of those leaves over the ``model`` group and counts
a leaf every rank holds whole once (the JAX package's global norm over
the whole arrays); ``flax_state`` gathers the group's slices into whole
leaves (``local``: this rank's pieces, bounded in the whole leaf), and
``load_flax_state`` keeps this rank's slice of any saved leaf.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.convert import from_jax_params, jax_path, to_jax_params
from ..parallel.sharding import ModelSplit, Zero1

logger = logging.getLogger(__name__)


def linear_warmup_schedule(lr: float, num_warmup_steps: int,
                           num_training_steps: int) -> Callable[[int], float]:
    """LR(step): step/warmup * lr, then linear decay to 0 (HF semantics),
    in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < num_warmup_steps:
            factor = s / f32(max(num_warmup_steps, 1))
        else:
            factor = max((f32(num_training_steps) - s)
                         / f32(max(num_training_steps - num_warmup_steps, 1)),
                         f32(0.0))
        return float(f32(lr) * f32(factor))

    return schedule


def constant_schedule(lr: float) -> Callable[[int], float]:
    value = float(np.float32(lr))
    return lambda step: value


def param_path_mask(names: Iterable[str],
                    predicate: Callable[[Sequence[str]], bool]
                    ) -> Dict[str, bool]:
    """The shared walk of every per-parameter boolean mask:
    ``predicate(path)`` over each parameter's flax path names
    (``models.convert.jax_path``)."""
    return {name: bool(predicate(jax_path(name))) for name in names}


def no_decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True where weight decay applies: everything except biases and any
    parameter under a ``layer_norm`` module (reference init.py:125-129)."""
    return param_path_mask(names, lambda path: not (
        path[-1] == "bias" or any("layer_norm" in p for p in path)))


def trainable_mask(names: Iterable[str],
                   trainer_params) -> Optional[Dict[str, bool]]:
    """Fine-tune module selection (reference init.py:85-123): None unless
    ``finetune``; then True for the parameters under the flagged roots.
    Raises ``AttributeError`` when no module is named."""
    if not getattr(trainer_params, "finetune", False):
        return None
    roots = set()
    if getattr(trainer_params, "finetune_transformer", False):
        roots.add("transformer")
    if getattr(trainer_params, "finetune_position", False):
        roots.add("position_outputs")
    if getattr(trainer_params, "finetune_position_reg", False):
        roots.update(("reg_start", "reg_end"))
    if getattr(trainer_params, "finetune_class", False):
        roots.add("classifier")
    if not roots:
        raise AttributeError("Specify at least one module for fine-tuning.")
    return param_path_mask(names, lambda path: path[0] in roots)


def _split_squares(sq: torch.Tensor, sharded: Sequence[bool],
                   model_sum: Callable) -> torch.Tensor:
    """``[1]``: the sum of the per-leaf squares ``sq``, those of the
    leaves a ``model`` group splits (``sharded``) summed over the group
    (``model_sum``, in place), the others counted once."""
    mask = torch.tensor(list(sharded), dtype=torch.bool, device=sq.device)
    return model_sum(sq[mask].sum().reshape(1)) + sq[~mask].sum()


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sum_over: Optional[Callable] = None,
                         sharded: Optional[Sequence[bool]] = None,
                         model_sum: Optional[Callable] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``
    (optax ``clip_by_global_norm``); returns the f32 global norm. No host
    synchronisation. ``sum_over`` (a pipeline stage: its leaves are a part
    of the model's) sums a tensor over the parts in place: the squares of
    every part's leaf norms are summed before the root. ``model_sum``
    (tensor parallelism) sums a tensor over the ``model`` group in place:
    the squares of the leaves ``sharded`` flags are summed over it, the
    others' counted once."""
    norms = torch._foreach_norm(grads)
    if sum_over is None and model_sum is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        sq = torch.stack(norms).square()
        sq = (sq.sum().reshape(1) if model_sum is None
              else _split_squares(sq, sharded, model_sum))
        if sum_over is not None:
            sq = sum_over(sq)
        norm = sq.sqrt()[0]
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


@torch.no_grad()
def clip_sliced_(grads: Dict[str, torch.Tensor], zero: Zero1,
                 max_norm: float,
                 sum_over: Optional[Callable] = None) -> torch.Tensor:
    """:func:`clip_by_global_norm_` of the whole gradient on a ZeRO-1 rank
    that holds, by name, its padded slices of the sharded leaves and the
    whole other leaves (the bucketed exchange's result): the slices' sum of
    squares is summed over the ``data`` group (the pad region is zeros),
    the whole leaves' added once, and with ``sum_over`` the total summed
    over a pipeline's stages. Scales ``grads`` in place; returns the f32
    global norm. (Bucketing is inert on a ``model`` mesh, so no slice here
    is a ``model`` slice.)"""
    sliced = [g for n, g in grads.items() if zero.sharded(n)]
    whole = [g for n, g in grads.items() if not zero.sharded(n)]
    device = next(iter(grads.values())).device
    sq = torch.zeros(1, dtype=torch.float32, device=device)
    if sliced:
        sq += torch.stack(torch._foreach_norm(sliced)).square().sum()
    dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=zero.group)
    if whole:
        sq += torch.stack(torch._foreach_norm(whole)).square().sum()
    if sum_over is not None:
        sq = sum_over(sq)
    norm = sq.sqrt()[0]
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(list(grads.values()), scale)
    return norm


def _update_moments(mus: List[torch.Tensor], nus: List[torch.Tensor],
                    gs: List[torch.Tensor], b1: float, b2: float) -> None:
    """Both chains' moments, in place, in their rounding:
    ``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu + ((1-b2)*g)*g``."""
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - b1))
    sq = torch._foreach_mul(gs, 1.0 - b2)
    torch._foreach_mul_(sq, gs)
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, sq)


class _Chain:
    """What both chains share: the trainable f32 parameters by name, the
    schedule, the decay mask, and the optax layout around the core state
    (``frozen`` is None without ``--finetune``, else the frozen names).
    ``stage_local``: the chain holds one pipeline stage's parameters, so
    :meth:`flax_state` is that part of the model's tree and
    :meth:`load_flax_state` takes that part of a whole one. ``tp``: the
    rank's ``ModelSplit`` under a ``model`` axis (its split parameters are
    slices)."""

    stage_local = False

    def __init__(self, params: Dict[str, torch.nn.Parameter], *,
                 schedule: Callable[[int], float], weight_decay: float,
                 frozen: Optional[Sequence[str]] = None,
                 zero: Optional[Zero1] = None,
                 tp: Optional[ModelSplit] = None):
        self.params = dict(params)
        self.zero = zero
        self.tp = tp
        for name, p in self.params.items():
            if p.dtype != torch.float32:
                raise ValueError(f"{name}: the optimizer updates f32 master "
                                 f"weights; got {p.dtype}")
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.frozen = None if frozen is None else tuple(frozen)
        self.decay = no_decay_mask(self.params)

    def _zeros(self) -> Dict[str, torch.Tensor]:
        return {n: torch.zeros_like(self._local(n, p.detach()))
                for n, p in self.params.items()}

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole tensor of parameter ``name``."""
        return t if self.zero is None else self.zero.local(name, t)

    def _views(self, grads: Dict[str, torch.Tensor], local: bool = False):
        """``(names, params, grads)`` the chain updates: the parameters
        themselves, or under ZeRO-1 copies of this rank's slices (with
        ``local``, ``grads`` already holds this rank's parts)."""
        names = list(self.params)
        return (names, [self._local(n, self.params[n].detach()) for n in names],
                [grads[n] if local else self._local(n, grads[n])
                 for n in names])

    def _publish(self, names, ps) -> None:
        """Under ZeRO-1, every rank's updated slices into the whole
        parameters (the step's all-gather over ``data``)."""
        if self.zero is None:
            return
        for name, piece in zip(names, ps):
            if self.zero.sharded(name):
                p = self.params[name]
                p.copy_(self.zero.unpad(name, self.zero.gather(name, piece),
                                        p.shape))

    def state_tensors(self) -> List[torch.Tensor]:
        """Every moment tensor this rank holds."""
        return [t for moments in self._moments().values()
                for t in moments.values()]

    def lr(self) -> float:
        """The learning rate the next ``step`` applies."""
        return self.schedule(self.schedule_count)

    def _decaying(self, names) -> List[int]:
        return [i for i, n in enumerate(names) if self.decay[n]]

    # -- the optax state-dict layout ------------------------------------------

    def _tree(self, moments: Dict[str, torch.Tensor], copy: bool,
              local: bool = False) -> dict:
        """A moment dict as the flax tree of the whole model: a frozen
        leaf is ``{}`` (optax ``MaskedNode``). Under ZeRO-1 a planned
        leaf is the gathered padded whole, or with ``local`` this rank's
        ``LocalPiece``; under a ``model`` axis a split leaf is the group's
        slices gathered whole, or with ``local`` this rank's piece."""
        zero, tp = self.zero, self.tp
        if not local:
            if zero is not None:
                moments = {n: zero.gather(n, m) if zero.sharded(n) else m
                           for n, m in moments.items()}
            if tp is not None:
                moments = {n: tp.gather(n, m) for n, m in moments.items()}
        tree = to_jax_params(moments, copy=copy)
        if local and (zero is not None or tp is not None):
            for name in moments:
                *parents, leaf = jax_path(name)
                node = tree
                for part in parents:
                    node = node[part]
                if zero is not None and zero.sharded(name):
                    node[leaf] = zero.piece(name, node[leaf])
                elif tp is not None and tp.sharded(name):
                    node[leaf] = tp.piece(name, node[leaf])
        for name in self.frozen or ():
            *parents, leaf = jax_path(name)
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = {}
        return tree

    def _read_tree(self, tree: dict) -> Dict[str, torch.Tensor]:
        """The saved moments on this rank's layout: each leaf (whole in the
        tree; under a ``model`` axis this rank's slice of a split one is
        kept), padded by a ZeRO-1 save at any data size or whole,
        corner-cropped and zero-filled to its parameter's shape (the JAX
        trainer's ``reconcile_state_shapes``; the pad region holds zeros),
        then sliced for this rank."""
        moments = from_jax_params(tree)   # a {} leaf holds nothing
        if self.stage_local:
            moments = {n: m for n, m in moments.items() if n in self.params}
        if set(moments) != set(self.params):
            raise ValueError("checkpoint optimizer moments do not match the "
                             "model's trainable parameters")
        for name, p in self.params.items():
            m = moments[name]
            if self.tp is not None and self.tp.sharded(name):
                m = self.tp.local(name, m, p.shape[self.tp.dims[name]])
            if m.dim() != p.dim():
                raise ValueError(f"{name}: moment shape {tuple(m.shape)} "
                                 f"does not fit parameter shape "
                                 f"{tuple(p.shape)}")
            if m.shape != p.shape:
                m = m[tuple(slice(0, min(a, b))
                            for a, b in zip(m.shape, p.shape))]
                fill = torch.zeros(p.shape, dtype=m.dtype)
                fill[tuple(slice(0, d) for d in m.shape)] = m
                m = fill
            moments[name] = self._local(name, m)
        return moments

    def flax_state(self, *, copy: bool = False, local: bool = False) -> dict:
        """``flax.serialization.to_state_dict`` of the JAX optimizer state:
        the core chain in the outer one-element chain, and under
        ``--finetune`` that in ``chain(masked(tx), masked(set_to_zero))``.
        ``copy``: no leaf shares memory with a live moment. Under ZeRO-1
        every rank of the ``data`` group must call it (it gathers), and
        under a ``model`` axis every rank of the ``model`` group, unless
        ``local``, which leaves each planned or split leaf as this rank's
        piece."""
        core = {"0": self._core_state(copy, local)}
        if self.frozen is None:
            return core
        return {"0": {"inner_state": core}, "1": {"inner_state": {}}}

    @torch.no_grad()
    def load_flax_state(self, state: dict) -> None:
        """Restore from :meth:`flax_state`'s layout (a JAX checkpoint's
        ``optimizer`` entry); raises on another chain or fine-tune set."""
        try:
            if self.frozen is not None:
                state = state["0"]["inner_state"]
            self._load_core(state["0"])
        except (KeyError, TypeError) as exc:
            raise ValueError(
                f"checkpoint optimizer state is not the layout of "
                f"{type(self).__name__}"
                f"{' under --finetune' if self.frozen is not None else ''} "
                f"({exc!r})") from exc


class AdamW(_Chain):
    """``build_optimizer``'s ``adam`` chain over named f32 parameters."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], *,
                 schedule: Callable[[int], float], weight_decay: float,
                 frozen: Optional[Sequence[str]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 zero: Optional[Zero1] = None,
                 tp: Optional[ModelSplit] = None):
        super().__init__(params, schedule=schedule, weight_decay=weight_decay,
                         frozen=frozen, zero=zero, tp=tp)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = self._zeros()
        self.nu = self._zeros()
        self.count = 0           # ScaleByAdamState.count
        self.schedule_count = 0  # ScaleByScheduleState.count

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             local: bool = False) -> float:
        """Apply one update from ``grads`` (f32, by name; with ``local``,
        under ZeRO-1, this rank's parts of them); returns the lr it
        applied."""
        lr = self.lr()
        names, ps, gs = self._views(grads, local)
        mus = [self.mu[n] for n in names]
        nus = [self.nu[n] for n in names]

        _update_moments(mus, nus, gs, self.b1, self.b2)
        den = torch._foreach_sqrt(nus)
        torch._foreach_add_(den, self.eps)
        updates = torch._foreach_div(mus, den)

        decaying = self._decaying(names)
        if self.weight_decay and decaying:
            torch._foreach_add_(
                [updates[i] for i in decaying],
                torch._foreach_mul([ps[i] for i in decaying],
                                   self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(ps, updates)
        self._publish(names, ps)
        self.count += 1
        self.schedule_count += 1
        return lr

    def _moments(self) -> dict:
        return {"mu": self.mu, "nu": self.nu}

    def _core_state(self, copy: bool, local: bool = False) -> dict:
        """``chain(scale_by_adam, masked(add_decayed_weights),
        scale_by_schedule)``."""
        return {"0": {"count": np.asarray(self.count, np.int32),
                      "mu": self._tree(self.mu, copy, local),
                      "nu": self._tree(self.nu, copy, local)},
                "1": {"inner_state": {}},
                "2": {"count": np.asarray(self.schedule_count, np.int32)}}

    def _load_core(self, core: dict) -> None:
        adam, sched = core["0"], core["2"]
        mu, nu = self._read_tree(adam["mu"]), self._read_tree(adam["nu"])
        for name in self.params:
            self.mu[name].copy_(mu[name])
            self.nu[name].copy_(nu[name])
        self.count = int(np.asarray(adam["count"]))
        self.schedule_count = int(np.asarray(sched["count"]))


class AdaMod(_Chain):
    """``build_optimizer``'s ``adamod`` chain (the JAX ``adamod``, from the
    reference's vendored AdaMod) over named f32 parameters."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], *,
                 schedule: Callable[[int], float], weight_decay: float,
                 frozen: Optional[Sequence[str]] = None,
                 b1: float = 0.9, b2: float = 0.999, beta3: float = 0.999,
                 eps: float = 1e-8, zero: Optional[Zero1] = None,
                 tp: Optional[ModelSplit] = None):
        super().__init__(params, schedule=schedule, weight_decay=weight_decay,
                         frozen=frozen, zero=zero, tp=tp)
        self.b1, self.b2, self.beta3, self.eps = b1, b2, beta3, eps
        self.exp_avg = self._zeros()
        self.exp_avg_sq = self._zeros()
        self.exp_avg_lr = self._zeros()
        self.count = 0           # AdaModState.count, also the schedule's

    @property
    def schedule_count(self) -> int:
        return self.count

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             local: bool = False) -> float:
        """Apply one update from ``grads`` (f32, by name; ``local`` as in
        :meth:`AdamW.step`); returns the lr it applied."""
        lr = self.lr()
        f32 = np.float32
        t = f32(self.count + 1)
        # the bias-corrected step size, an f32 scalar as the chain computes it
        bias1 = f32(1) - f32(self.b1) ** t
        bias2 = f32(1) - f32(self.b2) ** t
        step_scale = float(f32(lr) * np.sqrt(bias2) / bias1)
        names, ps, gs = self._views(grads, local)
        ms = [self.exp_avg[n] for n in names]
        vs = [self.exp_avg_sq[n] for n in names]
        es = [self.exp_avg_lr[n] for n in names]

        _update_moments(ms, vs, gs, self.b1, self.b2)
        den = torch._foreach_sqrt(vs)
        torch._foreach_add_(den, self.eps)
        # step_scale / den, divided (not a reciprocal times step_scale)
        size = torch._foreach_mul(den, 0.0)
        torch._foreach_add_(size, step_scale)
        torch._foreach_div_(size, den)
        del den
        torch._foreach_mul_(es, self.beta3)
        torch._foreach_add_(es, torch._foreach_mul(size, 1.0 - self.beta3))
        torch._foreach_minimum_(size, es)
        torch._foreach_mul_(size, ms)
        torch._foreach_neg_(size)                       # the update
        decaying = self._decaying(names)
        if self.weight_decay != 0 and decaying:
            torch._foreach_sub_(
                [size[i] for i in decaying],
                torch._foreach_mul([ps[i] for i in decaying],
                                   float(f32(self.weight_decay) * f32(lr))))
        torch._foreach_add_(ps, size)
        self._publish(names, ps)
        self.count += 1
        return lr

    def _moments(self) -> dict:
        return {"exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq,
                "exp_avg_lr": self.exp_avg_lr}

    def _core_state(self, copy: bool, local: bool = False) -> dict:
        """``AdaModState(count, exp_avg, exp_avg_sq, exp_avg_lr)``."""
        return {"count": np.asarray(self.count, np.int32),
                **{key: self._tree(value, copy, local)
                   for key, value in self._moments().items()}}

    def _load_core(self, core: dict) -> None:
        moments = {key: self._read_tree(core[key])
                   for key in ("exp_avg", "exp_avg_sq", "exp_avg_lr")}
        for key, values in moments.items():
            mine = getattr(self, key)
            for name in self.params:
                mine[name].copy_(values[name])
        self.count = int(np.asarray(core["count"]))


OPTIMIZERS = {"adam": AdamW, "adamod": AdaMod}


def build_optimizer(trainer_params, params: Dict[str, torch.nn.Parameter], *,
                    num_training_steps: int, warmup_coef=None,
                    zero: Optional[Zero1] = None,
                    tp: Optional[ModelSplit] = None) -> _Chain:
    """Optimizer + schedule (reference init.py:134-145, trainer.py:116-126).
    ``warmup_coef``, when given, overrides ``trainer_params.warmup_coef``.
    Under ``--finetune`` the parameters outside :func:`trainable_mask` get
    ``requires_grad_(False)`` here and stay out of the optimizer. ``zero``:
    the ZeRO-1 layout (None: every moment whole); ``tp``: the rank's
    ``ModelSplit`` under a ``model`` axis."""
    name = getattr(trainer_params, "optimizer", "adam")
    if name not in OPTIMIZERS:
        raise ValueError(f"--optimizer {name!r}: choose from "
                         f"{'|'.join(OPTIMIZERS)}")
    if warmup_coef is None:
        warmup_coef = getattr(trainer_params, "warmup_coef", 0.0)
    lr = trainer_params.lr
    if warmup_coef and warmup_coef > 0:
        schedule = linear_warmup_schedule(
            lr, int(num_training_steps * warmup_coef), num_training_steps)
    else:
        schedule = constant_schedule(lr)
    tmask = trainable_mask(params, trainer_params)
    frozen = None
    if tmask is not None:
        frozen = [n for n, trains in tmask.items() if not trains]
        for n in frozen:
            params[n].requires_grad_(False)
        logger.info("Fine-tune: %d of %d parameter tensors train, %d frozen.",
                    len(params) - len(frozen), len(params), len(frozen))
    trainable = {n: p for n, p in params.items()
                 if tmask is None or tmask[n]}
    return OPTIMIZERS[name](trainable, schedule=schedule,
                            weight_decay=trainer_params.weight_decay,
                            frozen=frozen, zero=zero, tp=tp)
