"""Joining a world of processes for data parallelism (the port of
``ml_recipe_tpu/parallel/dist.py``).

The JAX package joins one process per host through
``jax.distributed.initialize``; the port joins one process per GPU through
``torch.distributed.init_process_group``, from the same flags:
``--dist_world_size`` W, ``--local_rank`` r (the process id) and
``--dist_init_method tcp://HOST:PORT`` (``scripts/worker.sh`` maps the
launcher's ``MASTER_IP``/``MASTER_PORT``/``WORLD_SIZE``/``LOCAL_RANK``
onto them).

- Rank r runs on ``cuda:(r % torch.cuda.device_count())`` unless the
  device names its index (:func:`rank_device`); several ranks may share a
  card.
- The backend (:func:`resolve_backend`): the JAX flag's ``xla`` means NCCL
  for a CUDA device and gloo for the CPU; ``nccl`` means NCCL. A caller may
  ask for ``gloo`` on CUDA tensors as a function argument (two ranks on one
  card, where NCCL refuses a device twice).
- Nothing falls back: a failed init raises, and no path switches to gloo or
  to the CPU on its own. Every collective runs under the process group's
  ``timeout`` (:data:`TIMEOUT_S`), so a dead peer ends the run with an
  error instead of a hang.

At world size 1 :func:`initialize_from_params` does nothing, and
:func:`process_index`, :func:`process_count` and :func:`barrier` answer
for one process. The launcher's environment is read by
``scripts/worker.sh``, not here (no entry point joins from it).

The rendezvous and :func:`barrier` run inside watchdog frames
(``resilience/watchdog.py``), with the ``dist.rendezvous`` and
``dist.barrier`` fault sites inside them.

The elastic supervisor (``resilience/supervisor.py``) sets
``MLRT_ELASTIC_WORLD=<size>:<rank>`` in every child: the live world after
a host loss, which :func:`initialize_from_params` joins instead of the
declared one (:func:`elastic_world_override`), at the same
``--dist_init_method``; a shrunk world of 1 joins nothing.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..resilience import watchdog as watchdog_mod
from ..resilience.coordination import ELASTIC_WORLD_ENV
from ..resilience.faults import fire as _fault

logger = logging.getLogger(__name__)

# seconds any collective may wait for its peers before the run fails
TIMEOUT_S = 600.0
BACKENDS = ("xla", "nccl", "gloo")


def elastic_world_override() -> Optional[Tuple[int, int]]:
    """``(world_size, process_id)`` from :data:`ELASTIC_WORLD_ENV`
    (``"<size>:<rank>"``), set per attempt by the elastic supervisor so a
    restarted child joins the CURRENT live world instead of the declared
    one. None when unset; a malformed value is a hard error: a child
    silently joining the wrong world is the one thing an elastic restart
    must never do."""
    raw = os.environ.get(ELASTIC_WORLD_ENV)
    if not raw:
        return None
    try:
        size_s, rank_s = raw.split(":")
        size, rank = int(size_s), int(rank_s)
    except ValueError:
        raise ValueError(
            f"malformed {ELASTIC_WORLD_ENV}={raw!r}; expected "
            f"'<world_size>:<process_id>' (e.g. '2:0').") from None
    if size < 1 or not (0 <= rank < size):
        raise ValueError(
            f"inconsistent {ELASTIC_WORLD_ENV}={raw!r}: need "
            f"world_size >= 1 and 0 <= process_id < world_size.")
    return size, rank


def live_world(params) -> Tuple[int, int]:
    """``(world_size, rank)`` this process runs in: the elastic override
    when set, else ``--dist_world_size`` and ``--local_rank`` (rank 0 when
    alone)."""
    override = elastic_world_override()
    if override is not None:
        return override
    world = int(getattr(params, "dist_world_size", 1) or 1)
    return world, max(int(getattr(params, "local_rank", -1)), 0)


def resolve_backend(backend: Optional[str], device) -> str:
    """The process group's backend for ``--dist_backend`` on ``device``:
    ``xla`` (the JAX flag's default) or None is NCCL on CUDA and gloo on
    the CPU; ``nccl`` needs a CUDA device; ``gloo`` is taken as asked."""
    dev = torch.device(device)
    backend = (backend or "xla").lower()
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}; got "
                         f"{backend!r}")
    if backend == "xla":
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device; got "
                         f"{str(dev)!r} (pass --device cuda, or run the CPU "
                         f"with --dist_backend xla, which is gloo there)")
    return backend


def rank_device(device: Union[None, str, torch.device],
                rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda`` without an index becomes
    ``cuda:(rank % device_count)``; any other device is kept."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError(
                "rank device 'cuda' requested, but no CUDA device is visible; "
                "pass --device cpu to run the ranks on the CPU on purpose")
        dev = torch.device("cuda", rank % count)
    return dev


def initialize_distributed(*, init_method: str,
                           world_size: int, rank: int, backend: str,
                           device=None,
                           timeout_s: float = TIMEOUT_S) -> None:
    """Join the world of ``world_size`` processes as ``rank`` over
    ``backend`` (``nccl`` or ``gloo``), rendezvous at ``init_method``
    (``tcp://HOST:PORT``). An NCCL group binds ``device`` and creates its
    communicator now, so a failed NCCL init raises here. A process that is
    already in a world of this size at this rank keeps it, whatever its
    backend (a caller that joined over gloo on purpose, before the CLI
    asks for NCCL, is logged); joining another world raises."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in a world of {world_size}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) == (world_size, rank):
            if dist.get_backend() != backend:
                logger.info("Keeping the world this process already joined "
                            "over %s (rank %d of %d); %s was asked for.",
                            dist.get_backend(), rank, world_size, backend)
            return
        raise RuntimeError(
            f"already in a world of {dist.get_world_size()} as rank "
            f"{dist.get_rank()} over {dist.get_backend()}; cannot join "
            f"{world_size} as {rank} over {backend}")
    kwargs = {}
    if backend == "nccl":
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device; got "
                             f"{str(dev)!r}")
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    logger.info("Joining a world of %d processes as rank %d over %s at %s "
                "(collectives time out after %gs).", world_size, rank,
                backend, init_method, timeout_s)
    # a rendezvous that never completes (one rank missing) is the canonical
    # startup hang: the drill site fires inside the watchdog frame, which
    # gets 8x the step-scale timeout (a cold start waits for the slowest
    # rank legitimately)
    wd = watchdog_mod.current()
    with watchdog_mod.watched(f"distributed rendezvous {init_method}",
                              wd.timeout * 8 if wd is not None else None):
        _fault("dist.rendezvous")
        dist.init_process_group(
            backend=backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
            **kwargs)
    logger.info("Joined: rank %d of %d over %s.", rank, world_size, backend)


def initialize_from_params(params, device=None) -> Optional[torch.device]:
    """Join the world the trainer flags declare (``--dist_world_size``,
    ``--local_rank``, ``--dist_init_method``, ``--dist_backend``) on this
    rank's device (:func:`rank_device` of ``device``, else ``--device``);
    returns that device, or None at world size 1, where nothing is
    joined. The elastic supervisor's world override wins over the flags
    (:func:`elastic_world_override`): after a host loss the survivors
    re-form a smaller world, and the flags still describe the original
    one."""
    override = elastic_world_override()
    if override is not None:
        world_size, local_rank = override
        logger.warning(
            "ELASTIC: world override %s -> joining as process %d/%d (params "
            "declared %s).", ELASTIC_WORLD_ENV, local_rank, world_size,
            getattr(params, "dist_world_size", 1))
    else:
        world_size = int(getattr(params, "dist_world_size", 1) or 1)
        local_rank = int(getattr(params, "local_rank", -1))
    if world_size <= 1:
        return None
    if local_rank < 0:
        raise ValueError(f"--dist_world_size {world_size} needs --local_rank "
                         f"(this process's rank, 0..{world_size - 1})")
    dev = rank_device(device if device is not None
                      else getattr(params, "device", None), local_rank)
    initialize_distributed(
        init_method=params.dist_init_method,
        world_size=world_size, rank=local_rank,
        backend=resolve_backend(getattr(params, "dist_backend", None), dev),
        device=dev)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """Rank 0: the reference's ``local_rank in [-1, 0]`` gate."""
    return process_index() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (no-op alone). The
    ``dist.barrier`` fault site fires first, alone too, inside a watchdog
    frame: a peer that never arrives takes the watchdog's path (stack dump,
    exit 87, supervised restart) instead of wedging the world."""
    with watchdog_mod.watched(f"barrier:{name}"):
        _fault("dist.barrier")
        if process_count() == 1:
            return
        logger.debug("barrier %s", name)
        dist.barrier()


def shutdown() -> None:
    """Leave the world (no-op when not in one)."""
    if is_initialized():
        dist.destroy_process_group()
