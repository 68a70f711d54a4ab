"""Training entry point (the port of ``ml_recipe_tpu/cli/train.py``).

Usage::

    python -m ml_recipe_tpu_torch.cli.train -c config/test_bert.cfg \\
        --vocab_file V --dump_dir D [--device cpu --model bert-tiny ...]

Data parallelism over W processes, one command per rank r (the JAX
package's contract, which ``scripts/worker.sh`` maps from the launcher's
environment)::

    python -m ml_recipe_tpu_torch.cli.train -c config/test_bert.cfg ... \\
        --dist_world_size W --local_rank r --dist_init_method tcp://HOST:PORT

Parses the trainer and model flags (the JAX package's names and defaults,
plus ``--device``), refuses the flags of subsystems the port lacks
(``check_train_flags``), writes ``trainer.cfg``/``model.cfg`` into the
experiment directory, builds model, datasets, loss and ``Trainer``, and runs
``trainer.train(after_epoch_funcs=[save_last, save_each, test_fun])``.
Without ``--dummy_dataset`` the datasets come from the NQ corpus at
``--data_path``, preprocessed into ``--processed_data_path`` (cleared
first with ``--clear_processed``).
``KeyboardInterrupt`` or ``SIGTERM`` saves ``interrupt.ch``.

With ``--dist_world_size`` W > 1 each process joins the world before any
CUDA use (NCCL on CUDA, gloo with ``--device cpu``; ``parallel/dist.py``)
and runs on ``cuda:(r % device count)``; rank 0 alone writes the log file,
``trainer.cfg``/``model.cfg``, the TensorBoard events and the single-file
checkpoints, and prepares the dataset while the others wait. The step and
its semantics are the trainer's (``train/trainer.py``).
"""

from __future__ import annotations

import functools
import logging
import os
import signal
import sys
import threading
from datetime import datetime

from ..compose import (
    init_collate_fun,
    init_loss,
    init_model,
    init_shared_datasets,
)
from ..config.parser import (
    check_train_flags,
    get_model_parser,
    get_params,
    get_trainer_parser,
    write_config_file,
)
from ..data.labels import labels2id
from ..parallel import dist as pdist
from ..train.callback import AccuracyCallback, MAPCallback, SaveBestCallback
from ..train.trainer import Trainer
from ..utils.device import resolve_device
from ..utils.seed import set_seed

logger = logging.getLogger(__name__)


def build_trainer(params, model_params) -> Trainer:
    """Model, datasets, loss and ``Trainer`` from the parsed flags, resumed
    from ``--last`` when given; in a data-parallel world, on this rank's
    device."""
    check_train_flags(params, model_params)
    device = resolve_device(
        pdist.rank_device(params.device, pdist.process_index())
        if pdist.process_count() > 1 else params.device)
    rng_pool = set_seed(params.seed)
    data_rng = rng_pool.host_rng("chunk_sampling") if rng_pool else None
    seed = params.seed if params.seed is not None else 0

    model, tokenizer = init_model(model_params, rng_seed=seed, device=device,
                                  train=True)
    train_dataset, test_dataset, train_weights = init_shared_datasets(
        params, tokenizer=tokenizer, clear=params.clear_processed,
        rng=data_rng)
    trainer = Trainer(
        model=model,
        loss=init_loss(params, train_weights),
        collate_fun=init_collate_fun(tokenizer, max_seq_len=params.max_seq_len),
        trainer_params=params,
        train_dataset=train_dataset,
        test_dataset=test_dataset,
        writer_dir=params.dump_dir / f"board/{params.experiment_name}",
        n_epochs=params.n_epochs,
        train_batch_size=params.train_batch_size,
        test_batch_size=params.test_batch_size,
        batch_split=params.batch_split,
        n_jobs=params.n_jobs,
        warmup_coef=params.warmup_coef,
        max_grad_norm=params.max_grad_norm,
        train_weights=train_weights,
        drop_optimizer=params.drop_optimizer,
        debug=params.debug,
        seed=seed,
        length_buckets=params.length_buckets,
        device_prefetch=params.device_prefetch,
        log_every=params.log_every,
        sharded_checkpoint=params.sharded_checkpoint,
    )
    if params.last is not None:
        trainer.load_state_dict(params.last)
    return trainer


def train(trainer: Trainer, params) -> Trainer:
    """``trainer.train`` with the after-epoch hooks (save_last, save_each,
    test); ``KeyboardInterrupt`` or ``SIGTERM`` saves ``interrupt.ch``."""
    exp_dir = params.dump_dir / params.experiment_name

    def save_last(*args, **kwargs):
        trainer.save_state_dict(exp_dir / "last.ch")

    def save_each(epoch_i):
        trainer.save_state_dict(exp_dir / f"epoch_{epoch_i}.ch")

    test_fun = functools.partial(trainer.test, callbacks=[
        MAPCallback(list(labels2id.keys())),
        AccuracyCallback(),
        SaveBestCallback(params),
    ])

    def _sigterm_to_interrupt(signum, frame):
        raise KeyboardInterrupt(f"signal {signum}")

    on_main_thread = threading.current_thread() is threading.main_thread()
    if on_main_thread:
        prev_handler = signal.signal(signal.SIGTERM, _sigterm_to_interrupt)
    try:
        trainer.train(after_epoch_funcs=[save_last, save_each, test_fun])
    except KeyboardInterrupt:
        # disarm first: a second SIGTERM must not abort the save below
        if on_main_thread:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        logger.error("Training process was interrupted.")
        trainer.save_state_dict(exp_dir / "interrupt.ch")
    finally:
        if on_main_thread:
            signal.signal(signal.SIGTERM, prev_handler)
        trainer.close()
    return trainer


def run_worker(params, model_params) -> Trainer:
    """Build, then train; returns the trainer."""
    return train(build_trainer(params, model_params), params)


def main(argv=None) -> Trainer:
    """Parse, set up logging and the cfg files (rank 0), join the world
    (``--dist_world_size`` > 1), build and train; leaves the world at the
    end and returns the trainer."""
    (parser, model_parser), (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser), argv)
    exp_dir = params.dump_dir / params.experiment_name
    os.makedirs(exp_dir, exist_ok=True)
    # the reference's local_rank in [-1, 0] gate
    primary = params.dist_world_size <= 1 or params.local_rank in (-1, 0)
    params.log_file = (
        exp_dir / f'{datetime.now().strftime("%d-%m-%Y_%H-%M-%S")}.log'
        if primary else None)
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    handlers = [logging.StreamHandler(sys.stderr)]
    if primary:
        handlers.append(logging.FileHandler(params.log_file, mode="w"))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers)
    if primary:
        write_config_file(parser, params, exp_dir / "trainer.cfg")
        write_config_file(model_parser, model_params, exp_dir / "model.cfg")
    try:
        # join before any CUDA use: NCCL binds the rank's device
        pdist.initialize_from_params(params)
        return run_worker(params, model_params)
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main()
