"""Offline metric evaluation entry point (the port of
``ml_recipe_tpu/cli/train_metrics.py``).

Usage::

    python -m ml_recipe_tpu_torch.cli.train_metrics -c config/test_bert.cfg \\
        --checkpoint last.ch --vocab_file V [--device cpu --model bert-tiny ...]

Re-runs the trainer's test loop with the MAP and accuracy callbacks from a
saved checkpoint, on the train split and then on the test split (reference
train_metrics.py:13-55). The predictor, trainer and model parsers all read
the command line; trainer values fill the keys the predictor parser lacks.
The eval batches are the train run's: ``--batch_size`` rows (pass the
run's ``--test_batch_size``) under the same ``--length_buckets``, so the
test split's "Test metrics" line reproduces the train run's last one digit
for digit. No quantization, as in the JAX package: a ``--quantize`` other
than ``off`` is refused.
"""

from __future__ import annotations

import logging
import os
import sys

from ..compose import init_collate_fun, init_datasets, init_loss, init_model
from ..config.parser import (
    check_predict_flags,
    get_model_parser,
    get_params,
    get_predictor_parser,
    get_trainer_parser,
)
from ..data.labels import labels2id
from ..train.callback import AccuracyCallback, MAPCallback
from ..train.trainer import Trainer
from ..utils.logging import show_params

logger = logging.getLogger(__name__)


def run_test(model, loss, collate_fun, dataset, params) -> dict:
    """A test-only ``Trainer`` over ``dataset`` (train_metrics.py:13-34)."""
    trainer = Trainer(
        model=model,
        loss=loss,
        collate_fun=collate_fun,
        test_dataset=dataset,
        test_batch_size=params.batch_size,
        n_jobs=params.n_jobs,
        debug=params.debug,
        length_buckets=params.length_buckets,
    )
    try:
        return trainer.test(-1, callbacks=[MAPCallback(list(labels2id.keys())),
                                           AccuracyCallback()])
    finally:
        trainer.close()


def main(params, model_params) -> dict:
    """The test split's and the train split's metrics of ``--checkpoint``."""
    show_params(model_params, "model")
    show_params(params, "test")
    check_predict_flags(params, model_params)
    if params.quantize != "off":
        raise ValueError(
            f"cli.train_metrics evaluates the float model, as the JAX "
            f"package's does; --quantize {params.quantize} is for "
            f"cli.validate")
    model, tokenizer = init_model(model_params, checkpoint=params.checkpoint)
    train_dataset, test_dataset, weights = init_datasets(
        params, tokenizer=tokenizer, clear=False)
    loss = init_loss(params, weights)
    collate_fun = init_collate_fun(tokenizer, max_seq_len=params.max_seq_len)

    logger.info("Train dataset validation..")
    train_metrics = run_test(model, loss, collate_fun, train_dataset, params)
    logger.info("Test dataset validation..")
    test_metrics = run_test(model, loss, collate_fun, test_dataset, params)
    return {"train": train_metrics, "test": test_metrics}


def parse(argv=None):
    """``(params, model_params)``: the predictor parser's values, with the
    trainer parser's filling the keys it lacks (train_metrics.py:59 parsed
    the predictor flags only, yet the loss and datasets read trainer
    flags)."""
    _, (params, trainer_params, model_params) = get_params(
        (get_predictor_parser, get_trainer_parser, get_model_parser), argv)
    for key, value in vars(trainer_params).items():
        if not hasattr(params, key):
            setattr(params, key, value)
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    return params, model_params


def cli(argv=None) -> dict:
    params, model_params = parse(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(sys.stderr)])
    return main(params, model_params)


if __name__ == "__main__":
    cli()
