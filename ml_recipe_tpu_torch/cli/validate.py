"""Validation entry point (the port of ``ml_recipe_tpu/cli/validate.py``).

Usage::

    python -m ml_recipe_tpu_torch.cli.validate -c config/validate.cfg \\
        --checkpoint last.ch --vocab_file V [--quantize int8 --ln_impl fused]
        [--device cpu --model bert-tiny ...]

Builds the model from ``--checkpoint`` (``--quantize int8`` converts the
restored float weights to per-channel int8, the serving engine's
conversion), a ``ChunkDataset`` over the held-out split of the preprocessed
corpus (``compose.init_validation_dataset``), and runs the ``Predictor``
over every chunk (``--limit`` stops early), then logs the documents, chunks
and candidates it scored and its chunks per second. ``--sequence_packing
on`` scores packed rows (``--pack_max_segments``, ``--pack_splitting
fill``, ``--pack_min_fragment``; ``infer/predictor.py``). A mesh of more
than one device is refused (``check_predict_flags``).
"""

from __future__ import annotations

import logging
import os
import sys

from ..compose import init_collate_fun, init_model, init_validation_dataset
from ..config.parser import (
    check_predict_flags,
    get_model_parser,
    get_params,
    get_predictor_parser,
)
from ..infer.predictor import Predictor
from ..utils.logging import show_params

logger = logging.getLogger(__name__)


def main(params, model_params, *, save_dump: bool = False) -> Predictor:
    """Model, held-out ``ChunkDataset`` and ``Predictor`` from the parsed
    flags; runs the predictor (keeping its per-chunk outputs in
    ``predictor.dump`` when ``save_dump``) and returns it."""
    show_params(model_params, "model")
    show_params(params, "predictor")
    check_predict_flags(params, model_params)
    model, tokenizer = init_model(model_params, checkpoint=params.checkpoint,
                                  quantize=params.quantize)
    val_dataset = init_validation_dataset(params, tokenizer=tokenizer,
                                          clear=False)
    collate_fun = init_collate_fun(tokenizer, max_seq_len=params.max_seq_len,
                                   return_items=True)
    predictor = Predictor(
        model,
        collate_fun=collate_fun,
        batch_size=params.batch_size,
        n_jobs=params.n_jobs,
        buffer_size=params.buffer_size,
        limit=params.limit,
        length_buckets=params.length_buckets,
        sequence_packing=params.sequence_packing,
        pack_max_segments=params.pack_max_segments,
        pack_splitting=params.pack_splitting,
        pack_min_fragment=params.pack_min_fragment,
    )
    predictor(val_dataset, save_dump=save_dump)
    s = predictor.stats
    logger.info(
        "Validation: %d of %d documents, %d chunks in %d batches, %d "
        "candidates; %.1f chunks/s (%.2f s), host %.2f ms per batch.",
        s["documents"], len(val_dataset), s["chunks"], s["batches"],
        s["candidates"], s["chunks"] / max(s["seconds"], 1e-9), s["seconds"],
        s["host_ms_per_batch"])
    if predictor._packing:
        logger.info("Sequence packing: %d segments in %d batches of %d rows, "
                    "%d split chunk(s).", s["segments"], s["batches"],
                    params.batch_size, predictor.pack_split_count)
    return predictor


def parse(argv=None):
    """``(params, model_params)`` of the predictor and model parsers."""
    _, (params, model_params) = get_params(
        (get_predictor_parser, get_model_parser), argv)
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    return params, model_params


def cli(argv=None) -> Predictor:
    params, model_params = parse(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(sys.stderr)])
    return main(params, model_params)


if __name__ == "__main__":
    cli()
