"""Composition root (the serving part of ``ml_recipe_tpu/compose.py``):
tokenizer and model construction from the parsed model flags."""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from .data.labels import labels2id
from .models import QAModel, init_weights, resolve_model_config
from .tokenizer import Tokenizer
from .utils.device import resolve_device

logger = logging.getLogger(__name__)


def init_tokenizer(model_params):
    """First-party tokenizer over ``--vocab_file`` (the HF tokenizer
    fallback of the JAX package needs a vocab download and is not ported)."""
    model_name = model_params.model.split("-")[0]
    if model_params.vocab_file is None:
        raise ValueError(
            "ml_recipe_tpu_torch needs --vocab_file (generate one with "
            "ml_recipe_tpu_torch.tokenizer.write_synthetic_bert_vocab)")
    if not os.path.exists(model_params.vocab_file):
        raise FileNotFoundError(
            f"vocab_file {model_params.vocab_file!r} does not exist. Generate "
            f"one (ml_recipe_tpu_torch.tokenizer.write_synthetic_bert_vocab) "
            f"or fix the path.")
    return Tokenizer(
        model_name=model_name,
        vocab_file=model_params.vocab_file,
        merges_file=model_params.merges_file,
        lowercase=model_params.lowercase,
        handle_chinese_chars=model_params.handle_chinese_chars,
    )


def init_model(
    model_params,
    *,
    checkpoint: Optional[str] = None,
    rng_seed: int = 0,
    device=None,
) -> Tuple[QAModel, object]:
    """Build ``(model, tokenizer)``: random init from a seeded
    ``torch.Generator``, then the optional single-file ``checkpoint``.

    ``device`` (else ``model_params.device``, else ``cuda``) must exist:
    without CUDA the default raises instead of running on the CPU."""
    dev = resolve_device(device or getattr(model_params, "device", None))
    tokenizer = init_tokenizer(model_params)
    cfg = resolve_model_config(model_params, num_labels=len(labels2id))
    dtype = (torch.bfloat16
             if getattr(model_params, "compute_dtype", "bfloat16") == "bfloat16"
             else torch.float32)
    model = QAModel(
        cfg, dtype=dtype, device=dev,
        attention_impl=getattr(model_params, "flash_attention", "auto") or "auto",
    )
    init_weights(model, torch.Generator().manual_seed(rng_seed))
    if checkpoint is not None:
        from .train.checkpoint import load_state_dict

        load_state_dict(model, checkpoint)
    model.eval()
    logger.info("Model %s built on %s in %s (%d layers).", model_params.model,
                dev, dtype, cfg.num_layers)
    return model, tokenizer
