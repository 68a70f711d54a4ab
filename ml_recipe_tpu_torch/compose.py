"""Composition root (the port of ``ml_recipe_tpu/compose.py``): tokenizer,
model, loss, datasets and collate construction from the parsed flags."""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from .data.collate import make_collate_fun
from .data.datasets import DummyDataset
from .data.labels import labels2id
from .losses import WeightedLoss, build_loss
from .models import QAModel, init_weights, resolve_model_config
from .models.encoder import Embedding, Linear
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
    train: bool = False,
    quantize: str = "off",
) -> Tuple[QAModel, object]:
    """Build ``(model, tokenizer)``: f32 params from a seeded
    ``torch.Generator``, then the optional single-file ``checkpoint``; the
    compute dtype is ``--compute_dtype``, the LayerNorm ``--ln_impl``. When
    ``train``, the model is in training mode (dropout on) and every param
    stays f32 (the optimizer's master weights). Otherwise it is in eval
    mode and the Linear and Embedding params are cast to the compute dtype
    once, so their cast at each use is a no-op.

    ``quantize='int8'`` (serving only): after the checkpoint is restored and
    before that cast, the f32 weights are converted by
    ``quant.quantize_model`` (per-channel int8 for every matmul, the JAX
    package's conversion) and the per-layer error summary is logged. The
    checkpoint format never changes.

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
        remat=bool(getattr(model_params, "remat", False)),
        ln_impl=getattr(model_params, "ln_impl", "xla") or "xla",
    )
    init_weights(model, torch.Generator().manual_seed(rng_seed))
    if checkpoint is not None:
        from .train.checkpoint import load_state_dict

        load_state_dict(model, checkpoint)
    if quantize not in (None, "off"):
        if train:
            raise ValueError("quantize='int8' is for serving; training keeps "
                             "the float model")
        from .quant import quantize_model

        model, report = quantize_model(model, quantize)
        logger.info(
            "Post-training quantization (%s): %d kernels converted, params "
            "%.1f -> %.1f MB (kernels %.1f -> %.1f MB), worst per-layer "
            "relative RMS error %.4f.",
            quantize, report["n_quantized"], report["orig_bytes"] / 1e6,
            report["quant_bytes"] / 1e6, report["orig_kernel_bytes"] / 1e6,
            report["quant_kernel_bytes"] / 1e6, report["max_rel_rms_err"])
    model.train(train)
    if not train:
        for module in model.modules():
            if isinstance(module, (Linear, Embedding)):
                module.to(module.compute_dtype)
    logger.info("Model %s built on %s in %s (%d layers, LayerNorm %s%s%s).",
                model_params.model, dev, dtype, cfg.num_layers, model.ln_impl,
                ", int8" if model.quantize == "int8" else "",
                ", remat" if model.transformer.remat else "")
    return model, tokenizer


def init_loss(params, train_weights=None) -> WeightedLoss:
    """Loss zoo selection + per-head weights (init.py:18-40)."""
    loss = build_loss(params, train_weights)
    logger.info(f"Used loss function for classification: {params.loss}.")
    return loss


def init_datasets(params, *, tokenizer=None, rng=None):
    """``(train_dataset, test_dataset, weights)``: the ``--dummy_dataset``
    path (10000 train and 1024 test items, as the JAX package builds them).
    The NQ corpus path raises until it is ported."""
    if not getattr(params, "dummy_dataset", False):
        raise NotImplementedError(
            "the NQ corpus input path (RawPreprocessor, SplitDataset) is not "
            "ported to ml_recipe_tpu_torch yet (ROADMAP.md queue 1, 'NQ "
            "corpus input path'); pass --dummy_dataset")
    logger.warning("Dummy dataset is used to train model.")
    common = dict(data_dir=None, tokenizer=tokenizer, indexes=None,
                  max_seq_len=params.max_seq_len,
                  max_question_len=params.max_question_len, rng=rng)
    weights = {"label_weights": None, "sampler_weights": None}
    return (DummyDataset(**common), DummyDataset(dataset_len=1024, **common),
            weights)


def init_collate_fun(tokenizer, *, max_seq_len: Optional[int] = None,
                     return_items: bool = False):
    """Bind tokenizer + static shape (init.py:204-205)."""
    return make_collate_fun(tokenizer, max_seq_len=max_seq_len,
                            return_items=return_items)
