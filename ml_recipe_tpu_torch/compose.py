"""Composition root (the port of ``ml_recipe_tpu/compose.py``): tokenizer,
model, loss, datasets and collate construction from the parsed flags."""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .data.collate import make_collate_fun
from .data.datasets import ChunkDataset, DummyDataset, SplitDataset
from .data.labels import id2labels, labels2id
from .data.preprocessor import RawPreprocessor
from .losses import WeightedLoss, build_loss
from .models import QAModel, init_weights, resolve_model_config
from .models.encoder import Embedding, Linear
from .parallel.dist import barrier, is_primary
from .tokenizer import Tokenizer
from .utils.device import resolve_device

logger = logging.getLogger(__name__)


def init_tokenizer(model_params, *, bpe_dropout: Optional[float] = None):
    """First-party tokenizer over ``--vocab_file`` (the HF tokenizer
    fallback of the JAX package needs a vocab download and is not ported);
    ``bpe_dropout`` (``--bpe_dropout``) drops BPE merges at that rate on
    every encode (roberta vocabularies; the WordPiece tokenizer warns and
    ignores it)."""
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
        dropout=bpe_dropout,
    )


def init_model(
    model_params,
    *,
    checkpoint: Optional[str] = None,
    bpe_dropout: Optional[float] = None,
    rng_seed: int = 0,
    device=None,
    train: bool = False,
    quantize: str = "off",
    mesh=None,
) -> Tuple[QAModel, object]:
    """Build ``(model, tokenizer)``. Weight priority, as in the JAX package:
    the optional ``checkpoint`` (either layout) > ``--hf_checkpoint`` (a
    local HF directory or file, converted onto the encoder by
    ``models.hf_convert``; the heads keep their init) > f32 params from a
    seeded ``torch.Generator``. The tokenizer gets ``bpe_dropout``. The
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

    ``mesh`` (``parallel.mesh.Mesh``): with a ``seq`` axis > 1,
    ``--flash_attention auto`` resolves to ``ring`` (logged), and the model
    runs sequence-parallel over the mesh's ``seq`` ring.

    ``device`` (else ``model_params.device``, else ``cuda``) must exist:
    without CUDA the default raises instead of running on the CPU."""
    dev = resolve_device(device or getattr(model_params, "device", None))
    tokenizer = init_tokenizer(model_params, bpe_dropout=bpe_dropout)
    cfg = resolve_model_config(model_params, num_labels=len(labels2id))
    dtype = (torch.bfloat16
             if getattr(model_params, "compute_dtype", "bfloat16") == "bfloat16"
             else torch.float32)
    attention_impl = getattr(model_params, "flash_attention", "auto") or "auto"
    if attention_impl == "auto" and mesh is not None and mesh.seq_size > 1:
        # a seq axis in the mesh is the long-context request
        attention_impl = "ring"
        logger.info("Mesh has seq:%d — attention_impl auto-selected 'ring' "
                    "(streaming kernels on every hop).", mesh.seq_size)
    model = QAModel(
        cfg, dtype=dtype, device=dev, attention_impl=attention_impl,
        remat=bool(getattr(model_params, "remat", False)),
        ln_impl=getattr(model_params, "ln_impl", "xla") or "xla", mesh=mesh,
    )
    init_weights(model, torch.Generator().manual_seed(rng_seed))
    hf_checkpoint = getattr(model_params, "hf_checkpoint", None)
    if hf_checkpoint:
        from .models.hf_convert import load_pretrained_into

        load_pretrained_into(model, hf_checkpoint)
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


def init_datasets(params, *, tokenizer=None, clear: bool = False, rng=None):
    """``(train_dataset, test_dataset, weights)`` (init.py:148-201).

    ``--dummy_dataset``: 10000 train and 1024 test ``DummyDataset`` items.
    Otherwise the NQ corpus: ``RawPreprocessor`` turns ``--data_path`` into
    one json per example under ``--processed_data_path`` (kept unless
    ``clear``) with the stratified split, and each split becomes a
    ``SplitDataset`` (the test one in test mode). ``--train_label_weights``
    gives the classifier loss the normalised ``1/count`` of each label,
    ``--train_sampler_weights`` each train item the normalised ``1/count``
    of its label (weighted sampling with replacement)."""
    weights = {"label_weights": None, "sampler_weights": None}

    if getattr(params, "dummy_dataset", False):
        logger.warning("Dummy dataset is used to train model.")
        common = dict(data_dir=None, tokenizer=tokenizer, indexes=None,
                      max_seq_len=params.max_seq_len,
                      max_question_len=params.max_question_len, rng=rng)
        return (DummyDataset(**common), DummyDataset(dataset_len=1024, **common),
                weights)

    preprocessor = RawPreprocessor(
        raw_json=params.data_path, out_dir=params.processed_data_path,
        clear=clear)
    labels_counter, labels, (train_indexes, train_labels, test_indexes,
                             test_labels) = preprocessor()

    if getattr(params, "train_label_weights", False):
        label_weights = np.asarray(
            [1 / labels_counter[k] for k in sorted(labels_counter.keys())])
        label_weights = label_weights / np.sum(label_weights)
        logger.info("Label weights: " + ", ".join(
            f"{id2labels[k]} ({k}) - {v:.4f}"
            for k, v in enumerate(label_weights)) + ".")
        weights["label_weights"] = label_weights

    if getattr(params, "train_sampler_weights", False):
        sampler_weights = np.asarray(
            [1 / labels_counter[label] for label in train_labels])
        weights["sampler_weights"] = sampler_weights / np.sum(sampler_weights)

    common = dict(
        tokenizer=tokenizer,
        max_seq_len=params.max_seq_len,
        max_question_len=params.max_question_len,
        doc_stride=params.doc_stride,
        split_by_sentence=params.split_by_sentence,
        truncate=params.truncate,
        rng=rng,
    )
    train_dataset = SplitDataset(params.processed_data_path,
                                 indexes=train_indexes, **common)
    test_dataset = SplitDataset(params.processed_data_path,
                                indexes=test_indexes, test=True, **common)
    return train_dataset, test_dataset, weights


def init_shared_datasets(params, *, tokenizer=None, clear: bool = False,
                         rng=None):
    """:func:`init_datasets` as every process of a data-parallel world runs
    it (the JAX ``cli/train.py``'s dataset preparation): rank 0 prepares
    the processed split (clearing it first when ``clear``), the others wait
    at a barrier and then load what it wrote. Alone, :func:`init_datasets`
    itself."""
    if is_primary():
        out = init_datasets(params, tokenizer=tokenizer, clear=clear, rng=rng)
    barrier("dataset_prep")
    if not is_primary():
        out = init_datasets(params, tokenizer=tokenizer, clear=False, rng=rng)
    return out


def init_validation_dataset(params, *, tokenizer=None, clear: bool = False,
                            rng=None):
    """The held-out split as a ``ChunkDataset`` (reference
    validate.py:15-26), built as the JAX package builds it: sentence chunks,
    truncated, at the dataset's own ``max_seq_len`` 384, question 64 and
    stride 128 (the flags' values reach the collate, not the chunker)."""
    preprocessor = RawPreprocessor(
        raw_json=params.data_path, out_dir=params.processed_data_path,
        clear=clear)
    _, _, (_, _, val_indexes, _) = preprocessor()
    return ChunkDataset(params.processed_data_path, tokenizer, val_indexes,
                        test=False, split_by_sentence=True, truncate=True,
                        rng=rng)


def init_collate_fun(tokenizer, *, max_seq_len: Optional[int] = None,
                     return_items: bool = False):
    """Bind tokenizer + static shape (init.py:204-205)."""
    return make_collate_fun(tokenizer, max_seq_len=max_seq_len,
                            return_items=return_items)
