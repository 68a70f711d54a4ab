"""HF checkpoint -> the port's encoder weights (the port of
``ml_recipe_tpu/models/hf_convert.py``).

The reference warm-starts from HF ``from_pretrained``; the encoder here is
first-party, so an HF BERT/RoBERTa ``state_dict`` (``model.safetensors``,
``pytorch_model.bin``, or either file named directly) is mapped onto the
``transformer`` module tree. HF dense weights are already ``[out, in]``,
the layout of the port's ``Linear.weight``, so no leaf is transposed (the
JAX package transposes them into flax kernels, and ``models/convert.py``
transposes back: both land on the same values).

Only local checkpoints are read: the JAX package's hub fallback
(``transformers.AutoModel``) needs a download. ``.safetensors`` files are
read by :func:`read_safetensors` (an 8-byte little-endian header length, a
JSON header, then the raw little-endian tensors), ``.bin`` files with
``torch.load(weights_only=True)``. :func:`write_safetensors` and
:func:`synthetic_hf_state_dict` write the files a warm start reads from
seeded random weights (there are no pretrained weights to download).
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Dict

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)

# safetensors dtype tags -> numpy (BF16 is read as its bits, then viewed)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.int16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as owned CPU tensors."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: safetensors header of {n} bytes runs past "
                         f"the file's {len(data)}")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        tag = meta["dtype"]
        if tag not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {tag}, which this "
                             f"reader does not know")
        begin, end = (int(x) for x in meta["data_offsets"])
        shape = tuple(int(d) for d in meta["shape"])
        dt = np.dtype(_SAFETENSORS_DTYPES[tag]).newbyteorder("<")
        if end > len(body) or (end - begin) != dt.itemsize * int(
                np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} data_offsets {meta['data_offsets']}"
                             f" do not fit shape {list(shape)} of {tag}")
        arr = np.frombuffer(body[begin:end], dtype=dt).reshape(shape)
        tensor = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="),
                                             copy=True))
        out[name] = tensor.view(torch.bfloat16) if tag == "BF16" else tensor
    return out


_TAGS = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
         torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
         torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
         torch.bool: "BOOL"}


def write_safetensors(path, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as a ``.safetensors`` file (the layout
    :func:`read_safetensors` reads; the header padded to 8 bytes)."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        blob = raw.astype(raw.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for blob in blobs:
            fh.write(blob)


def synthetic_hf_state_dict(cfg, *, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded random HF ``BertModel`` state dict for ``cfg``
    (``models.EncoderConfig``), f32, with the ``bert.`` prefix of a task
    model, the ``position_ids`` buffer and one head entry outside the
    encoder (which a warm start drops)."""
    gen = torch.Generator().manual_seed(seed)
    H, inter = cfg.hidden_size, cfg.intermediate_size
    rows = cfg.max_position_embeddings

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    def around_one(n):
        return 1.0 + normal(n)

    sd = {"embeddings.word_embeddings.weight": normal(cfg.vocab_size, H),
          "embeddings.position_embeddings.weight": normal(rows, H),
          "embeddings.token_type_embeddings.weight":
              normal(max(cfg.type_vocab_size, 1), H),
          "embeddings.position_ids": torch.arange(rows).unsqueeze(0),
          "embeddings.LayerNorm.weight": around_one(H),
          "embeddings.LayerNorm.bias": normal(H)}

    def dense(name, n_out, n_in):
        sd[f"{name}.weight"] = normal(n_out, n_in)
        sd[f"{name}.bias"] = normal(n_out)

    def norm(name):
        sd[f"{name}.weight"] = around_one(H)
        sd[f"{name}.bias"] = normal(H)

    for i in range(cfg.num_layers):
        layer = f"encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            dense(f"{layer}.attention.self.{proj}", H, H)
        dense(f"{layer}.attention.output.dense", H, H)
        norm(f"{layer}.attention.output.LayerNorm")
        dense(f"{layer}.intermediate.dense", inter, H)
        dense(f"{layer}.output.dense", H, inter)
        norm(f"{layer}.output.LayerNorm")
    dense("pooler.dense", H, H)
    out = {f"bert.{k}": v for k, v in sd.items()}
    out["qa_outputs.bias"] = normal(2)   # a task head: not the encoder's
    return out


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An HF torch ``state_dict`` from a local directory (its
    ``model.safetensors``, else its ``pytorch_model.bin``) or file."""
    path = os.fspath(path)
    if os.path.isdir(path):
        candidates = [os.path.join(path, "model.safetensors"),
                      os.path.join(path, "pytorch_model.bin")]
    elif os.path.isfile(path):
        candidates = [path]
    else:
        raise FileNotFoundError(
            f"--hf_checkpoint {path!r} is neither a file nor a directory: "
            f"ml_recipe_tpu_torch reads only local checkpoints "
            f"(model.safetensors or pytorch_model.bin), no hub download")
    for cand in candidates:
        if not os.path.exists(cand):
            continue
        if cand.endswith(".safetensors"):
            return read_safetensors(cand)
        sd = torch.load(cand, map_location="cpu", weights_only=True)
        return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    raise FileNotFoundError(f"{path} holds neither model.safetensors nor "
                            f"pytorch_model.bin")


def _strip_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop a leading ``bert.``/``roberta.`` wrapper prefix if present."""
    for prefix in ("bert.", "roberta."):
        if any(k.startswith(prefix + "embeddings.") for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
    return sd


def hf_to_encoder_params(state_dict: Dict[str, torch.Tensor],
                         num_layers: int) -> Dict[str, torch.Tensor]:
    """HF BertModel/RobertaModel names -> the ``transformer`` module's
    ``state_dict`` names (f32 copies)."""
    sd = _strip_prefix(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, hf: str) -> None:
        out[name] = sd[hf].detach().to("cpu", torch.float32).clone()

    def pair(module: str, hf: str) -> None:
        put(f"{module}.weight", f"{hf}.weight")
        put(f"{module}.bias", f"{hf}.bias")

    for table in ("word", "position", "token_type"):
        put(f"embeddings.{table}_embeddings.weight",
            f"embeddings.{table}_embeddings.weight")
    pair("embeddings.layer_norm", "embeddings.LayerNorm")
    for i in range(num_layers):
        hf, mine = f"encoder.layer.{i}", f"layer_{i}"
        for proj in ("query", "key", "value"):
            pair(f"{mine}.attention.{proj}", f"{hf}.attention.self.{proj}")
        pair(f"{mine}.attention.output", f"{hf}.attention.output.dense")
        pair(f"{mine}.attention.layer_norm", f"{hf}.attention.output.LayerNorm")
        pair(f"{mine}.mlp.intermediate", f"{hf}.intermediate.dense")
        pair(f"{mine}.mlp.output", f"{hf}.output.dense")
        pair(f"{mine}.mlp.layer_norm", f"{hf}.output.LayerNorm")
    pair("pooler", "pooler.dense")
    return out


def check_param_shapes(target: Dict[str, torch.Tensor],
                       restored: Dict[str, torch.Tensor], context: str) -> None:
    """Raise ``ValueError`` when a restored leaf's shape differs from the
    model's (``ml_recipe_tpu/utils/params.check_param_shapes``): an
    embedding table of the wrong size would otherwise be indexed past its
    end or silently cut."""
    mismatched = [f"{name}: source {tuple(restored[name].shape)} vs model "
                  f"{tuple(t.shape)}" for name, t in target.items()
                  if name in restored and restored[name].shape != t.shape]
    if mismatched:
        raise ValueError(f"{context} does not fit the model config; "
                         f"mismatched param shapes at: {mismatched[:5]}")


@torch.no_grad()
def load_pretrained_into(model: nn.Module, path: str) -> None:
    """Replace ``model.transformer``'s weights with converted HF weights, in
    place; the heads keep their seeded init (only the trunk is pretrained,
    as in the reference).

    The position table is reconciled with the model's size: a wider table
    keeps its freshly initialized tail under the pretrained prefix, a
    narrower one keeps the checkpoint's first rows. Any other shape
    mismatch raises before a weight is written."""
    encoder = model.transformer
    num_layers = encoder.cfg.num_layers
    converted = hf_to_encoder_params(load_hf_state_dict(path), num_layers)
    target = encoder.state_dict()

    key = "embeddings.position_embeddings.weight"
    src, tgt = converted[key], target[key]
    if src.shape[0] != tgt.shape[0]:
        n = min(src.shape[0], tgt.shape[0])
        merged = tgt.detach().to("cpu", torch.float32).clone()
        merged[:n] = src[:n]
        converted[key] = merged
        if tgt.shape[0] > src.shape[0]:
            logger.warning(
                f"Position table widened: pretrained rows 0..{n - 1} copied "
                f"from the {src.shape[0]}-row checkpoint; rows {n}.."
                f"{tgt.shape[0] - 1} stay freshly initialized (train them: "
                f"they carry no pretrained signal).")
        else:
            logger.warning(
                f"Position table truncated: the model keeps the first {n} of "
                f"the checkpoint's {src.shape[0]} pretrained rows (sequences "
                f"here never index past {n - 1}).")
    split = model.model_split() if hasattr(model, "model_split") else None
    if split is not None:   # this rank's slices under a model axis
        converted = {k: split.local(f"transformer.{k}", v)
                     for k, v in converted.items()}
    check_param_shapes(target, converted, f"converted checkpoint {path}")
    encoder.load_state_dict(converted, strict=True)
    logger.info(f"Encoder weights converted from {path}.")
