"""Weight bridge between the JAX package's flax params and the port's modules.

The port's module tree mirrors the flax tree name for name (see
``models/encoder.py``), so conversion is a per-leaf rename:

- ``Dense.kernel [in, out]`` <-> ``Linear.weight [out, in]`` (transposed);
- ``Dense.bias`` <-> ``Linear.bias``;
- ``Embed.embedding`` <-> ``Embedding.weight``;
- ``LayerNorm.scale`` / ``bias`` <-> ``LayerNorm.weight`` / ``bias``;
- quantized trees (``quantize='int8'``): ``QuantDense.kernel_q`` int8
  ``[K, N]`` <-> ``QuantLinear.kernel_q`` int8 ``[N, K]`` (transposed), and
  ``kernel_scale`` f32 ``[N]`` as it is.

Both directions deal in numpy on the JAX side (``tree_of_numpy`` is the
``params`` collection, e.g. ``state["model"]`` of a checkpoint) and CPU
tensors on the port side, f32 but for the int8 ``kernel_q``;
``model.load_state_dict`` then casts to the model's dtype and device.

Tensor parallelism: ``from_jax_params(tree, model_index=r,
model_size=T)`` keeps rank ``r``'s slice of every leaf the JAX package's
``TP_RULES`` split (``parallel/sharding.py``), the rest whole; the flax
tree itself always holds whole leaves, so ``to_jax_params`` takes the
whole leaves a ``model`` group gathers
(``parallel.sharding.ModelSplit.gather``).

Pipeline stages: a rank of ``pipe:K,model:T`` keeps, of
``from_jax_params``' slices, its stage's parameters alone
(``parallel.pipeline.param_stage``; the trainer's restore filters by the
stage layout's owners). The way back: each stage's leaves, gathered whole
over its ``model`` group, through ``to_jax_params``, and the stages' trees
joined by :func:`merge_jax_params` into the whole tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LN_NAMES = ("layer_norm",)


def _flatten(tree: dict, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _to_f32_tensor(arr) -> torch.Tensor:
    # an owned f32 copy (bf16 leaves of a JAX tree widen exactly)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def from_jax_params(tree_of_numpy: dict, *, model_index: int = 0,
                    model_size: int = 1) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> the port model's ``state_dict``; with
    ``model_size`` > 1, rank ``model_index``'s slices of the leaves a
    ``model`` axis splits."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree_of_numpy):
        *module, name = path
        if name == "kernel_q":
            t = torch.from_numpy(np.array(leaf, dtype=np.int8))
        else:
            t = _to_f32_tensor(leaf)
        if name in ("kernel", "kernel_q"):
            if t.dim() != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {t.dim()}")
            t = t.t().contiguous()
            name = "weight" if name == "kernel" else name
        elif name in ("embedding", "scale"):
            name = "weight"
        elif name not in ("bias", "kernel_scale"):
            raise ValueError(f"{'/'.join(path)}: unknown flax leaf {name!r}")
        out[".".join((*module, name))] = t
    if model_size > 1:
        from ..parallel.sharding import ModelSplit, tp_param_dims

        split = ModelSplit(tp_param_dims(out), index=model_index,
                           size=model_size)
        out = split.local_state(out)
    return out


def merge_jax_params(*trees: dict) -> dict:
    """The union of nested dicts (the stages' parts of one flax tree, or
    of a checkpoint's groups) as a new tree of dicts; where two hold the
    same leaf, the first one's."""
    merged: dict = {}

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                node = dst.setdefault(k, {})
                if isinstance(node, dict):
                    merge(node, v)
            else:
                dst.setdefault(k, v)

    for tree in trees:
        merge(merged, tree)
    return merged


def jax_path(key: str) -> tuple:
    """The flax tree path of the port's parameter ``key``."""
    *module, name = key.split(".")
    if name == "weight":
        if module[-1] in _LN_NAMES:
            name = "scale"
        elif module[-1].endswith("embeddings"):
            name = "embedding"
        else:
            name = "kernel"
    return (*module, name)


def to_jax_params(state_dict: Dict[str, torch.Tensor], *,
                  copy: bool = False) -> dict:
    """The inverse of :func:`from_jax_params`: a nested dict of numpy, f32
    but for the int8 ``kernel_q``. A leaf of a CPU tensor may share the
    tensor's memory; ``copy`` makes every leaf a buffer of its own."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        path = jax_path(key)
        arr = (tensor.detach().cpu().numpy() if path[-1] == "kernel_q"
               else tensor.detach().to("cpu", torch.float32).numpy())
        if path[-1] in ("kernel", "kernel_q"):
            arr = arr.T
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        # a leaf read from the card is a fresh host buffer already
        own = copy and tensor.device.type == "cpu"
        node[path[-1]] = (np.array(arr, order="C", copy=True) if own
                          else np.ascontiguousarray(arr))
    return tree
