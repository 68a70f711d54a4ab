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


def from_jax_params(tree_of_numpy: dict) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> the port model's ``state_dict``."""
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
    return out


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`from_jax_params`: a nested dict of numpy, f32
    but for the int8 ``kernel_q``."""
    tree: dict = {}
    for key, tensor in state_dict.items():
        *module, name = key.split(".")
        if name == "kernel_q":
            arr = tensor.detach().cpu().numpy().T
        else:
            arr = tensor.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            if module[-1] in _LN_NAMES:
                name = "scale"
            elif module[-1].endswith("embeddings"):
                name = "embedding"
            else:
                name, arr = "kernel", arr.T
        node = tree
        for part in module:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree
