"""Post-training weight quantization: float trees -> int8 trees.

The port's own copy of ``ml_recipe_tpu/quant/quantize.py`` (numpy, on the
host). It walks a parameter tree in the JAX package's layout (the flax
``params`` collection, or ``models.to_jax_params`` of a port model) and
converts every 2D ``kernel`` leaf ``[K, N]`` to symmetric per-OUTPUT-channel
int8: ``kernel_q`` int8 ``[K, N]`` and ``kernel_scale`` f32 ``[N]`` with
``kernel_q * kernel_scale ~= kernel``. Biases, LayerNorm scales and
embeddings pass through untouched. The same float tree gives the same
codes and scales as the JAX package's conversion, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.quant_matmul import INT8_MAX

# a weight column of exact zeros gets this scale (quantizes to zeros)
_EPS = 1e-8

__all__ = [
    "quantize_kernel",
    "quantize_params",
    "param_bytes",
    "weight_kernel_bytes",
]


def quantize_kernel(w: np.ndarray, *, eps: float = _EPS
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 quantization of one ``[K, N]``
    kernel: ``scale[n] = max|w[:, n]| / 127`` (floored at ``eps``),
    ``q = round_half_even(w / scale)`` clipped to ``[-127, 127]``."""
    wf = np.asarray(w, np.float32)
    if wf.ndim != 2:
        raise ValueError(f"quantize_kernel wants a 2D kernel, got {wf.shape}")
    amax = np.max(np.abs(wf), axis=0)
    scale = np.maximum(amax, eps) / INT8_MAX
    q = np.clip(np.rint(wf / scale[None, :]), -INT8_MAX, INT8_MAX)
    return q.astype(np.int8), scale.astype(np.float32)


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    arr = np.asarray(leaf)
    return int(arr.size) * int(arr.dtype.itemsize)


def param_bytes(params) -> int:
    """Total bytes of every array leaf of a (nested) dict of numpy arrays
    or tensors: a parameter tree or a ``state_dict``, float or quantized."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += _leaf_bytes(node)
    return total


def weight_kernel_bytes(params) -> int:
    """Bytes of just the (quantizable or quantized) matmul kernels of a
    tree in the JAX layout: the part int8 conversion shrinks."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            for name, child in node.items():
                if name in ("kernel", "kernel_q") and not isinstance(
                        child, dict):
                    total += _leaf_bytes(child)
                else:
                    stack.append(child)
    return total


def _quantize_node(node: dict, path: str, report: List[dict]) -> dict:
    out: Dict[str, object] = {}
    for name, child in node.items():
        sub = f"{path}/{name}" if path else name
        if isinstance(child, dict):
            out[name] = _quantize_node(child, sub, report)
            continue
        arr = np.asarray(child)
        if name == "kernel" and arr.ndim == 2:
            q, scale = quantize_kernel(arr)
            out["kernel_q"] = q
            out["kernel_scale"] = scale
            wf = arr.astype(np.float32)
            err = q.astype(np.float32) * scale[None, :] - wf
            denom = float(np.sqrt(np.mean(wf ** 2))) or 1.0
            report.append({
                "layer": sub,
                "shape": list(arr.shape),
                "rms_err": float(np.sqrt(np.mean(err ** 2))),
                "max_abs_err": float(np.max(np.abs(err))),
                "rel_rms_err": float(np.sqrt(np.mean(err ** 2))) / denom,
            })
        else:
            out[name] = child
    return out


def quantize_params(params: dict) -> Tuple[dict, dict]:
    """Convert a float tree (JAX layout) to the int8 serving tree.

    Returns ``(qparams, report)``: every 2D ``kernel`` leaf becomes
    ``kernel_q``/``kernel_scale``, all other leaves pass through by
    reference; the report carries the per-layer quantization error and the
    bytes before and after."""
    layers: List[dict] = []
    qparams = _quantize_node(params, "", layers)
    report = {
        "quantize": "int8",
        "layers": layers,
        "n_quantized": len(layers),
        "orig_bytes": param_bytes(params),
        "quant_bytes": param_bytes(qparams),
        "orig_kernel_bytes": weight_kernel_bytes(params),
        "quant_kernel_bytes": weight_kernel_bytes(qparams),
        "max_rel_rms_err": max(
            (l["rel_rms_err"] for l in layers), default=0.0
        ),
    }
    return qparams, report
