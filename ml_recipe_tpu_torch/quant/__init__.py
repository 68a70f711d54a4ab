"""Post-training int8 quantization for serving (the port of
``ml_recipe_tpu/quant/``).

- ``quantize``: offline weight conversion and the per-layer error report;
- ``layers``: ``QuantLinear``, which the quantized model runs (per-row
  activation quantization, then the int8 matmul kernel);
- ``calibrate``: span agreement of the int8 path with the float one.

``quantize_model`` is the one-call entry: a float model in, its int8 twin
and the report out. The conversion starts from the f32 master weights; the
checkpoint format never changes.
"""

from __future__ import annotations

from .calibrate import make_parity_batches, score_chunks, span_parity
from .layers import QuantLinear
from .quantize import (
    param_bytes,
    quantize_kernel,
    quantize_params,
    weight_kernel_bytes,
)

__all__ = [
    "QuantLinear",
    "make_parity_batches",
    "param_bytes",
    "quantize_kernel",
    "quantize_model",
    "quantize_params",
    "score_chunks",
    "span_parity",
    "weight_kernel_bytes",
]


def quantize_model(model, mode: str = "int8"):
    """``(qmodel, report)``: the same ``QAModel`` configuration with
    ``quantize='int8'`` (every matmul ``Linear`` a ``QuantLinear``), holding
    ``quantize_params`` of the model's weights, on the model's device and in
    its train/eval mode; the report is ``quantize_params``'. The weights are
    read as f32 (``to_jax_params``): quantize a model whose Linear weights
    are still the f32 master weights, before any cast for serving.
    ``mode='off'`` returns the model itself."""
    if mode in (None, "off"):
        return model, {"quantize": "off"}
    if mode != "int8":
        raise ValueError(f"unsupported quantization mode {mode!r} "
                         f"(want 'off' or 'int8')")
    from ..models.convert import from_jax_params, to_jax_params

    qparams, report = quantize_params(to_jax_params(model.state_dict()))
    qmodel = type(model)(
        model.cfg, dtype=model.dtype, device=model.device,
        attention_impl=model.attention_impl, remat=model.transformer.remat,
        ln_impl=model.ln_impl, quantize="int8")
    qmodel.load_state_dict(from_jax_params(qparams), strict=True)
    return qmodel.train(model.training), report
