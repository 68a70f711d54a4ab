"""Multi-head QA model (the port of ``ml_recipe_tpu/models/qa_model.py``).

Encoder trunk + four heads: ``position_outputs`` Linear(H, 2) for start/end
span logits, ``classifier`` Dropout + Linear(H, num_labels) on the pooled
output, and ``reg_start``/``reg_end`` Linear(H, 1) + sigmoid. Span logits at
padding positions get the JAX model's ``-1e9`` penalty, added in f32, so
argmax never lands on padding of a fixed-shape batch.

Parameters are f32 master weights; ``dtype`` is the compute dtype.
``ln_impl`` and ``quantize`` (serving only: the heads go through the same
``_dense`` factory as the encoder's projections) are the encoder's. In
training mode every dropout (hidden, attention, classifier) draws from the
``generator`` given to :meth:`QAModel.forward`, at the global micro-batch's
shape when ``global_rows`` is given (see ``models/encoder.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .config import EncoderConfig
from .encoder import GlobalRows, TransformerEncoder, _dense, dropout

QA_OUTPUT_KEYS = ("start_class", "end_class", "start_reg", "end_reg", "cls")

_MASK_NEG = -1e9


class QAModel(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype=torch.float32,
                 device=None, attention_impl: str = "auto",
                 remat: bool = False, ln_impl: str = "xla",
                 quantize: str = "off"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.attention_impl, self.ln_impl = attention_impl, ln_impl
        self.quantize = quantize or "off"
        self.transformer = TransformerEncoder(
            cfg, dtype=dtype, device=device, attention_impl=attention_impl,
            remat=remat, ln_impl=ln_impl, quantize=quantize)
        H = cfg.hidden_size
        self.position_outputs = _dense(quantize, H, 2, dtype, device)
        self.classifier = _dense(quantize, H, cfg.num_labels, dtype, device)
        self.reg_start = _dense(quantize, H, 1, dtype, device)
        self.reg_end = _dense(quantize, H, 1, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.position_outputs.bias.device

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        global_rows: GlobalRows = None,
    ) -> Dict[str, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        sequence_output, pooled_output = self.transformer(
            input_ids, attention_mask=attention_mask,
            token_type_ids=token_type_ids, generator=generator,
            global_rows=global_rows)

        position_logits = self.position_outputs(sequence_output)
        pad_penalty = (1 - attention_mask).to(torch.float32) * _MASK_NEG
        start_logits = position_logits[..., 0].float() + pad_penalty
        end_logits = position_logits[..., 1].float() + pad_penalty

        cls_hidden = dropout(pooled_output, self.cfg.hidden_dropout_prob,
                             self.training, generator, global_rows)
        classifier_logits = self.classifier(cls_hidden)
        reg_start = torch.sigmoid(self.reg_start(pooled_output))[..., 0]
        reg_end = torch.sigmoid(self.reg_end(pooled_output))[..., 0]
        return {
            "start_class": start_logits,
            "end_class": end_logits,
            "start_reg": reg_start.float(),
            "end_reg": reg_end.float(),
            "cls": classifier_logits.float(),
        }


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with flax's default distributions: Linear weights
    truncated-normal (2 std) at variance 1/fan_in, embeddings normal at
    variance 1/features, biases 0, LayerNorm 1/0. Draws happen on the CPU
    from ``generator`` in f32 and are copied into the params, so one seed
    gives the same weights on any device and in any compute dtype."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                fan_in = module.in_features
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                module.weight.copy_(w)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                w = torch.empty(module.weight.shape)
                w.normal_(0.0, (1.0 / module.embedding_dim) ** 0.5,
                          generator=generator)
                module.weight.copy_(w)
