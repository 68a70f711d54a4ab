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

Sequence packing (``segment_starts`` given, with ``segment_ids`` and
``position_ids`` from ``data/packing.collate_packed``): the trunk runs
block-diagonal attention and per-segment positions, and every head is per
segment: span logits ``[B, S, L]`` (segment s's logits keep its own tokens
and get ``-1e9`` elsewhere), cls and the regressors from each segment's own
first row, ``[B, S, ...]``. The parameters are the unpacked model's, so a
checkpoint serves both.

Sequence parallelism (``attention_impl='ring'`` and a ``mesh`` with a
``seq`` axis): the inputs are the whole ``[B, L]`` rows on every rank of a
``seq`` group; the trunk runs on each rank's block and gathers the hidden
states (``models/encoder.py``), so the heads, the pad penalty and the
loss see the whole sequence, identically on every rank of the group (the
CLS row, token 0, comes from ``seq_index`` 0's block).

Tensor parallelism (a ``mesh`` with a ``model`` axis > 1): the encoder's
attention and MLP blocks run on this rank's heads and columns
(``models/encoder.py``); the embeddings, the pooler and the four heads
stay whole on every rank of the ``model`` group, which all compute the
same outputs. :meth:`QAModel.model_split` is the rank's
``parallel.sharding.ModelSplit``: which parameters are slices, of which
dimension, and the gather of the group's slices back into whole ones.
Under a ``pipe`` axis too, a stage runs :meth:`QAModel.embed` (stage 0),
:meth:`QAModel.layers` and :meth:`QAModel.tail` (the last stage) on its
slices.
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
                 quantize: str = "off", mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.attention_impl, self.ln_impl = attention_impl, ln_impl
        self.quantize = quantize or "off"
        self.transformer = TransformerEncoder(
            cfg, dtype=dtype, device=device, attention_impl=attention_impl,
            remat=remat, ln_impl=ln_impl, quantize=quantize, mesh=mesh)
        H = cfg.hidden_size
        self.position_outputs = _dense(quantize, H, 2, dtype, device)
        self.classifier = _dense(quantize, H, cfg.num_labels, dtype, device)
        self.reg_start = _dense(quantize, H, 1, dtype, device)
        self.reg_end = _dense(quantize, H, 1, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.position_outputs.bias.device

    def model_split(self):
        """This rank's ``parallel.sharding.ModelSplit`` under a ``model``
        axis > 1, else None."""
        mesh = self.transformer.tp
        if mesh is None:
            return None
        from ..parallel.sharding import ModelSplit, tp_param_dims

        return ModelSplit(tp_param_dims(n for n, _ in self.named_parameters()),
                          index=mesh.model_index, size=mesh.model_size,
                          group=mesh.model_group, owner=mesh.data_index == 0)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        global_rows: GlobalRows = None,
        position_ids: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        segment_starts: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        packed = segment_starts is not None
        if packed and (segment_ids is None or position_ids is None):
            raise ValueError(
                "packed inputs need segment_ids AND position_ids alongside "
                "segment_starts (data/packing.collate_packed emits all "
                "three)")
        sequence_output, pooled_output = self.transformer(
            input_ids, attention_mask=attention_mask,
            token_type_ids=token_type_ids, generator=generator,
            global_rows=global_rows, position_ids=position_ids,
            segment_ids=segment_ids, segment_starts=segment_starts)

        return self.heads(sequence_output, pooled_output, attention_mask,
                          generator, global_rows, segment_ids, segment_starts)

    def heads(self, sequence_output: torch.Tensor,
              pooled_output: torch.Tensor, attention_mask: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              global_rows: GlobalRows = None,
              segment_ids: Optional[torch.Tensor] = None,
              segment_starts: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """The four heads on the trunk's outputs (the JAX package's
        ``apply_qa_heads``): what runs after the trunk, here and on a
        pipeline's last stage."""
        packed = segment_starts is not None
        position_logits = self.position_outputs(sequence_output)
        pad_penalty = (1 - attention_mask).to(torch.float32) * _MASK_NEG
        start_logits = position_logits[..., 0].float() + pad_penalty
        end_logits = position_logits[..., 1].float() + pad_penalty
        if packed:
            # [B, S, L]: segment s's logits confined to its own tokens; the
            # pooled output is already [B, S, H] (the encoder's gather)
            S = segment_starts.shape[1]
            seg_eq = (segment_ids[:, None, :] == torch.arange(
                1, S + 1, dtype=segment_ids.dtype,
                device=segment_ids.device)[None, :, None])
            seg_penalty = torch.where(
                seg_eq, torch.zeros((), device=seg_eq.device),
                torch.full((), _MASK_NEG, device=seg_eq.device))
            start_logits = start_logits[:, None, :] + seg_penalty
            end_logits = end_logits[:, None, :] + seg_penalty

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

    def embed(self, input_ids: torch.Tensor,
              token_type_ids: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              global_rows: GlobalRows = None,
              position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The embeddings of a pipeline's first stage."""
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        return self.transformer.embeddings(input_ids, token_type_ids,
                                           generator, global_rows,
                                           position_ids)

    def layers(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
               lo: int, hi: int, generator=None,
               global_rows: GlobalRows = None,
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder layers ``lo .. hi - 1`` (one pipeline stage's range)."""
        return self.transformer.run_layers(hidden, attention_mask, lo, hi,
                                           generator, global_rows,
                                           segment_ids)

    def tail(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             global_rows: GlobalRows = None,
             segment_ids: Optional[torch.Tensor] = None,
             segment_starts: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """The pooler and the heads of a pipeline's last stage."""
        return self.heads(hidden, self.transformer.pool(hidden,
                                                        segment_starts),
                          attention_mask, generator, global_rows,
                          segment_ids, segment_starts)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with flax's default distributions: Linear weights
    truncated-normal (2 std) at variance 1/fan_in, embeddings normal at
    variance 1/features, biases 0, LayerNorm 1/0. Draws happen on the CPU
    from ``generator`` in f32 and are copied into the params, so one seed
    gives the same weights on any device and in any compute dtype. A
    tensor-parallel slice (``Linear.split``) is drawn at its whole shape
    and sliced, so one seed gives every rank of a ``model`` group its
    slice of the one-process weights."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                shape = list(module.weight.shape)
                split = getattr(module, "split", None)
                if split is not None:
                    shape[split[0]] *= split[2]
                fan_in = shape[1]
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if split is not None:
                    dim, index, _ = split
                    n = module.weight.shape[dim]
                    w = w.narrow(dim, index * n, n)
                module.weight.copy_(w)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                w = torch.empty(module.weight.shape)
                w.normal_(0.0, (1.0 / module.embedding_dim) ** 0.5,
                          generator=generator)
                module.weight.copy_(w)
