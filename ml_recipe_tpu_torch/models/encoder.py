"""BERT/RoBERTa encoder in PyTorch (the port of ``ml_recipe_tpu/models/encoder.py``).

Post-layer-norm BERT stack with the JAX module's numerics:

- Linear and embedding weights live in the compute dtype (bf16 by default),
  as flax casts its f32 params to ``dtype`` at every use; LayerNorm keeps
  f32 params and computes in f32, then casts to the compute dtype;
- exact-erf GELU; LayerNorm eps from the config;
- attention through ``ops.attention.dot_product_attention``, so on the card
  every layer runs the hand-written fused attention kernel;
- module and parameter names follow the flax tree (``layer_0.attention.
  query``...), so ``models/convert.py`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, dropout_seed
from .config import EncoderConfig


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics: f32 statistics and affine, output in
    the input's dtype. Params ``weight``/``bias`` stay f32."""

    def __init__(self, features: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, device=device, dtype=dtype)


def _embed(n: int, features: int, dtype, device) -> nn.Embedding:
    return nn.Embedding(n, features, device=device, dtype=dtype)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = _embed(cfg.vocab_size, H, dtype, device)
        self.position_embeddings = _embed(cfg.max_position_embeddings, H,
                                          dtype, device)
        # RoBERTa has one token type; the table keeps its single row
        self.token_type_embeddings = _embed(max(cfg.type_vocab_size, 1), H,
                                            dtype, device)
        self.layer_norm = LayerNorm(H, cfg.layer_norm_eps, device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        L = input_ids.shape[-1]
        if L + cfg.position_offset > cfg.max_position_embeddings:
            # the JAX module's trace-time guard: never a silent clamp of
            # positions past the table
            raise ValueError(
                f"sequence length {L} (+offset {cfg.position_offset}) "
                f"exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}; widen the position table "
                f"(--max_position_embeddings) for long-context runs"
            )
        positions = torch.arange(L, device=input_ids.device) + cfg.position_offset
        if cfg.type_vocab_size <= 1:
            token_type_ids = torch.zeros_like(token_type_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 attention_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.attention_impl = attention_impl
        H = cfg.hidden_size
        self.query = _linear(H, H, dtype, device)
        self.key = _linear(H, H, dtype, device)
        self.value = _linear(H, H, dtype, device)
        self.output = _linear(H, H, dtype, device)
        self.layer_norm = LayerNorm(H, cfg.layer_norm_eps, device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, H = hidden.shape

        def heads(proj: nn.Linear) -> torch.Tensor:
            return proj(hidden).view(B, L, cfg.num_heads, cfg.head_dim)

        rate = cfg.attention_probs_dropout_prob if self.training else 0.0
        ctx = dot_product_attention(
            heads(self.query), heads(self.key), heads(self.value), mask,
            dropout_rate=rate, seed=dropout_seed() if rate > 0.0 else None,
            impl=self.attention_impl,
        )
        out = self.dropout(self.output(ctx.reshape(B, L, H)))
        return self.layer_norm(hidden + out)


class FeedForward(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device):
        super().__init__()
        self.intermediate = _linear(cfg.hidden_size, cfg.intermediate_size,
                                    dtype, device)
        self.output = _linear(cfg.intermediate_size, cfg.hidden_size, dtype,
                              device)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.intermediate(hidden), approximate="none")
        y = self.dropout(self.output(y))
        return self.layer_norm(hidden + y)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 attention_impl: str = "auto"):
        super().__init__()
        self.attention = SelfAttention(cfg, dtype=dtype, device=device,
                                       attention_impl=attention_impl)
        self.mlp = FeedForward(cfg, dtype=dtype, device=device)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.attention(hidden, mask))


class TransformerEncoder(nn.Module):
    """BERT/RoBERTa trunk: returns (sequence_output, pooled_output)."""

    def __init__(self, cfg: EncoderConfig, *, dtype=torch.float32,
                 device=None, attention_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, dtype=dtype, device=device)
        for i in range(cfg.num_layers):  # flax names: layer_0, layer_1, ...
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg, dtype=dtype, device=device, attention_impl=attention_impl))
        self.pooler = _linear(cfg.hidden_size, cfg.hidden_size, dtype, device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        mask = attention_mask.to(torch.int32)
        hidden = self.embeddings(input_ids, token_type_ids)
        for i in range(self.cfg.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, mask)
        pooled = torch.tanh(self.pooler(hidden[:, 0]))
        return hidden, pooled
