"""BERT/RoBERTa encoder in PyTorch (the port of ``ml_recipe_tpu/models/encoder.py``).

Post-layer-norm BERT stack with the JAX module's numerics:

- every parameter lives in f32 (the optimizer's master weights, as flax
  keeps its params); Linear and embedding weights are cast to the compute
  dtype (bf16 by default) at each use, as ``nn.Dense(dtype=...)`` /
  ``nn.Embed(dtype=...)`` do (a serving model from ``compose.init_model``
  holds those params in the compute dtype, so the cast is a no-op there);
  LayerNorm computes in f32, then casts to the compute dtype;
- exact-erf GELU; LayerNorm eps from the config;
- ``ln_impl`` picks the LayerNorm (:func:`_ln`): 'xla' is flax's
  ``nn.LayerNorm`` (:class:`LayerNorm`); 'fused'/'auto' is
  :class:`FusedLayerNorm` over ``ops.layer_norm``, the hand-written kernel
  pair on the card. Both hold the same f32 ``weight``/``bias``, so a
  checkpoint loads under either;
- ``quantize='int8'`` (serving only) makes every matmul ``Linear`` a
  ``quant.layers.QuantLinear`` under the same name (:func:`_dense`), which
  runs the hand-written int8 matmul kernel on the card. A fused LayerNorm
  of such a model also writes the int8 row codes of its output in the same
  launch, and every projection that reads that output takes them from
  there (``quant.layers.row_codes``): the Q/K/V, intermediate, span-head
  and pooler inputs are quantized by no launch of their own;
- attention through ``ops.attention.dot_product_attention``, so on the card
  every layer runs the hand-written fused attention kernels (forward, and
  the backward when training);
- training mode (``model.train()``) applies hidden and attention dropout
  with flax's semantics (kept values scaled by ``1/(1-rate)``). The masks
  and the per-layer attention-dropout seeds are drawn from the one
  ``torch.Generator`` the caller passes as ``generator``, on the model's
  device: there is no global-RNG default. ``global_rows=(first, total)``
  (data parallelism) says the batch is rows ``first .. first + B`` of a
  global micro-batch of ``total`` rows: each hidden-dropout mask is drawn
  at the global shape and these rows kept, and the attention row seeds are
  those of these rows' places (``ops.attention.global_row_seeds``), so a
  process draws exactly what a one-process forward of the global
  micro-batch draws for its rows, and every process's generator stays in
  step;
- module and parameter names follow the flax tree (``layer_0.attention.
  query``...), so ``models/convert.py`` maps one onto the other by name;
- ``remat`` (``--remat``, flax ``nn.remat`` around each ``EncoderLayer``)
  keeps only each layer's input for the backward and recomputes the layer
  there (``torch.utils.checkpoint``). The recompute replays the layer's
  draws from the caller's generator (:func:`remat_layer`), so remat on and
  off give the same gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    dot_product_attention,
    dropout_seed,
    global_row_seeds,
)
from ..ops.layer_norm import layer_norm, layer_norm_q8
from ..quant.layers import QuantLinear, first_token, with_row_codes
from .config import EncoderConfig

# (first, total): the batch's rows are rows first .. first + B of a global
# micro-batch of `total` rows (data parallelism); None: the batch is whole
GlobalRows = Optional[Tuple[int, int]]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            global_rows: GlobalRows = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1/(1-rate)``; the mask is drawn from ``generator``, at
    the global micro-batch's shape when ``global_rows`` is given (of which
    ``x``'s rows are kept)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator "
                         "(pass generator=... to the model's forward)")
    if global_rows is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        first, total = global_rows
        u = torch.rand((total, *x.shape[1:]), generator=generator,
                       device=x.device)[first:first + x.shape[0]]
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics: f32 statistics and affine, output in
    the input's dtype. Params ``weight``/``bias`` are f32."""

    def __init__(self, features: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


class FusedLayerNorm(nn.Module):
    """``ops.layer_norm.layer_norm`` as a module (the JAX package's
    ``FusedLayerNorm``): f32 ``weight``/``bias`` as :class:`LayerNorm` holds
    them, the result in the compute dtype ``dtype``; ``impl`` is 'fused' or
    'auto'. ``codes`` (int8 models): the result also carries its int8 row
    codes (``ops.layer_norm.layer_norm_q8``, written by the same launch)."""

    def __init__(self, features: int, eps: float, dtype, impl: str, *,
                 device=None, codes: bool = False):
        super().__init__()
        self.eps, self.dtype, self.impl, self.codes = eps, dtype, impl, codes
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.codes:
            return with_row_codes(*layer_norm_q8(
                x, self.weight, self.bias, eps=self.eps, dtype=self.dtype))
        return layer_norm(x, self.weight, self.bias, eps=self.eps,
                          dtype=self.dtype, impl=self.impl)


def _ln(cfg: EncoderConfig, dtype, ln_impl: str, device,
        quantize: str = "off") -> nn.Module:
    """LayerNorm factory: 'xla' keeps :class:`LayerNorm`, 'fused' and
    'auto' give :class:`FusedLayerNorm`, which writes row codes in an int8
    model."""
    if ln_impl == "xla":
        return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
    if ln_impl not in ("fused", "auto"):
        raise ValueError(f"ln_impl must be 'xla', 'fused' or 'auto'; got "
                         f"{ln_impl!r}")
    return FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype, ln_impl,
                          device=device, codes=quantize == "int8")


def _dense(quantize: str, n_in: int, n_out: int, dtype, device) -> nn.Module:
    """Linear factory for the matmul projections: 'off' keeps
    :class:`Linear`, 'int8' gives ``QuantLinear``."""
    if quantize == "int8":
        return QuantLinear(n_in, n_out, dtype, device)
    if quantize not in (None, "off"):
        raise ValueError(f"quantize must be 'off' or 'int8', got {quantize!r}")
    return Linear(n_in, n_out, dtype, device)


class Linear(nn.Linear):
    """``nn.Dense(dtype=compute_dtype)``: f32 params, cast at each use."""

    def __init__(self, n_in: int, n_out: int, dtype, device):
        super().__init__(n_in, n_out, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class Embedding(nn.Embedding):
    """``nn.Embed(dtype=compute_dtype)``: an f32 table, rows cast at use."""

    def __init__(self, n: int, features: int, dtype, device):
        super().__init__(n, features, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 ln_impl: str = "xla", quantize: str = "off"):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, H, dtype, device)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, H,
                                             dtype, device)
        # RoBERTa has one token type; the table keeps its single row
        self.token_type_embeddings = Embedding(max(cfg.type_vocab_size, 1), H,
                                               dtype, device)
        self.layer_norm = _ln(cfg, dtype, ln_impl, device, quantize)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None) -> torch.Tensor:
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
        return dropout(self.layer_norm(x), cfg.hidden_dropout_prob,
                       self.training, generator, global_rows)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 attention_impl: str = "auto", ln_impl: str = "xla",
                 quantize: str = "off"):
        super().__init__()
        self.cfg = cfg
        self.attention_impl = attention_impl
        H = cfg.hidden_size
        self.query = _dense(quantize, H, H, dtype, device)
        self.key = _dense(quantize, H, H, dtype, device)
        self.value = _dense(quantize, H, H, dtype, device)
        self.output = _dense(quantize, H, H, dtype, device)
        self.layer_norm = _ln(cfg, dtype, ln_impl, device, quantize)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None) -> torch.Tensor:
        cfg = self.cfg
        B, L, H = hidden.shape

        def heads(proj: nn.Module) -> torch.Tensor:
            return proj(hidden).view(B, L, cfg.num_heads, cfg.head_dim)

        rate = cfg.attention_probs_dropout_prob if self.training else 0.0
        seed = None
        if rate > 0.0:
            if generator is None:
                raise ValueError("training-mode attention dropout needs a "
                                 "torch.Generator (generator=...)")
            seed = dropout_seed(generator)
            if global_rows is not None:
                seed = global_row_seeds(seed, global_rows[0], B,
                                        global_rows[1], cfg.num_heads)
        ctx = dot_product_attention(
            heads(self.query), heads(self.key), heads(self.value), mask,
            dropout_rate=rate, seed=seed, impl=self.attention_impl,
        )
        out = dropout(self.output(ctx.reshape(B, L, H)),
                      cfg.hidden_dropout_prob, self.training, generator,
                      global_rows)
        return self.layer_norm(hidden + out)


class FeedForward(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 ln_impl: str = "xla", quantize: str = "off"):
        super().__init__()
        self.cfg = cfg
        self.intermediate = _dense(quantize, cfg.hidden_size,
                                   cfg.intermediate_size, dtype, device)
        self.output = _dense(quantize, cfg.intermediate_size, cfg.hidden_size,
                             dtype, device)
        self.layer_norm = _ln(cfg, dtype, ln_impl, device, quantize)

    def forward(self, hidden: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None) -> torch.Tensor:
        y = F.gelu(self.intermediate(hidden), approximate="none")
        y = dropout(self.output(y), self.cfg.hidden_dropout_prob,
                    self.training, generator, global_rows)
        return self.layer_norm(hidden + y)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 attention_impl: str = "auto", ln_impl: str = "xla",
                 quantize: str = "off"):
        super().__init__()
        self.attention = SelfAttention(cfg, dtype=dtype, device=device,
                                       attention_impl=attention_impl,
                                       ln_impl=ln_impl, quantize=quantize)
        self.mlp = FeedForward(cfg, dtype=dtype, device=device,
                               ln_impl=ln_impl, quantize=quantize)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None) -> torch.Tensor:
        return self.mlp(self.attention(hidden, mask, generator, global_rows),
                        generator, global_rows)


def remat_layer(layer: nn.Module, hidden: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator],
                global_rows: GlobalRows = None) -> torch.Tensor:
    """``layer(hidden, mask, generator, global_rows)`` under
    ``torch.utils.checkpoint``:
    the layer's activations are dropped after the forward and recomputed in
    the backward. ``checkpoint``'s ``preserve_rng_state`` restores only the
    global RNGs, not ``generator``, whose state by the backward has moved on
    past every later layer's draws: the recompute would draw other dropout
    masks and another attention seed, and the backward would run on
    activations the forward never produced. So the generator's state is
    taken before the layer runs, and the recompute runs from it and puts
    the generator back where it found it."""
    if generator is None:
        return checkpoint(layer, hidden, mask, None, global_rows,
                          use_reentrant=False, preserve_rng_state=False)
    state = generator.get_state()
    recompute = False

    def run(h: torch.Tensor) -> torch.Tensor:
        nonlocal recompute
        if not recompute:                # the forward: draw as usual
            recompute = True
            return layer(h, mask, generator, global_rows)
        after = generator.get_state()    # the recompute: replay the draws
        generator.set_state(state)
        try:
            return layer(h, mask, generator, global_rows)
        finally:
            generator.set_state(after)

    return checkpoint(run, hidden, use_reentrant=False,
                      preserve_rng_state=False)


class TransformerEncoder(nn.Module):
    """BERT/RoBERTa trunk: returns (sequence_output, pooled_output).
    ``remat``: recompute each layer in the backward (:func:`remat_layer`);
    ``ln_impl``: :func:`_ln`; ``quantize``: :func:`_dense`."""

    def __init__(self, cfg: EncoderConfig, *, dtype=torch.float32,
                 device=None, attention_impl: str = "auto",
                 remat: bool = False, ln_impl: str = "xla",
                 quantize: str = "off"):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.embeddings = Embeddings(cfg, dtype=dtype, device=device,
                                     ln_impl=ln_impl, quantize=quantize)
        for i in range(cfg.num_layers):  # flax names: layer_0, layer_1, ...
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg, dtype=dtype, device=device, attention_impl=attention_impl,
                ln_impl=ln_impl, quantize=quantize))
        self.pooler = _dense(quantize, cfg.hidden_size, cfg.hidden_size, dtype,
                             device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        global_rows: GlobalRows = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        mask = attention_mask.to(torch.int32)
        hidden = self.embeddings(input_ids, token_type_ids, generator,
                                 global_rows)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            hidden = (remat_layer(layer, hidden, mask, generator, global_rows)
                      if remat else layer(hidden, mask, generator, global_rows))
        pooled = torch.tanh(self.pooler(first_token(hidden)))
        return hidden, pooled
