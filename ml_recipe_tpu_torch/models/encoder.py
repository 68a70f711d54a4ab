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
- sequence packing (``data/packing.collate_packed``): ``position_ids``
  ``[B, L]`` replace the ``arange`` positions (each segment's restart at 0,
  a fragment's continue at its offset), ``segment_ids`` reach every
  layer's attention, which then runs the kernels' block-diagonal mode, and
  with ``segment_starts`` ``[B, S]`` the pooler reads each segment's own
  first row, giving ``[B, S, H]`` (absent segments read row 0 and are
  masked downstream);
- ``remat`` (``--remat``, flax ``nn.remat`` around each ``EncoderLayer``)
  keeps only each layer's input for the backward and recomputes the layer
  there (``torch.utils.checkpoint``). The recompute replays the layer's
  draws from the caller's generator (:func:`remat_layer`), so remat on and
  off give the same gradients;
- sequence parallelism (``attention_impl='ring'`` with a ``mesh`` whose
  ``seq`` axis is S > 1): the trunk takes the whole ``[B, L]`` inputs and
  runs on this rank's block of ``L / S`` tokens (``seq_index``), embedded
  at their global positions; every attention is the ring over the ``seq``
  group (``ops/ring_attention.py``); each hidden-dropout mask is drawn at
  the whole ``[B, L, H]`` shape and this block kept (``seq=(index, S)``),
  so the draws do not depend on S; after the last layer the blocks are
  gathered (``parallel.collectives.seq_gather``, whose backward sums the
  group's gradients), and the pooler and everything after it see the whole
  sequence on every rank of the group;
- tensor parallelism (a ``mesh`` whose ``model`` axis is T > 1, the JAX
  package's Megatron-style ``TP_RULES``): each rank of a ``model`` group
  holds ``num_heads / T`` heads (its ``query``, ``key`` and ``value`` are
  ``H -> H/T``, its ``attention.output`` ``H/T -> H``) and ``I / T`` MLP
  columns (``intermediate`` ``H -> I/T``, ``mlp.output`` ``I/T -> H``),
  rank ``r``'s slice starting at ``r/T`` of each split dimension. The
  block's input passes ``copy_to_model`` (its gradient is summed over the
  group) and each row-split product's partial sum ``reduce_from_model``
  (``parallel/collectives.py``), after which the whole bias is added once.
  Hidden dropout, the residual and the LayerNorm act on the all-reduced
  ``[B, L, H]``; every rank of the group draws from the same generator,
  so their masks agree, and local head ``j`` of rank ``r`` draws global
  head ``r*H/T + j``'s attention-dropout mask
  (``ops.attention.model_row_seeds``). The embeddings, the pooler and the
  heads stay whole on every rank. :func:`init_weights
  <ml_recipe_tpu_torch.models.qa_model.init_weights>` draws each split
  weight at its whole shape and keeps the slice, so one seed gives every
  rank the slice of one process's weights. A pipeline stage
  (``pipe:K,model:T``) runs :meth:`TransformerEncoder.run_layers` of its
  range on these layers, each layer drawing from the generator of its
  (step, micro-batch, layer), the same on every rank of the group.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    dot_product_attention,
    dropout_seed,
    global_row_seeds,
    model_row_seeds,
)
from ..ops.layer_norm import layer_norm, layer_norm_q8
from ..parallel.collectives import copy_to_model, seq_gather
from ..parallel.mesh import check_model_split
from ..parallel.sharding import seq_split
from ..quant.layers import QuantLinear, first_token, with_row_codes
from .config import EncoderConfig

# (first, total): the batch's rows are rows first .. first + B of a global
# micro-batch of `total` rows (data parallelism); None: the batch is whole
GlobalRows = Optional[Tuple[int, int]]
# (index, size): the batch's tokens are block `index` of `size` equal
# blocks of the sequence (sequence parallelism); None: the sequence is whole
SeqBlock = Optional[Tuple[int, int]]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            global_rows: GlobalRows = None,
            seq: SeqBlock = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1/(1-rate)``; the mask is drawn from ``generator``, at
    the global micro-batch's shape when ``global_rows`` is given (of which
    ``x``'s rows are kept), and at the whole sequence's length when ``seq``
    is given (of which ``x``'s block of dim 1 is kept)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator "
                         "(pass generator=... to the model's forward)")
    shape = list(x.shape)
    rows = slice(None)
    if global_rows is not None:
        first, total = global_rows
        shape[0], rows = total, slice(first, first + x.shape[0])
    cols = slice(None)
    if seq is not None and seq[1] > 1:
        L = x.shape[1]
        shape[1], cols = L * seq[1], slice(seq[0] * L, (seq[0] + 1) * L)
    u = torch.rand(shape, generator=generator, device=x.device)
    if global_rows is not None or seq is not None:
        u = u[rows, cols] if x.dim() > 1 else u[rows]
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
    """``nn.Dense(dtype=compute_dtype)``: f32 params, cast at each use.

    Under tensor parallelism ``split`` is ``(dim, index, size)``: the
    weight is rank ``index``'s slice of ``size`` along ``dim`` of the whole
    ``[out, in]`` weight (:func:`_split_dense`); a row-split product
    (``dim`` 1) sums its partial product over the ``model`` group
    (``reduce``, ``parallel.collectives.reduce_from_model``) before it adds
    its whole bias."""

    def __init__(self, n_in: int, n_out: int, dtype, device):
        super().__init__(n_in, n_out, device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        self.split = None
        self.reduce = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if self.reduce is None:
            return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))
        from ..parallel.collectives import reduce_from_model

        y = reduce_from_model(F.linear(x.to(cd), self.weight.to(cd)),
                              self.reduce)
        return y + self.bias.to(cd)


def _split_dense(quantize: str, n_in: int, n_out: int, dtype, device, tp,
                 dim: int) -> nn.Module:
    """:func:`_dense` of rank ``tp.model_index``'s slice of an ``n_in ->
    n_out`` product split over the ``model`` group of ``tp`` (a mesh)
    along ``dim`` of the weight: 0 (columns of the product, the
    output's), 1 (rows, the input's; the partial sums are all-reduced).
    ``tp`` None: the whole product."""
    if tp is None:
        return _dense(quantize, n_in, n_out, dtype, device)
    if quantize not in (None, "off"):
        raise ValueError("quantize='int8' runs on one device; tensor "
                         "parallelism is for training")
    T = tp.model_size
    shape = [n_out // T, n_in] if dim == 0 else [n_out, n_in // T]
    dense = Linear(shape[1], shape[0], dtype, device)
    dense.split = (dim, tp.model_index, T)
    if dim == 1:
        dense.reduce = tp.model_transport
    return dense


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
                global_rows: GlobalRows = None,
                position_ids: Optional[torch.Tensor] = None,
                seq: SeqBlock = None) -> torch.Tensor:
        cfg = self.cfg
        L_loc = input_ids.shape[-1]
        first = seq[0] * L_loc if seq is not None else 0
        L = L_loc * (seq[1] if seq is not None else 1)
        if L + cfg.position_offset > cfg.max_position_embeddings:
            # the JAX module's trace-time guard: never a silent clamp of
            # positions past the table. Packed positions are per segment
            # (below each segment's length, itself at most L), so the
            # bound on L covers them
            raise ValueError(
                f"sequence length {L} (+offset {cfg.position_offset}) "
                f"exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}; widen the position table "
                f"(--max_position_embeddings) for long-context runs"
            )
        if position_ids is None:   # this block's global positions
            positions = torch.arange(first, first + L_loc,
                                     device=input_ids.device)[None]
        else:
            positions = position_ids.long()
        if cfg.type_vocab_size <= 1:
            token_type_ids = torch.zeros_like(token_type_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions + cfg.position_offset)
             + self.token_type_embeddings(token_type_ids))
        return dropout(self.layer_norm(x), cfg.hidden_dropout_prob,
                       self.training, generator, global_rows, seq)


class SelfAttention(nn.Module):
    """``tp``: a mesh whose ``model`` axis splits the heads (see the module
    docstring), or None."""

    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 attention_impl: str = "auto", ln_impl: str = "xla",
                 quantize: str = "off", mesh=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.attention_impl = attention_impl
        self.mesh = mesh
        self.tp = tp
        H = cfg.hidden_size
        self.query = _split_dense(quantize, H, H, dtype, device, tp, 0)
        self.key = _split_dense(quantize, H, H, dtype, device, tp, 0)
        self.value = _split_dense(quantize, H, H, dtype, device, tp, 0)
        self.output = _split_dense(quantize, H, H, dtype, device, tp, 1)
        self.layer_norm = _ln(cfg, dtype, ln_impl, device, quantize)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None,
                segment_ids: Optional[torch.Tensor] = None,
                seq: SeqBlock = None) -> torch.Tensor:
        cfg = self.cfg
        B, L, H = hidden.shape
        ring = self.attention_impl == "ring"
        tp = self.tp
        T = tp.model_size if tp is not None else 1
        x = (copy_to_model(hidden, tp.model_transport) if tp is not None
             else hidden)

        def heads(proj: nn.Module) -> torch.Tensor:
            return proj(x).view(B, L, cfg.num_heads // T, cfg.head_dim)

        rate = cfg.attention_probs_dropout_prob if self.training else 0.0
        seed = None
        if rate > 0.0:
            if generator is None:
                raise ValueError("training-mode attention dropout needs a "
                                 "torch.Generator (generator=...)")
            seed = dropout_seed(generator)
            # the ring folds the data index into its own row seeds
            if global_rows is not None and not ring:
                seed = global_row_seeds(seed, global_rows[0], B,
                                        global_rows[1], cfg.num_heads)
            if tp is not None:   # this rank's heads are global heads r*H/T+j
                seed = model_row_seeds(seed, B, cfg.num_heads,
                                       tp.model_index, T)
        ctx = dot_product_attention(
            heads(self.query), heads(self.key), heads(self.value), mask,
            dropout_rate=rate, seed=seed, impl=self.attention_impl,
            segment_ids=segment_ids, mesh=self.mesh if ring else None,
        )
        out = dropout(self.output(ctx.reshape(B, L, H // T)),
                      cfg.hidden_dropout_prob, self.training, generator,
                      global_rows, seq)
        return self.layer_norm(hidden + out)


class FeedForward(nn.Module):
    """``tp``: a mesh whose ``model`` axis splits the intermediate columns
    (see the module docstring), or None."""

    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 ln_impl: str = "xla", quantize: str = "off", tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.intermediate = _split_dense(quantize, cfg.hidden_size,
                                         cfg.intermediate_size, dtype, device,
                                         tp, 0)
        self.output = _split_dense(quantize, cfg.intermediate_size,
                                   cfg.hidden_size, dtype, device, tp, 1)
        self.layer_norm = _ln(cfg, dtype, ln_impl, device, quantize)

    def forward(self, hidden: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None,
                seq: SeqBlock = None) -> torch.Tensor:
        tp = self.tp
        x = (copy_to_model(hidden, tp.model_transport) if tp is not None
             else hidden)
        y = F.gelu(self.intermediate(x), approximate="none")
        y = dropout(self.output(y), self.cfg.hidden_dropout_prob,
                    self.training, generator, global_rows, seq)
        return self.layer_norm(hidden + y)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, *, dtype, device,
                 attention_impl: str = "auto", ln_impl: str = "xla",
                 quantize: str = "off", mesh=None, tp=None):
        super().__init__()
        self.attention = SelfAttention(cfg, dtype=dtype, device=device,
                                       attention_impl=attention_impl,
                                       ln_impl=ln_impl, quantize=quantize,
                                       mesh=mesh, tp=tp)
        self.mlp = FeedForward(cfg, dtype=dtype, device=device,
                               ln_impl=ln_impl, quantize=quantize, tp=tp)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                global_rows: GlobalRows = None,
                segment_ids: Optional[torch.Tensor] = None,
                seq: SeqBlock = None) -> torch.Tensor:
        return self.mlp(self.attention(hidden, mask, generator, global_rows,
                                       segment_ids, seq),
                        generator, global_rows, seq)


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
    ``ln_impl``: :func:`_ln`; ``quantize``: :func:`_dense`; ``mesh``: the
    process mesh whose ``seq`` ring ``attention_impl='ring'`` runs over,
    or whose ``model`` axis (> 1) splits every layer's heads and MLP
    columns (``tp``, that mesh, else None)."""

    def __init__(self, cfg: EncoderConfig, *, dtype=torch.float32,
                 device=None, attention_impl: str = "auto",
                 remat: bool = False, ln_impl: str = "xla",
                 quantize: str = "off", mesh=None):
        super().__init__()
        if attention_impl == "ring" and (mesh is None or mesh.seq_size < 2):
            raise ValueError("attention_impl='ring' needs a mesh with a "
                             "'seq' axis > 1 (--mesh 'data:N,seq:M')")
        self.cfg = cfg
        self.remat = remat
        self.mesh = mesh if attention_impl == "ring" else None
        self.tp = (mesh if mesh is not None and mesh.model_size > 1
                   else None)
        if self.tp is not None:
            check_model_split(cfg.num_heads, cfg.intermediate_size,
                              mesh.model_size)
        self.embeddings = Embeddings(cfg, dtype=dtype, device=device,
                                     ln_impl=ln_impl, quantize=quantize)
        for i in range(cfg.num_layers):  # flax names: layer_0, layer_1, ...
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg, dtype=dtype, device=device, attention_impl=attention_impl,
                ln_impl=ln_impl, quantize=quantize, mesh=self.mesh,
                tp=self.tp))
        self.pooler = _dense(quantize, cfg.hidden_size, cfg.hidden_size, dtype,
                             device)

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
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        mask = attention_mask.to(torch.int32)
        seq = None
        if self.mesh is not None:   # this rank's block of every [B, L] input
            mesh = self.mesh
            seq = (mesh.seq_index, mesh.seq_size)
            input_ids, mask, token_type_ids, position_ids, segment_ids = (
                None if x is None else seq_split(x, *seq)
                for x in (input_ids, mask, token_type_ids, position_ids,
                          segment_ids))
        hidden = self.embeddings(input_ids, token_type_ids, generator,
                                 global_rows, position_ids, seq)
        hidden = self.run_layers(hidden, mask, 0, self.cfg.num_layers,
                                 generator, global_rows, segment_ids, seq)
        if seq is not None:
            hidden = seq_gather(hidden, self.mesh.seq_group, *seq)
        return hidden, self.pool(hidden, segment_starts)

    def run_layers(self, hidden: torch.Tensor, mask: torch.Tensor, lo: int,
                   hi: int, generator=None, global_rows: GlobalRows = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   seq: SeqBlock = None) -> torch.Tensor:
        """Layers ``lo .. hi - 1`` on ``hidden`` (a pipeline stage runs its
        own range, ``parallel/pipeline.py``). ``generator`` is one
        ``torch.Generator`` every layer draws from in turn, or a callable
        giving layer ``i``'s own (the pipeline's per-layer streams)."""
        mask = mask.to(torch.int32)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(lo, hi):
            layer = getattr(self, f"layer_{i}")
            gen = generator(i) if callable(generator) else generator
            if segment_ids is not None or seq is not None:
                layer = functools.partial(layer, segment_ids=segment_ids,
                                          seq=seq)
            hidden = (remat_layer(layer, hidden, mask, gen, global_rows)
                      if remat else layer(hidden, mask, gen, global_rows))
        return hidden

    def pool(self, hidden: torch.Tensor,
             segment_starts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pooler on each row's first token (each packed segment's)."""
        return torch.tanh(self.pooler(first_token(hidden, segment_starts)))
