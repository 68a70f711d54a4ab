"""Encoder architecture configs.

The reference delegates architecture to HF ``BertModel``/``RobertaModel``
(model/model.py:9-10,20-25), exposing only dropout/layer-norm knobs through its
model parser (parser.py:70-74). Here the encoder is first-party, so the full
architecture is explicit; presets cover the reference's supported checkpoints
(``bert-base-uncased``/``roberta-base``, parser.py:66-68) plus the large
variants used by the benchmark matrix (BASELINE.md rows 3-4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    model_type: str = "bert"  # 'bert' | 'roberta'
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # RoBERTa reserves position ids 0/1 (pad handling); real positions start at 2.
    position_offset: int = 0
    num_labels: int = 5

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads


MODEL_PRESETS = {
    # google/bert_uncased_L-2_H-128_A-2 dims — CI smoke runs and CPU-mesh
    # integration tests; shares the full bert vocab so any bert tokenizer ids
    # stay in range
    "bert-tiny": EncoderConfig(
        model_type="bert", vocab_size=30522, hidden_size=128, num_layers=2,
        num_heads=2, intermediate_size=512,
    ),
    "bert-base-uncased": EncoderConfig(
        model_type="bert", vocab_size=30522, hidden_size=768, num_layers=12,
        num_heads=12, intermediate_size=3072,
    ),
    "bert-large-uncased": EncoderConfig(
        model_type="bert", vocab_size=30522, hidden_size=1024, num_layers=24,
        num_heads=16, intermediate_size=4096,
    ),
    "roberta-base": EncoderConfig(
        model_type="roberta", vocab_size=50265, hidden_size=768, num_layers=12,
        num_heads=12, intermediate_size=3072, max_position_embeddings=514,
        type_vocab_size=1, pad_token_id=1, position_offset=2, layer_norm_eps=1e-5,
    ),
    "roberta-large": EncoderConfig(
        model_type="roberta", vocab_size=50265, hidden_size=1024, num_layers=24,
        num_heads=16, intermediate_size=4096, max_position_embeddings=514,
        type_vocab_size=1, pad_token_id=1, position_offset=2, layer_norm_eps=1e-5,
    ),
}


def resolve_model_config(model_params, *, num_labels: int = 5) -> EncoderConfig:
    """Build the encoder config from parsed model params (init.py:51-82 parity:
    dropout/layer-norm overrides are applied on top of the preset)."""
    name = getattr(model_params, "model", "bert-base-uncased")
    preset = MODEL_PRESETS[name]
    # long-context: an explicit --max_position_embeddings widens the
    # position table past the preset's (positions beyond it are a
    # trace-time error in Embeddings, never a silent clamp)
    mpe = getattr(model_params, "max_position_embeddings", None) \
        or preset.max_position_embeddings
    return dataclasses.replace(
        preset,
        hidden_dropout_prob=getattr(model_params, "hidden_dropout_prob", preset.hidden_dropout_prob),
        attention_probs_dropout_prob=getattr(
            model_params, "attention_probs_dropout_prob", preset.attention_probs_dropout_prob
        ),
        layer_norm_eps=getattr(model_params, "layer_norm_eps", preset.layer_norm_eps),
        max_position_embeddings=mpe,
        num_labels=num_labels,
    )
