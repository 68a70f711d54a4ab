from .config import MODEL_PRESETS, EncoderConfig, resolve_model_config
from .convert import from_jax_params, to_jax_params
from .encoder import TransformerEncoder
from .qa_model import QA_OUTPUT_KEYS, QAModel, init_weights

__all__ = [
    "MODEL_PRESETS", "EncoderConfig", "resolve_model_config",
    "from_jax_params", "to_jax_params", "TransformerEncoder",
    "QA_OUTPUT_KEYS", "QAModel", "init_weights",
]
