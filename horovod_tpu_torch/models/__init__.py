"""Models: the decoder-only transformer and the flax weight bridge."""

from .convert import params_from_flax
from .transformer import (
    Transformer,
    TransformerConfig,
    causal_dot_attention,
    gpt_tiny,
    init_params,
    llama3_8b,
    llama_7b,
    rope,
)

__all__ = [
    "Transformer", "TransformerConfig", "causal_dot_attention", "gpt_tiny",
    "init_params", "llama3_8b", "llama_7b", "params_from_flax", "rope",
]
