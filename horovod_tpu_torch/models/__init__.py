"""Models: the decoder-only transformer, the ResNet family, the small
MNIST nets, and the flax weight bridge."""

from .convert import (
    params_from_flax,
    params_to_numpy_tree,
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from .resnet import (
    BatchNorm,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    ResNetTiny,
)
from .simple import LeNet, MLP
from .transformer import (
    REMAT_POLICIES,
    Transformer,
    TransformerConfig,
    causal_dot_attention,
    gpt_small,
    gpt_tiny,
    init_params,
    llama3_8b,
    llama_7b,
    modeled_activation_bytes,
    resolve_remat_policies,
    rope,
)

__all__ = [
    "BatchNorm", "LeNet", "REMAT_POLICIES", "MLP", "ResNet", "ResNet18", "ResNet34",
    "ResNet50", "ResNet101", "ResNet152", "ResNetTiny", "Transformer",
    "TransformerConfig", "causal_dot_attention", "gpt_small", "gpt_tiny",
    "init_params", "llama3_8b", "llama_7b", "modeled_activation_bytes",
    "params_from_flax",
    "params_to_numpy_tree", "resnet_params_from_flax",
    "resnet_params_to_flax", "resolve_remat_policies", "rope",
]
