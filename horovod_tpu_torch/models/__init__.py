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
    Transformer,
    TransformerConfig,
    causal_dot_attention,
    gpt_small,
    gpt_tiny,
    init_params,
    llama3_8b,
    llama_7b,
    rope,
)

__all__ = [
    "BatchNorm", "LeNet", "MLP", "ResNet", "ResNet18", "ResNet34",
    "ResNet50", "ResNet101", "ResNet152", "ResNetTiny", "Transformer",
    "TransformerConfig", "causal_dot_attention", "gpt_small", "gpt_tiny",
    "init_params", "llama3_8b", "llama_7b", "params_from_flax",
    "params_to_numpy_tree", "resnet_params_from_flax",
    "resnet_params_to_flax", "rope",
]
