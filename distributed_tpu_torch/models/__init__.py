"""Model zoo of the port: the decoder-only LM, the reference's CNNs, the
ResNet family and the Vision Transformers."""

from .cnn import cifar_cnn, mnist_cnn
from .resnet import (
    resnet, resnet18, resnet34, resnet50, resnet101, resnet152,
)
from .transformer import transformer_block, transformer_lm
from .vit import vit, vit_base, vit_large, vit_small, vit_tiny

__all__ = [
    "cifar_cnn", "mnist_cnn", "resnet", "resnet18", "resnet34", "resnet50",
    "resnet101", "resnet152", "transformer_block", "transformer_lm", "vit",
    "vit_base", "vit_large", "vit_small", "vit_tiny",
]
