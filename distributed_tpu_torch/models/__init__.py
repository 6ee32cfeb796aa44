"""Model zoo of the port: the decoder-only LM, the reference's CNNs and
the ResNet family."""

from .cnn import cifar_cnn, mnist_cnn
from .resnet import (
    resnet, resnet18, resnet34, resnet50, resnet101, resnet152,
)
from .transformer import transformer_block, transformer_lm

__all__ = [
    "cifar_cnn", "mnist_cnn", "resnet", "resnet18", "resnet34", "resnet50",
    "resnet101", "resnet152", "transformer_block", "transformer_lm",
]
