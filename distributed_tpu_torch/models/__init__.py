"""Model zoo of the port: the decoder-only LM and the reference's CNNs."""

from .cnn import cifar_cnn, mnist_cnn
from .transformer import transformer_block, transformer_lm

__all__ = ["cifar_cnn", "mnist_cnn", "transformer_block", "transformer_lm"]
