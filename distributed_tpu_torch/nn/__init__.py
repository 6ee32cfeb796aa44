"""Layers of the port (the subset its slices run: the LM, the CNNs and
ResNet), and ``Remat``, the rematerializing wrapper."""

from . import activations, initializers
from .attention import MultiHeadAttention, PositionalEmbedding
from .core import Layer, NameScope, Residual, Sequential, apply_layers
from .layers import (
    Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Embedding, Flatten,
    GlobalAvgPool2D, LayerNorm, MaxPool2D, SpaceToDepth,
)
from .remat import Remat

__all__ = [
    "Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense", "Embedding",
    "Flatten", "GlobalAvgPool2D", "Layer", "LayerNorm", "MaxPool2D",
    "MultiHeadAttention", "NameScope", "PositionalEmbedding", "Remat",
    "Residual", "Sequential", "SpaceToDepth", "activations", "apply_layers",
    "initializers",
]
