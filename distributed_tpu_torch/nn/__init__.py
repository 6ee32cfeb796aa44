"""Layers of the port (the subset its slices run: the LM, the CNNs and
ResNet)."""

from . import activations, initializers
from .attention import MultiHeadAttention, PositionalEmbedding
from .core import Layer, NameScope, Residual, Sequential
from .layers import (
    Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Embedding, Flatten,
    GlobalAvgPool2D, LayerNorm, MaxPool2D, SpaceToDepth,
)

__all__ = [
    "Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense", "Embedding",
    "Flatten", "GlobalAvgPool2D", "Layer", "LayerNorm", "MaxPool2D",
    "MultiHeadAttention", "NameScope", "PositionalEmbedding", "Residual",
    "Sequential", "SpaceToDepth", "activations", "initializers",
]
