"""Layers of the port (the subset its slices run: the LM and the CNNs)."""

from . import activations, initializers
from .attention import MultiHeadAttention, PositionalEmbedding
from .core import Layer, NameScope, Residual, Sequential
from .layers import (
    Activation, AvgPool2D, Conv2D, Dense, Embedding, Flatten, GlobalAvgPool2D,
    LayerNorm, MaxPool2D,
)

__all__ = [
    "Activation", "AvgPool2D", "Conv2D", "Dense", "Embedding", "Flatten",
    "GlobalAvgPool2D", "Layer", "LayerNorm", "MaxPool2D", "MultiHeadAttention",
    "NameScope", "PositionalEmbedding", "Residual", "Sequential",
    "activations", "initializers",
]
