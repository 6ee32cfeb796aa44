"""Layers of the port (the subset the serving slice runs)."""

from . import activations, initializers
from .attention import MultiHeadAttention, PositionalEmbedding
from .core import Layer, NameScope, Residual, Sequential
from .layers import Dense, Embedding, LayerNorm

__all__ = [
    "Dense", "Embedding", "Layer", "LayerNorm", "MultiHeadAttention",
    "NameScope", "PositionalEmbedding", "Residual", "Sequential",
    "activations", "initializers",
]
