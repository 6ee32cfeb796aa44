"""Layers of the port (the subset its slices run: the LM, the CNNs,
ResNet and ViT), the augmentation layers ``RandomCrop``/``RandomFlip``,
``Remat``, the rematerializing wrapper,
``ScannedBlocks``, the weight-stacked block stack, ``PipelinedBlocks``,
its pipelined form, and ``MoE``, the mixture-of-experts layer."""

from . import activations, initializers
from .attention import MultiHeadAttention, PositionalEmbedding
from .augment import RandomCrop, RandomFlip
from .core import (
    Lambda, Layer, NameScope, Residual, Sequential, apply_layers,
    current_rng, rng_scope,
)
from .layers import (
    Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout, Embedding,
    Flatten, GlobalAvgPool2D, LayerNorm, MaxPool2D, SpaceToDepth,
)
from .moe import MoE
from .pipeline import PipelinedBlocks
from .remat import Remat
from .scan import STACKED_POOL_KEY, ScannedBlocks

__all__ = [
    "Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense", "Dropout",
    "Embedding", "Flatten", "GlobalAvgPool2D", "Lambda", "Layer",
    "LayerNorm", "MaxPool2D", "MoE", "MultiHeadAttention", "NameScope",
    "PipelinedBlocks", "PositionalEmbedding", "RandomCrop", "RandomFlip",
    "Remat", "Residual", "STACKED_POOL_KEY",
    "ScannedBlocks", "Sequential", "SpaceToDepth", "activations",
    "apply_layers", "current_rng", "initializers", "rng_scope",
]
