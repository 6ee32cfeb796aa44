"""Dense, LayerNorm and Embedding, as the JAX package computes them.

Parameters are stored in f32; a layer built with ``dtype=`` casts its input
and its parameters to that dtype on every call (the JAX layers' per-layer
override). Layouts are the JAX package's: a Dense kernel is
``(din, units)`` and applies as ``x @ kernel``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import activations, initializers
from .core import Layer, Shape
from ..precision import resolve_dtype


class Dense(Layer):
    """Affine map on the trailing axis; works for (B, D) and (B, T, D) alike."""

    def __init__(
        self,
        units: int,
        activation=None,
        dtype=None,
        name: Optional[str] = None,
    ):
        super().__init__(name)
        self.units = int(units)
        self.activation = activations.get(activation)
        self.dtype = dtype

    def build(self, input_shape: Shape, generator):
        din = input_shape[-1]
        self.kernel = torch.nn.Parameter(initializers.glorot_uniform()(
            generator, (din, self.units)))
        self.bias = torch.nn.Parameter(torch.zeros(self.units))
        return tuple(input_shape[:-1]) + (self.units,)

    def forward(self, x):
        kernel = self.kernel
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            x = x.to(dt)
            kernel = kernel.to(dt)
        y = x @ kernel + self.bias.to(x.dtype)
        return self.activation(y)


class LayerNorm(Layer):
    """Normalizes the trailing axis in f32 (population variance,
    ``epsilon`` 1e-6 — not torch's 1e-5) and casts back to ``x.dtype``."""

    epsilon = 1e-6

    def build(self, input_shape: Shape, generator):
        d = input_shape[-1]
        self.scale = torch.nn.Parameter(torch.ones(d))
        self.bias = torch.nn.Parameter(torch.zeros(d))
        return tuple(input_shape)

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        return y.to(x.dtype)


class Embedding(Layer):
    def __init__(self, vocab_size: int, dim: int, dtype=None, name=None):
        super().__init__(name)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.dtype = dtype

    def build(self, input_shape: Shape, generator):
        self.table = torch.nn.Parameter(initializers.normal(0.02)(
            generator, (self.vocab_size, self.dim)))
        return tuple(input_shape) + (self.dim,)

    def forward(self, x):
        # Gather, then cast only the gathered rows: the same values as
        # casting the whole table first, without the table-sized copy.
        rows = self.table[x.long()]
        dt = resolve_dtype(self.dtype)
        return rows if dt is None else rows.to(dt)


__all__ = ["Dense", "Embedding", "LayerNorm"]
