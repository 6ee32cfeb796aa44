"""Standard layers, as the JAX package computes them: NHWC images.

Parameters are stored in f32; a layer built with ``dtype=`` casts its input
and its parameters to that dtype on every call (the JAX layers' per-layer
override). Layouts are the JAX package's: a Dense kernel is
``(din, units)`` and applies as ``x @ kernel``; a Conv2D kernel is HWIO
``(kh, kw, cin, filters)``, so a JAX tree loads with no transposes.
Activations between layers stay NHWC; a convolution or pooling views them
as NCHW with ``permute`` (the memory order is ``torch.channels_last``'s,
so cuDNN reads them in place) and permutes the result back.

``padding="same"`` is XLA's: the total padding of a dimension of size n
with window k and stride s is ``max((ceil(n/s) - 1)*s + k - n, 0)``,
``total // 2`` before and the rest after (one more after than before for
even windows). torch's own ``padding="same"`` refuses strides above 1 and
pads the other way round, so the layers pad explicitly with ``F.pad``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import activations, initializers
from .core import Layer, Shape
from ..precision import resolve_dtype

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out(size: int, k: int, s: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // s)
    return (size - k) // s + 1


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) of XLA's SAME padding for one dimension."""
    total = max((_conv_out(size, k, s, "SAME") - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, window, strides, padding, value=0.0):
    """``x`` (N, C, H, W) padded as XLA pads for ``padding`` (VALID: not
    at all)."""
    if padding != "SAME":
        return x
    top, bottom = _same_pads(x.shape[2], window[0], strides[0])
    left, right = _same_pads(x.shape[3], window[1], strides[1])
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _check_padding(padding: str) -> str:
    padding = padding.upper()
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    return padding


class Conv2D(Layer):
    """2-D convolution over NHWC inputs with an HWIO kernel."""

    def __init__(
        self,
        filters: int,
        kernel_size: IntOr2,
        strides: IntOr2 = 1,
        padding: str = "valid",
        activation=None,
        dtype=None,
        name: Optional[str] = None,
    ):
        super().__init__(name)
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _check_padding(padding)
        self.activation = activations.get(activation)
        self.dtype = dtype

    def build(self, input_shape: Shape, generator):
        h, w, cin = input_shape
        kh, kw = self.kernel_size
        self.kernel = torch.nn.Parameter(initializers.glorot_uniform()(
            generator, (kh, kw, cin, self.filters)))
        self.bias = torch.nn.Parameter(torch.zeros(self.filters))
        return (_conv_out(h, kh, self.strides[0], self.padding),
                _conv_out(w, kw, self.strides[1], self.padding), self.filters)

    def forward(self, x):
        kernel = self.kernel
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            x = x.to(dt)
            kernel = kernel.to(dt)
        xn = _pad_nchw(x.permute(0, 3, 1, 2), self.kernel_size, self.strides,
                       self.padding)
        y = F.conv2d(xn, kernel.permute(3, 2, 0, 1), stride=self.strides)
        y = y.permute(0, 2, 3, 1) + self.bias.to(y.dtype)
        return self.activation(y)


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


class Flatten(Layer):
    """(N, ...) -> (N, prod(...)) in the input's logical (H, W, C) order,
    as the JAX layer's reshape of an NHWC array."""

    def build(self, input_shape: Shape, generator):
        out = 1
        for d in input_shape:
            out *= d
        return (out,)

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(Layer):
    def __init__(self, activation, name=None):
        super().__init__(name)
        self.fn = activations.get(activation)

    def build(self, input_shape: Shape, generator):
        return tuple(input_shape)

    def forward(self, x):
        return self.fn(x)


class _Pool2D(Layer):
    def __init__(self, pool_size: IntOr2 = 2, strides: Optional[IntOr2] = None,
                 padding="valid", name=None):
        super().__init__(name)
        self.pool_size = _pair(pool_size)
        self.strides = (_pair(strides) if strides is not None
                        else self.pool_size)
        self.padding = _check_padding(padding)

    def build(self, input_shape: Shape, generator):
        h, w, c = input_shape
        return (_conv_out(h, self.pool_size[0], self.strides[0], self.padding),
                _conv_out(w, self.pool_size[1], self.strides[1], self.padding),
                c)

    def forward(self, x):
        return self._reduce(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaxPool2D(_Pool2D):
    """Max over each window; SAME pads with -inf, as XLA's reduce_window."""

    def _reduce(self, xn):
        xn = _pad_nchw(xn, self.pool_size, self.strides, self.padding,
                       value=float("-inf"))
        return F.max_pool2d(xn, self.pool_size, self.strides)


class AvgPool2D(_Pool2D):
    """Mean over the VALID elements of each window: a sum-pool of the
    padded input over a sum-pool of padded ones, as the JAX layer divides
    (torch's ``count_include_pad=False`` cannot tell an explicit
    asymmetric pad from data)."""

    def _reduce(self, xn):
        def window_sums(t):
            t = _pad_nchw(t, self.pool_size, self.strides, self.padding)
            return F.avg_pool2d(t, self.pool_size, self.strides,
                                divisor_override=1)

        return window_sums(xn) / window_sums(torch.ones_like(xn))


class GlobalAvgPool2D(Layer):
    """(N, H, W, C) -> (N, C): the mean over H and W."""

    def build(self, input_shape: Shape, generator):
        return (input_shape[-1],)

    def forward(self, x):
        return x.mean(dim=(1, 2))


__all__ = [
    "Activation", "AvgPool2D", "Conv2D", "Dense", "Embedding", "Flatten",
    "GlobalAvgPool2D", "LayerNorm", "MaxPool2D",
]
