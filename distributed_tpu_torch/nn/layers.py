"""Standard layers, as the JAX package computes them: NHWC images.

Parameters are stored in f32; a layer built with ``dtype=`` casts its input
and its parameters to that dtype on every call (the JAX layers' per-layer
override). Layouts are the JAX package's: a Dense kernel is
``(din, units)`` and applies as ``x @ kernel``; a Conv2D kernel is HWIO
``(kh, kw, cin, filters)``, so a JAX tree loads with no transposes.
Activations between layers stay NHWC; a convolution or pooling views them
as NCHW with ``permute`` (the memory order is ``torch.channels_last``'s,
so cuDNN reads them in place) and permutes the result back.

A Conv2D with a 1x1 kernel is one matrix product over the NHWC rows and
runs through ``ops.conv1x1`` (kernel K12 on the card) at any stride: XLA's
SAME padding never pads a 1x1 window (its total, ``(ceil(n/s) - 1)*s + 1
- n``, is at most 0), so stride s is ``x[:, ::s, ::s]`` and then the
product. Every other window goes to cuDNN. BatchNorm's reductions run
through ``ops.bn_reduce`` (K13 forward, K14 backward).

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
from ..ops import bn_reduce
from ..ops.conv1x1 import conv1x1_apply
from ..parallel.strategy import current_strategy
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
    """2-D convolution over NHWC inputs with an HWIO kernel. A layer with
    ``use_bias=False`` registers no ``bias``, so its tree paths are the
    JAX layer's. The kernel is drawn glorot-uniform, the JAX layer's
    default and the only initializer its models use."""

    def __init__(
        self,
        filters: int,
        kernel_size: IntOr2,
        strides: IntOr2 = 1,
        padding: str = "valid",
        activation=None,
        use_bias: bool = True,
        kernel_initializer="glorot_uniform",
        dtype=None,
        name: Optional[str] = None,
    ):
        super().__init__(name)
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _check_padding(padding)
        self.activation = activations.get(activation)
        self.use_bias = use_bias
        if kernel_initializer != "glorot_uniform":
            raise NotImplementedError(
                f"Conv2D(kernel_initializer={kernel_initializer!r}): not yet "
                "ported")
        self.dtype = dtype

    def build(self, input_shape: Shape, generator):
        h, w, cin = input_shape
        kh, kw = self.kernel_size
        self.input_shape = tuple(input_shape)
        self.kernel = torch.nn.Parameter(initializers.glorot_uniform()(
            generator, (kh, kw, cin, self.filters)))
        if self.use_bias:
            self.bias = torch.nn.Parameter(torch.zeros(self.filters))
        return (_conv_out(h, kh, self.strides[0], self.padding),
                _conv_out(w, kw, self.strides[1], self.padding), self.filters)

    def forward(self, x):
        kernel = self.kernel
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            x = x.to(dt)
            kernel = kernel.to(dt)
        if self.kernel_size == (1, 1):
            sh, sw = self.strides
            if (sh, sw) != (1, 1):
                x = x[:, ::sh, ::sw]
            n, ho, wo, cin = x.shape
            y = conv1x1_apply(x.reshape(-1, cin),
                              kernel.reshape(cin, self.filters))
            y = y.reshape(n, ho, wo, self.filters)
        else:
            xn = _pad_nchw(x.permute(0, 3, 1, 2), self.kernel_size,
                           self.strides, self.padding)
            y = F.conv2d(xn, kernel.permute(3, 2, 0, 1), stride=self.strides)
            y = y.permute(0, 2, 3, 1)
        if self.use_bias:
            y = y + self.bias.to(y.dtype)
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


def _bn_normalize(x, mean, var, scale, bias, epsilon):
    """``(x - mean) * inv + bias`` with ``inv = rsqrt(var + eps) * scale``
    in f32, the rest in x's dtype, in the JAX layer's order."""
    dt = x.dtype
    inv = torch.rsqrt(var + epsilon) * scale
    return (x - mean.to(dt)) * inv.to(dt) + bias.to(dt)


class _BatchNormFn(torch.autograd.Function):
    """The JAX layer's ``_bn_norm`` and its custom VJP: normalize with the
    given statistics; the backward folds the statistics' gradients into dx
    (zero cotangents for mean and var) with K14's two sums. Under a
    strategy with replicas the sums are reduced over them for dx only:
    dscale and dbias are this rank's sums, and the strategy's gradient
    average (sum over ranks / P, each rank's loss the mean of its own
    rows) turns them into the global batch's."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, epsilon, strategy):
        ctx.save_for_backward(x, mean, var, scale)
        ctx.epsilon = epsilon
        ctx.strategy = strategy
        return _bn_normalize(x, mean, var, scale, bias, epsilon)

    @staticmethod
    def backward(ctx, dy):
        x, mean, var, scale = ctx.saved_tensors
        c = x.shape[-1]
        x2d = x.reshape(-1, c)
        inv0 = torch.rsqrt(var + ctx.epsilon)
        local = bn_reduce.bn_bwd_reduce(dy.reshape(-1, c).contiguous(), x2d,
                                        mean, inv0)
        total, n = local, x2d.shape[0]
        if ctx.strategy is not None:
            total = ctx.strategy.all_reduce_sum(local.clone())
            n *= ctx.strategy.num_replicas_in_sync
        xhat = (x.float() - mean) * inv0
        dx = (scale * inv0) * (dy.float() - total[0] / n
                               - xhat * (total[1] / n))
        return dx.to(x.dtype), None, None, local[1], local[0], None, None


class BatchNorm(Layer):
    """Batch normalization over all but the channel (last) axis, as the
    JAX layer computes it: parameters ``scale`` and ``bias``, f32 buffers
    ``mean`` and ``var`` (the JAX state tree's paths).

    In train mode the statistics are single-pass shifted moments: K13
    sums ``x - shift`` and its square, ``mean = shift + m1``, ``var =
    max(m2 - m1^2, 0)``; the shift is the running mean (``"running"``) or
    the mean of batch row 0 (``"data"``). The running statistics move to
    ``momentum * state + (1 - momentum) * stat`` in place, without
    gradients. Under a strategy with replicas (``current_strategy()``,
    which ``Model.fit`` sets) K13's sums are all-reduced and divided by
    the global count, and a ``"data"`` shift is rank 0's, so every rank
    sees the global batch's statistics (sync-BN, as GSPMD makes it in the
    JAX package). Eval mode normalizes with the running statistics.

    Not ``F.batch_norm``: its momentum weighs the batch, not the state,
    and its running variance is unbiased; the JAX layer's is not."""

    # Class-level defaults, as the JAX layer's ("reduce"/"dot"; "data"/
    # "running"). The JAX layer's "dot" computes the same sums as products
    # with a row of ones; here both names take K13 (or its plain version).
    stats_impl = "reduce"
    stats_shift = "data"

    def __init__(self, momentum: float = 0.9, epsilon: float = 1e-5,
                 stats_impl: Optional[str] = None,
                 stats_shift: Optional[str] = None, name=None):
        super().__init__(name)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        if stats_impl is not None:
            if stats_impl not in ("reduce", "dot"):
                raise ValueError(
                    f"stats_impl must be 'reduce' or 'dot', got {stats_impl!r}"
                )
            self.stats_impl = stats_impl
        if stats_shift is not None:
            if stats_shift not in ("data", "running"):
                raise ValueError(
                    f"stats_shift must be 'data' or 'running', got "
                    f"{stats_shift!r}"
                )
            self.stats_shift = stats_shift

    def build(self, input_shape: Shape, generator):
        c = input_shape[-1]
        self.input_shape = tuple(input_shape)
        self.scale = torch.nn.Parameter(torch.ones(c))
        self.bias = torch.nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        return tuple(input_shape)

    def forward(self, x):
        if not self.training:
            return _bn_normalize(x, self.mean, self.var, self.scale,
                                 self.bias, self.epsilon)
        strategy = current_strategy()
        c = x.shape[-1]
        x2d = x.reshape(-1, c)
        with torch.no_grad():
            if self.stats_shift == "running":
                shift = self.mean.clone()
            else:
                shift = x[:1].float().mean(dim=tuple(range(x.dim() - 1)))
                if strategy is not None:
                    shift = strategy.broadcast(shift)
            sums = bn_reduce.bn_stats(x2d.detach(), shift)
            n = x2d.shape[0]
            if strategy is not None:
                sums = strategy.all_reduce_sum(sums)
                n *= strategy.num_replicas_in_sync
            m1, m2 = sums[0] / n, sums[1] / n
            mean = shift + m1
            var = torch.clamp_min(m2 - m1.square(), 0.0)
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return _BatchNormFn.apply(x, mean, var, self.scale, self.bias,
                                  self.epsilon, strategy)


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


class SpaceToDepth(Layer):
    """(N, H, W, C) -> (N, H/b, W/b, C*b*b): each b x b spatial block
    becomes one position, its entries in (row, column, channel) order, as
    the JAX layer's reshape and transpose order them."""

    def __init__(self, block_size: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.block_size = int(block_size)

    def build(self, input_shape: Shape, generator):
        h, w, c = input_shape
        b = self.block_size
        if h % b or w % b:
            raise ValueError(
                f"SpaceToDepth({b}) needs spatial dims divisible by {b}; "
                f"got {(h, w)}"
            )
        return (h // b, w // b, c * b * b)

    def forward(self, x):
        n, h, w, c = x.shape
        b = self.block_size
        x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, c * b * b)


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
    "Activation", "AvgPool2D", "BatchNorm", "Conv2D", "Dense", "Embedding",
    "Flatten", "GlobalAvgPool2D", "LayerNorm", "MaxPool2D", "SpaceToDepth",
]
