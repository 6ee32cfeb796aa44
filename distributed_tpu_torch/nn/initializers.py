"""Weight initializers, each drawn from an explicit ``torch.Generator``.

The JAX package's names (``jax.nn.initializers``) with JAX's
DISTRIBUTIONS, not JAX's bits: the two generators differ, so parity tests
carry weights across (``interop.params_from_jax``) instead of matching
seeds. The ``*_normal`` initializers are ``variance_scaling(scale, mode,
"truncated_normal")`` as in JAX: a standard normal truncated to ``[-2,
2]``, times ``sqrt(scale / n) / 0.87962566103423978`` (the standard
deviation of that truncated normal), ``n`` the fan of ``mode``; the
``*_uniform`` ones are uniform on ``[-limit, limit]`` with ``limit =
sqrt(3 * scale / n)``. Fans as JAX computes them: the last two axes are
(in, out), every leading axis multiplies both (a conv's receptive field).
"""

from __future__ import annotations

import math

import torch

#: The standard deviation of a standard normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _fans(shape):
    """(fan_in, fan_out), as ``jax.nn.initializers``' ``_compute_fans``."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(scale: float, mode: str, distribution: str):
    """``jax.nn.initializers.variance_scaling`` for the modes ``fan_in``,
    ``fan_out``, ``fan_avg`` and the distributions ``truncated_normal``
    and ``uniform``."""
    if mode not in ("fan_in", "fan_out", "fan_avg"):
        raise ValueError(f"invalid mode {mode!r}")
    if distribution not in ("truncated_normal", "uniform"):
        raise ValueError(f"invalid distribution {distribution!r}")

    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(tuple(shape))
        n = {"fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        variance = scale / n
        if distribution == "uniform":
            limit = math.sqrt(3.0 * variance)
            u = torch.rand(shape, generator=generator, dtype=dtype)
            return (2.0 * u - 1.0) * limit
        t = torch.empty(shape, dtype=dtype)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t * (math.sqrt(variance) / _TRUNC_STD)

    return init


def glorot_uniform():
    """Uniform on ``[-limit, limit]``, ``limit = sqrt(6 / (fan_in + fan_out))``."""

    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return (2.0 * u - 1.0) * limit

    return init


def glorot_normal():
    return variance_scaling(1.0, "fan_avg", "truncated_normal")


def he_uniform():
    return variance_scaling(2.0, "fan_in", "uniform")


def he_normal():
    return variance_scaling(2.0, "fan_in", "truncated_normal")


def lecun_normal():
    return variance_scaling(1.0, "fan_in", "truncated_normal")


def zeros():
    def init(generator, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    return init


def ones():
    def init(generator, shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)

    return init


def normal(stddev=0.01):
    """Gaussian with mean 0 and standard deviation ``stddev``."""

    def init(generator, shape, dtype=torch.float32):
        return torch.randn(shape, generator=generator, dtype=dtype) * stddev

    return init


_REGISTRY = {
    "glorot_uniform": glorot_uniform, "glorot_normal": glorot_normal,
    "he_uniform": he_uniform, "he_normal": he_normal,
    "lecun_normal": lecun_normal, "zeros": zeros, "ones": ones,
}


def get(name_or_fn, dtype=torch.float32):
    """An initializer by the JAX package's name, or a callable
    ``init(generator, shape)`` as it is; an unknown name raises
    ``ValueError``, as in JAX. ``dtype`` is the JAX signature's, and
    unused there too: the layers cast what they draw."""
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]()
    except KeyError:
        raise ValueError(
            f"Unknown initializer {name_or_fn!r}; known: "
            f"{sorted(_REGISTRY)}") from None


__all__ = [
    "get", "glorot_normal", "glorot_uniform", "he_normal", "he_uniform",
    "lecun_normal", "normal", "ones", "variance_scaling", "zeros",
]
