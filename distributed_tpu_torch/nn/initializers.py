"""Weight initializers, each drawn from an explicit ``torch.Generator``.

Same distributions as the JAX package's (``jax.nn.initializers``), not the
same numbers: the two generators differ, so parity tests carry weights
across (``interop.params_from_jax``) instead of matching seeds.
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def glorot_uniform():
    """Uniform on ``[-limit, limit]``, ``limit = sqrt(6 / (fan_in + fan_out))``."""

    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return (2.0 * u - 1.0) * limit

    return init


def normal(stddev=0.01):
    """Gaussian with mean 0 and standard deviation ``stddev``."""

    def init(generator, shape, dtype=torch.float32):
        return torch.randn(shape, generator=generator, dtype=dtype) * stddev

    return init


_REGISTRY = {"glorot_uniform": glorot_uniform}


def get(name_or_fn):
    """An initializer by the JAX package's name, or a callable
    ``init(generator, shape)`` as it is. The JAX names the port lacks
    (``glorot_normal``, ``he_uniform``, ``he_normal``, ``lecun_normal``,
    ``zeros``, ``ones``) raise ``NotImplementedError`` naming ROADMAP 1.4;
    other names raise ``ValueError``, as in JAX."""
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn in _UNPORTED:
        raise NotImplementedError(
            f"initializer {name_or_fn!r}: not yet ported (ROADMAP 1.4)")
    try:
        return _REGISTRY[name_or_fn]()
    except KeyError:
        raise ValueError(
            f"Unknown initializer {name_or_fn!r}; known: "
            f"{sorted(set(_REGISTRY) | set(_UNPORTED))}") from None


_UNPORTED = ("glorot_normal", "he_uniform", "he_normal", "lecun_normal",
             "zeros", "ones")

__all__ = ["get", "glorot_uniform", "normal"]
