"""Activation registry (Keras-style names -> torch functions).

``"gelu"`` is the tanh approximation: ``jax.nn.gelu`` defaults to
``approximate=True``, and the exact erf form would be a silent mismatch.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_REGISTRY = {
    "relu": F.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": functools.partial(F.softmax, dim=-1),
    "linear": lambda x: x,
    None: lambda x: x,
}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name_or_fn!r}; known: "
            f"{sorted(k for k in _REGISTRY if k)}"
        ) from None


__all__ = ["get"]
