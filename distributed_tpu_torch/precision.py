"""Compute-dtype resolution for the layers.

Only the per-layer ``dtype=`` override is ported: there is no ambient
``Policy`` and no loss scaling yet, so a layer without an explicit dtype
computes in its input's dtype, as the JAX layers do outside a policy.
"""

from __future__ import annotations

import torch


def resolve_dtype(explicit=None):
    """The layer's compute dtype: ``explicit`` as a ``torch.dtype`` (a
    dtype or its name, e.g. ``"bfloat16"``), or None when not set."""
    if explicit is None or isinstance(explicit, torch.dtype):
        return explicit
    dt = getattr(torch, str(explicit), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {explicit!r}")
    return dt


__all__ = ["resolve_dtype"]
