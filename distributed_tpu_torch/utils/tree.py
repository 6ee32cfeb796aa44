"""Small helpers over the port's trees, as the JAX package's
``utils/tree.py`` over pytrees: nested dicts, lists and tuples whose
leaves are tensors, numpy arrays or numbers, in the order of
``interop.iter_leaf_paths``."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..interop import iter_leaf_paths


def _leaves(tree) -> List:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order,
    which ``interop.iter_leaf_paths`` owns."""
    return [leaf for _, leaf in iter_leaf_paths(tree)]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def tree_size(tree) -> int:
    """Total number of scalar elements in a tree of arrays."""
    return sum(_tensor(x).numel() for x in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of arrays."""
    return sum(_tensor(x).numel() * _tensor(x).element_size()
               for x in _leaves(tree))


def tree_count(tree) -> int:
    """Number of array leaves in a tree."""
    return len(_leaves(tree))


def _promoted(x, y):
    """``x`` and ``y`` as tensors of their common dtype on ``x``'s
    device (``jnp.allclose`` and ``==`` promote the same way)."""
    x, y = _tensor(x), _tensor(y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(device=x.device, dtype=dt)


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    return all(torch.allclose(*_promoted(x, y), rtol=rtol, atol=atol)
               for x, y in zip(la, lb))


def tree_equal(a, b) -> bool:
    """Bit-exact equality of two trees (the replica-sync invariant)."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        u, v = _promoted(x, y)
        if not bool((u == v).all()):
            return False
    return True


__all__ = ["tree_allclose", "tree_bytes", "tree_count", "tree_equal",
           "tree_size"]
