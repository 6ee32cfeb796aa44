"""Parameter trees carried between the JAX package and the port.

The port's modules register their parameters under the JAX package's tree
paths (``residual_1/main/dense_1/kernel``), with the same layouts (Dense
kernels ``(din, units)``, attention projections ``(d, heads*head_dim)``),
so a JAX parameter tree loads with no transposes, and trained parameters
come back as numpy under the same paths (``params_to_numpy``); the state
(BatchNorm's running statistics) travels the same way (``state_from_jax``,
``state_to_numpy``). The path rules are those
of the JAX package's ``checkpoint/core.py``: sorted dict keys, ``#i`` for
tuple and list entries, joined by ``/``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SEP = "/"


def iter_leaf_paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaf_paths(tree[k], f"{prefix}{k}{SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaf_paths(v, f"{prefix}#{i}{SEP}")
    elif tree is None:
        return
    else:
        yield prefix.rstrip(SEP), tree


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    """``{path: numpy array}`` for every leaf of ``tree``."""
    return {p: np.asarray(v) for p, v in iter_leaf_paths(tree, prefix)}


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Model.params`` tree (leaves as numpy arrays,
    e.g. after ``jax.device_get``) as the port's flat ``{path: tensor}``
    parameters, in f32 on the CPU. Load them with ``Model.load_params``."""
    return {
        path: torch.from_numpy(np.array(leaf, dtype=np.float32))
        for path, leaf in flatten_tree(tree).items()
    }


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The port's ``{path: tensor}`` parameters (``Model.params``) as
    ``{path: f32 numpy array}`` on the host, under the same tree paths as
    ``flatten_tree`` gives a JAX parameter tree, so the two compare leaf
    by leaf."""
    return {path: t.detach().to("cpu", torch.float32).numpy()
            for path, t in params.items()}


def state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Model.state`` tree (BatchNorm's running ``mean``
    and ``var``; leaves as numpy arrays) as the port's flat ``{path:
    tensor}`` state, in f32 on the CPU. Load it with ``Model.load_state``."""
    return params_from_jax(tree)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The port's ``{path: buffer}`` state (``Model.state``) as ``{path:
    f32 numpy array}``, under the paths ``flatten_tree`` gives a JAX state
    tree."""
    return params_to_numpy(state)


__all__ = [
    "SEP", "flatten_tree", "iter_leaf_paths", "params_from_jax",
    "params_to_numpy", "state_from_jax", "state_to_numpy",
]
