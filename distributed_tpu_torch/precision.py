"""Mixed-precision dtype policies: f32 masters, a lower compute dtype.

The JAX package's ``precision.py``: a :class:`Policy` is three dtypes —
``param_dtype`` (storage of the parameters and the optimizer state, f32
masters), ``compute_dtype`` (the forward and backward math) and
``output_dtype`` (the logits handed to the loss and to ``predict``) — and
``mixed_float16`` adds dynamic loss scaling (``optim.dynamic_loss_scaling``).
``Model.compile(precision=...)`` selects one by preset name or instance.

The ambient policy is a thread-local, as there: ``Policy.scope()`` sets it,
``current_policy()`` reads it, and a layer's compute dtype is
``resolve_dtype(self.dtype)`` — an explicit per-layer ``dtype=`` wins, else
the policy's compute dtype. The JAX step casts the whole parameter tree to
the compute dtype once (``Policy.cast_to_compute``, skipping the subtrees of
layers with an explicit ``dtype=``). The port's layers own their parameters,
so the same cast is made where a layer reads a leaf
(``nn.Layer._weight``): inside the step, from the f32 master, so the
gradients come back f32 through the cast. ``cast_to_compute`` itself walks
a ``{name: leaf}`` tree with the JAX rules, for callers that hold one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

_local = threading.local()


def _as_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def current_policy() -> Optional["Policy"]:
    """The ambient Policy set by ``Policy.scope()`` (None outside one)."""
    return getattr(_local, "policy", None)


def resolve_dtype(explicit=None):
    """A layer's compute dtype: an explicit per-layer ``dtype=`` (a dtype or
    its name) always wins; otherwise the ambient policy's compute dtype;
    None when neither is set (the layer computes in its input's dtype)."""
    if explicit is not None:
        return _as_dtype(explicit)
    pol = current_policy()
    return None if pol is None else pol.compute_dtype


class Policy:
    """A mixed-precision dtype policy.

    ``Policy("mixed_bfloat16")`` / ``Policy("float32")`` /
    ``Policy("mixed_float16")`` build the named presets; ``Policy(
    param_dtype=..., compute_dtype=..., output_dtype=...)`` a custom one.
    ``loss_scaling`` defaults to True only for float16 compute; the
    ``initial_loss_scale`` / ``loss_scale_growth_interval`` /
    ``loss_scale_factor`` knobs configure ``optim.dynamic_loss_scaling``."""

    def __init__(
        self,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        output_dtype=torch.float32,
        *,
        name: Optional[str] = None,
        loss_scaling: Optional[bool] = None,
        initial_loss_scale: float = 2.0 ** 15,
        loss_scale_growth_interval: int = 2000,
        loss_scale_factor: float = 2.0,
    ):
        if isinstance(param_dtype, str) and param_dtype in _PRESETS:
            preset = _PRESETS[param_dtype]
            param_dtype = preset["param"]
            compute_dtype = preset["compute"]
            output_dtype = preset["output"]
            name = name or preset["name"]
        self.param_dtype = _as_dtype(param_dtype)
        self.compute_dtype = _as_dtype(compute_dtype)
        self.output_dtype = _as_dtype(output_dtype)
        self.name = name or (
            f"policy({_name(self.param_dtype)}/{_name(self.compute_dtype)}"
            f"/{_name(self.output_dtype)})")
        if loss_scaling is None:
            loss_scaling = self.compute_dtype == torch.float16
        self.loss_scaling = bool(loss_scaling)
        self.initial_loss_scale = float(initial_loss_scale)
        self.loss_scale_growth_interval = int(loss_scale_growth_interval)
        self.loss_scale_factor = float(loss_scale_factor)

    @contextlib.contextmanager
    def scope(self):
        prev = current_policy()
        _local.policy = self
        try:
            yield self
        finally:
            _local.policy = prev

    @property
    def needs_compute_cast(self) -> bool:
        return self.compute_dtype != self.param_dtype

    @property
    def compute_itemsize(self) -> int:
        """Bytes per element at the compute dtype."""
        return torch.empty((), dtype=self.compute_dtype).element_size()

    def cast_to_compute(self, tree, dtype_hints: Optional[Dict] = None):
        """The master->compute cast of a nested ``{name: leaf}`` tree:
        floating leaves to ``compute_dtype``, everything else (int8
        payloads, ints) untouched. ``dtype_hints`` (``Layer.dtype_hints()``,
        nested as the tree) marks the subtrees of layers with an explicit
        ``dtype=``: those stay at master precision."""
        cd = self.compute_dtype

        def walk(t, h):
            if h is not None and not isinstance(h, dict):
                return t  # an explicitly dtyped layer casts its own leaves
            if isinstance(t, dict):
                hh = h or {}
                return {k: walk(v, hh.get(k)) for k, v in t.items()}
            return cast_floating(t, cd)

        return walk(tree, dtype_hints)

    def cast_output(self, x):
        """Model-boundary cast of logits to ``output_dtype`` (floating
        outputs only)."""
        return cast_floating(x, self.output_dtype)

    def cast_params_to_storage(self, tree):
        """Floating leaves to ``param_dtype`` (a no-op for the f32-master
        presets)."""
        if self.param_dtype == torch.float32:
            return tree
        return _map(lambda a: cast_floating(a, self.param_dtype), tree)

    def __repr__(self):
        return (f"Policy(name={self.name!r}, param={_name(self.param_dtype)}, "
                f"compute={_name(self.compute_dtype)}, "
                f"output={_name(self.output_dtype)}, "
                f"loss_scaling={self.loss_scaling})")


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def cast_floating(a, dtype):
    """``a`` in ``dtype`` when it is a floating tensor, else as it is."""
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.to(dtype)
    return a


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


_PRESETS = {
    "float32": {"name": "float32", "param": torch.float32,
                "compute": torch.float32, "output": torch.float32},
    "mixed_bfloat16": {"name": "mixed_bfloat16", "param": torch.float32,
                       "compute": torch.bfloat16, "output": torch.float32},
    "mixed_float16": {"name": "mixed_float16", "param": torch.float32,
                      "compute": torch.float16, "output": torch.float32},
}


def get(policy) -> Optional[Policy]:
    """Resolve ``compile(precision=...)``: None passes through (no policy),
    a Policy passes through, a preset name builds one."""
    if policy is None or isinstance(policy, Policy):
        return policy
    if isinstance(policy, str):
        if policy in _PRESETS:
            return Policy(policy)
        raise ValueError(
            f"Unknown precision policy {policy!r}; choose from "
            f"{sorted(_PRESETS)} or pass a precision.Policy")
    raise TypeError(
        "precision must be None, a preset name, or a Policy; got "
        f"{type(policy).__name__}")


def grad_accum_init(params):
    """Zero accumulators for gradient accumulation: f32 for every floating
    leaf whatever its dtype (bf16 partial sums would lose the low bits the
    whole batch keeps), ``zeros_like`` for the rest. ``params`` is a list
    of tensors or a tree of them."""
    def zeros(p):
        if p.is_floating_point():
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return torch.zeros_like(p)

    return _map(zeros, params)


def assert_f32_accumulator(acc) -> None:
    """Every floating leaf of a gradient accumulator must be f32 (see
    :func:`grad_accum_init`)."""
    for leaf in _leaves(acc):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.dtype != torch.float32):
            raise AssertionError(
                f"gradient accumulator leaf has dtype {leaf.dtype}, expected "
                "float32 — accumulation must stay at master precision even "
                "when grads arrive in a reduced compute dtype")


def cast_like(tree, ref):
    """Each leaf of ``tree`` in the dtype of the matching leaf of ``ref``
    (lists, tuples and dicts of tensors, nested alike)."""
    if isinstance(tree, dict):
        return {k: cast_like(v, ref[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_like(a, r) for a, r in zip(tree, ref))
    return tree.to(ref.dtype)


__all__ = [
    "Policy", "assert_f32_accumulator", "cast_floating", "cast_like",
    "current_policy", "get", "grad_accum_init", "resolve_dtype",
]
