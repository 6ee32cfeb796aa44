"""Int8 weight-only quantization, as the JAX package's ``quant.py``.

A quantized weight ``w`` of shape (..., C) is the pair::

    {"q": int8 (..., C), "scale": float32 (C,)}   # w ~= q * scale

with ``scale = amax(|w|, all axes but -1) / 127`` (1 for an all-zero
channel) and ``q = clip(round(w / scale), -127, 127)``, rounded half to
even. The channel axis is the last: Dense ``(din, units)``, attention
``(d, inner)``, Embedding ``(vocab, d)``, Conv2D HWIO. Only leaves with
``ndim >= min_ndim`` (2) quantize; biases and norm scales stay f32.

In a built module a quantized leaf is a :class:`QuantizedWeight`: a
submodule holding the two as buffers, registered under the parameter's
name, so its state paths are the JAX tree's ``.../kernel/q`` and
``.../kernel/scale`` (``Model.params`` lists them; ``interop`` and the
checkpoints carry them). Layers dequantize where they read the weight
(``nn.Layer._weight``): the multiply in f32, then one cast to the compute
dtype; Embedding gathers the int8 rows first and dequantizes only those.

``quantize_model`` quantizes a built model in place for serving
(``generate``, ``predict``, ``evaluate``, ``serving.Engine``); ``fit``
raises, since int8 weights carry no gradients. The int8 KV pools of the
Engine use the same ``{"q", "scale"}`` idiom (``nn/attention.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

QKEY = "q"
SKEY = "scale"
_QMAX = 127.0
_SEP = "/"


class QuantizedWeight(torch.nn.Module):
    """One int8 weight in a module: buffers ``q`` (int8) and ``scale`` (f32,
    one per output channel). ``shape`` is the weight's logical shape."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer(QKEY, q)
        self.register_buffer(SKEY, scale)

    @property
    def shape(self):
        return self.q.shape


def is_quantized_leaf(x) -> bool:
    """True for a ``{"q": int8, "scale": f32}`` dict or a QuantizedWeight."""
    if isinstance(x, QuantizedWeight):
        return True
    return (isinstance(x, dict) and set(x) == {QKEY, SKEY}
            and getattr(x[QKEY], "dtype", None) in (torch.int8, np.int8))


def is_quantized(tree) -> bool:
    """True when any quantized weight appears in ``tree``: a nested tree, a
    flat ``{path: leaf}`` tree (a ``.../q`` int8 leaf), or a module."""
    if isinstance(tree, torch.nn.Module):
        return any(isinstance(m, QuantizedWeight) for m in tree.modules())
    if is_quantized_leaf(tree):
        return True
    if isinstance(tree, dict):
        return any(
            (str(k).endswith(_SEP + QKEY) and getattr(v, "dtype", None)
             in (torch.int8, np.int8)) or is_quantized(v)
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return any(is_quantized(v) for v in tree)
    return False


def shape_of(w):
    """A weight's logical shape, plain or quantized."""
    return w[QKEY].shape if isinstance(w, dict) and is_quantized_leaf(w) \
        else w.shape


def _as_tensor(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(w))


def quantize_leaf(w) -> Dict[str, Any]:
    """Per-channel symmetric int8 quantization of one weight (channels on
    the last axis), in the JAX package's order: f32 amax, ``amax / 127``,
    ``round(w / scale)``, clip. The divisions are by tensors of the same
    device (a Python divisor is a product by its reciprocal on CUDA), so
    ``q`` and ``scale`` are JAX's bit for bit."""
    w = _as_tensor(w).detach().to(torch.float32)
    lead = tuple(range(w.dim() - 1))
    # torch.amax over no dims reduces over all: a 1-D leaf's channels are
    # its entries (JAX's max over an empty axis tuple).
    amax = torch.amax(w.abs(), dim=lead) if lead else w.abs()
    scale = torch.where(amax > 0, amax / torch.full_like(amax, _QMAX),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX)
    return {QKEY: q.to(torch.int8), SKEY: scale}


def dequantize(w, dtype=None):
    """``q * scale`` in f32, cast to ``dtype`` when given. The multiply
    runs in f32 so a bf16 target rounds once, not twice."""
    out = w[QKEY].to(torch.float32) * w[SKEY].to(torch.float32)
    return out if dtype is None else out.to(dtype)


def maybe_dequantize(w, dtype=None):
    """Quantized weights dequantize; plain tensors pass through untouched."""
    if isinstance(w, QuantizedWeight):
        w = {QKEY: w.q, SKEY: w.scale}
    return dequantize(w, dtype) if is_quantized_leaf(w) else w


def _quantizable(t, min_ndim: int) -> bool:
    return (getattr(t, "ndim", 0) >= min_ndim
            and _as_tensor(t).is_floating_point())


def quantize_tree(tree, *, min_ndim: int = 2):
    """Quantize every floating leaf with ``ndim >= min_ndim`` of a tree
    (dicts, lists, tuples; tensor or numpy leaves); other leaves stay as
    they are. An already quantized tree raises: quantizing twice would
    re-round the rounded values."""

    def walk(t):
        if is_quantized_leaf(t):
            raise ValueError(
                "tree is already int8-quantized; quantize_tree must run on "
                "full-precision weights (restore the f32 checkpoint first)")
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, (torch.Tensor, np.ndarray)) and _quantizable(
                t, min_ndim):
            return quantize_leaf(t)
        return t

    return walk(tree)


def leaf_role(leaf: str, role):
    """The tensor-parallel role of a quantized weight's ``q`` or
    ``scale`` whose weight has ``role``: ``q`` takes the weight's
    Megatron split ("col", "row", "row1"); the per-output-channel
    ``scale`` is split with the output columns ("col") and is whole
    under a row split, where it factors out of the row sum. Any other
    role (an expert or a pipeline stage) leaves both whole."""
    if role not in ("col", "row", "row1"):
        return None
    return role if leaf == QKEY or role == "col" else None


def quantize_model(model, *, min_ndim: int = 2):
    """Quantize a built model's parameters in place (weight-only int8):
    each floating parameter with ``ndim >= min_ndim`` becomes a
    :class:`QuantizedWeight` on its device. The captured step graphs and
    the memoized decode dtype are dropped, and so is the optimizer state
    (int8 weights train nothing; ``fit`` raises). Under a sharding
    strategy each weight is gathered whole first (its per-channel scales
    span every row, so the bits equal JAX's), and ``q`` and ``scale`` are
    then stored as this rank's blocks (every rank calls it): by the
    placement rule on their own shapes under FSDP, by the weight's
    Megatron role under tensor parallelism (:func:`leaf_role`), so a
    layer dequantizes and computes with its block. Returns the model."""
    if not model.built:
        raise RuntimeError("Build the model (or restore a checkpoint) "
                           "before quantizing")
    if is_quantized(model.module):
        raise ValueError("model is already int8-quantized")
    model._unlayout_params()
    with torch.no_grad():
        for layer in list(model.module.modules()):
            for name, p in list(layer.named_parameters(recurse=False)):
                if not _quantizable(p, min_ndim):
                    continue
                qd = quantize_leaf(p)
                delattr(layer, name)
                setattr(layer, name, QuantizedWeight(qd[QKEY], qd[SKEY]))
    model._layout_params()
    model._graphs = {}
    model._decode_dtype = None
    model.opt_state = None
    return model


def abstract_quantize_tree(tree, *, min_ndim: int = 2):
    """The shapes of the tree :func:`quantize_tree` would make, with no
    weights: each quantizable leaf becomes ``{"q": int8, "scale": f32}``
    tensors on the ``meta`` device (shape and dtype only), which
    :func:`tree_param_bytes` prices. Leaves may be tensors (meta too) or
    numpy arrays."""

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        shape = tuple(getattr(t, "shape", ()))
        if len(shape) >= min_ndim and _floating(t):
            return {QKEY: torch.empty(shape, dtype=torch.int8, device="meta"),
                    SKEY: torch.empty(shape[-1:], dtype=torch.float32,
                                      device="meta")}
        return t

    return walk(tree)


def _floating(t) -> bool:
    if isinstance(t, torch.Tensor):
        return t.is_floating_point()
    return np.issubdtype(np.asarray(t).dtype, np.floating)


def _leaves(tree):
    if isinstance(tree, QuantizedWeight):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_param_bytes(tree) -> int:
    """Logical bytes of a parameter tree, plain or quantized (tensor,
    ``meta`` tensor or numpy leaves; int8 leaves at one byte each)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            a = np.asarray(leaf)
            total += a.size * a.dtype.itemsize
    return total


__all__ = [
    "QKEY", "QuantizedWeight", "SKEY", "abstract_quantize_tree",
    "dequantize", "is_quantized", "is_quantized_leaf", "maybe_dequantize",
    "quantize_leaf", "quantize_model", "quantize_tree", "shape_of",
    "tree_param_bytes",
]
