"""Fused Adam/AdamW update: one CUDA kernel pass over the parameter tree.

The JAX package's ``ops/fused_update.py`` concatenates the master tree's
leaves into flat same-dtype segments, pads them to the TPU's 128-lane
rows and runs the whole Adam recurrence (both moments, bias correction,
the step and AdamW's decay term) as one Pallas kernel, ``_adam_kernel``,
per segment. The port's kernel (``csrc/fused_adam.cu``) replaces it: one
launch takes a table of up to ``MAX_LEAVES`` leaves and updates their
parameters and moments IN PLACE, as the port's optimizers do, so nothing
is concatenated, padded or sliced back. An update takes one launch per
table-full of leaves.

Dispatch is by the device of the parameters, with no fallback: CUDA
tensors launch the kernel (a failed build or launch raises), CPU tensors
run :func:`adam_update_ref`, the plain version: the ``torch._foreach_*``
walk of ``optim.Adam``, with the ``+ wd * p`` term before the ``-lr``
scale, in the order of the JAX kernel. Both sides round every operation
once, in the same order (the kernel forbids fused multiply-adds), so on
the card they agree bit for bit. ``launches`` counts the kernel's
launches.

The kernel takes f32 leaves, which the port's master parameters always
are; the plain version computes in f32 as well.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from . import _build
from ._build import _I, _P

#: Launches of the CUDA kernel; incremented only where it is launched.
launches = {"fused_adam": 0}

#: Leaves per launch (``kMaxLeaves`` in ``csrc/fused_adam.cu``).
MAX_LEAVES = 64


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


class AdamScalars(NamedTuple):
    """The update's f32 scalars, as Python floats holding f32 values:
    ``neg_lr = -lr``, ``c1 = 1 - b1``, ``c2 = 1 - b2``, ``bc1 = 1 -
    b1**count``, ``bc2 = 1 - b2**count``; ``wd`` 0 is Adam, above 0
    AdamW. The order is the kernel's argument order."""

    neg_lr: float
    b1: float
    b2: float
    c1: float
    c2: float
    eps: float
    wd: float
    bc1: float
    bc2: float


# ------------------------------------------------------------ plain version
@torch.no_grad()
def adam_update_ref(params: List[torch.Tensor], grads, mus, nus,
                    s: AdamScalars) -> None:
    """One Adam/AdamW step in place on ``params``, ``mus`` and ``nus``:
    ``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``, ``u = (m/bc1) /
    (sqrt(v/bc2) + eps)``, ``u += wd*p`` when ``wd`` is not 0,
    ``p += u*(-lr)``; every operation rounded to f32 in that order."""
    g = [x.to(torch.float32) for x in grads]
    torch._foreach_mul_(mus, s.b1)
    torch._foreach_add_(mus, torch._foreach_mul(g, s.c1))
    torch._foreach_mul_(nus, s.b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(g, g), s.c2))
    # Scalar lists, not scalars: on CUDA ``_foreach_div`` by one scalar
    # multiplies by its reciprocal, which rounds differently from the
    # division that optax, the CPU and the kernel do.
    mu_hat = torch._foreach_div(mus, [s.bc1] * len(mus))
    den = torch._foreach_div(nus, [s.bc2] * len(nus))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, s.eps)
    upd = torch._foreach_div(mu_hat, den)
    if s.wd != 0.0:
        torch._foreach_add_(upd, torch._foreach_mul(params, s.wd))
    torch._foreach_mul_(upd, s.neg_lr)
    torch._foreach_add_(params, upd)


# ------------------------------------------------------------- CUDA kernel
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_LIB = _build.Library("fused_adam", {
    "dtt_fused_adam": [_I] + [_PTRS] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    + [ctypes.c_float] * 9 + [_P],
})


@torch.no_grad()
def _adam_update_cuda(params, grads, mus, nus, s: AdamScalars) -> None:
    lib = _LIB.get()
    dev = params[0].device
    leaves = []
    for p, g, m, v in zip(params, grads, mus, nus, strict=True):
        for name, t in (("param", p), ("mu", m), ("nu", v)):
            _build.require(t, name, dev, torch.float32)
        g = g.to(torch.float32).contiguous()
        _build.require(g, "grad", dev, torch.float32)
        if not p.numel() == g.numel() == m.numel() == v.numel():
            raise ValueError(
                f"fused_adam: leaf sizes differ: param {p.numel()}, grad "
                f"{g.numel()}, mu {m.numel()}, nu {v.numel()}")
        if p.numel():
            leaves.append((p, g, m, v))
    stream = _build.stream(dev)
    for start in range(0, len(leaves), MAX_LEAVES):
        table = leaves[start:start + MAX_LEAVES]
        k = len(table)
        ptrs = [(ctypes.c_void_p * k)(*[leaf[j].data_ptr() for leaf in table])
                for j in range(4)]
        sizes = (ctypes.c_longlong * k)(*[leaf[0].numel() for leaf in table])
        rc = lib.dtt_fused_adam(k, *ptrs, sizes, *s, stream)
        _build.check_launch(rc, "fused_adam")
        launches["fused_adam"] += 1


def adam_update(params: List[torch.Tensor], grads, mus, nus,
                s: AdamScalars) -> None:
    """:func:`adam_update_ref`'s step: the kernel for CUDA tensors (one
    launch per ``MAX_LEAVES`` leaves), the plain version for CPU tensors."""
    if params:
        _build.dispatch(params[0], _adam_update_cuda, adam_update_ref,
                        "fused_adam")(params, grads, mus, nus, s)


__all__ = [
    "AdamScalars", "MAX_LEAVES", "adam_update", "adam_update_ref",
    "launches", "reset_launch_counts",
]
