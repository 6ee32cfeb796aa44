"""BatchNorm's per-channel reductions (kernels K13 and K14).

The JAX package's ``examples/bn_pallas.py`` wrote the two reductions of
``nn.BatchNorm`` as Pallas kernels: ``_stats_kernel`` (K13), the forward's
shifted moments ``(sum(x - shift), sum((x - shift)^2))``, and
``_bwd_kernel`` (K14), the backward's ``(sum(dy), sum(dy * xhat))`` with
``xhat = (x - mean) * inv``. The JAX package never wired them into its
layer; the port's ``nn.BatchNorm`` runs them in every training step, and
``csrc/bn_reduce.cu`` replaces them. Each takes an (M, C) activation in
bf16 or f32 and returns the two sums as one (2, C) f32 tensor.

The kernel adds its partial sums in a fixed order with no atomics, so a
call gives the same bits on every run. A call is ``LAUNCHES_PER_CALL``
launches (the partial sums, then their total); ``launches`` counts them.

Dispatch is by the device of the tensors, with no fallback: CUDA tensors
launch the kernels (a failed build or launch raises), CPU tensors run the
plain versions :func:`bn_stats_ref` and :func:`bn_bwd_reduce_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import _I, _P

#: Launches of each CUDA kernel family; incremented only where launched.
launches = {"bn_stats": 0, "bn_bwd_reduce": 0}

#: Kernel launches per call: the partial sums, then their total.
LAUNCHES_PER_CALL = 2


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------- plain versions
def bn_stats_ref(x2d, shift):
    """(2, C) f32: ``sum(x - shift)`` and ``sum((x - shift)^2)`` over the
    rows of ``x2d``, with ``x`` converted to f32 first."""
    xc = x2d.float() - shift
    return torch.stack([xc.sum(0), xc.square().sum(0)])


def bn_bwd_reduce_ref(dy2d, x2d, mean, inv):
    """(2, C) f32: ``sum(dy)`` and ``sum(dy * ((x - mean) * inv))`` over the
    rows, with ``dy`` and ``x`` converted to f32 first."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * inv
    return torch.stack([dyf.sum(0), (dyf * xhat).sum(0)])


# ------------------------------------------------------------ CUDA kernels
_LL = ctypes.c_longlong
_LIB = _build.Library("bn_reduce", {
    "dtt_bn_stats": [_I, _P, _P, _P, _P, _LL, _I, _I, _P],
    "dtt_bn_bwd_reduce": [_I, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "dtt_bn_scratch_floats": [_I, _LL, _I, _I],
})


def _prepare(name, acts, vectors):
    """Checks shared by both kernels: ``acts`` (M, C) contiguous, one
    dtype, one device; each of ``vectors`` (C,) f32 on that device, made
    contiguous. Returns (lib, vectors, m, c, vec flag, scratch, out)."""
    x = acts[0]
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         "(float32, bfloat16)")
    for i, t in enumerate(acts):
        _build.require(t, f"{name} input {i}", x.device, x.dtype, 2)
        if t.shape != x.shape:
            raise ValueError(f"{name}: inputs {tuple(t.shape)} and "
                             f"{tuple(x.shape)} differ")
    m, c = x.shape
    vs = []
    for t in vectors:
        t = t.to(torch.float32).contiguous()
        _build.require(t, f"{name} channel vector", x.device, torch.float32, 1)
        if t.shape[0] != c:
            raise ValueError(f"{name}: channel vector of {t.shape[0]} for "
                             f"{c} channels")
        vs.append(t)
    lib = _LIB.get()
    per_vec = 16 // x.element_size()
    vec = int(c % per_vec == 0 and all(t.data_ptr() % 16 == 0 for t in acts))
    code = _build.DTYPE_CODES[x.dtype]
    floats = lib.dtt_bn_scratch_floats(code, m, c, vec)
    if floats < 0:
        raise ValueError(f"{name}: ({m}, {c}) is not a shape the kernel takes")
    scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    return lib, vs, m, c, vec, scratch, out


def _bn_stats_cuda(x2d, shift):
    lib, (shift,), m, c, vec, scratch, out = _prepare("bn_stats", [x2d],
                                                      [shift])
    rc = lib.dtt_bn_stats(_build.DTYPE_CODES[x2d.dtype], x2d.data_ptr(),
                          shift.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                          m, c, vec, _build.stream(x2d.device))
    _build.check_launch(rc, "bn_stats")
    launches["bn_stats"] += LAUNCHES_PER_CALL
    return out


def _bn_bwd_reduce_cuda(dy2d, x2d, mean, inv):
    lib, (mean, inv), m, c, vec, scratch, out = _prepare(
        "bn_bwd_reduce", [dy2d, x2d], [mean, inv])
    rc = lib.dtt_bn_bwd_reduce(
        _build.DTYPE_CODES[x2d.dtype], dy2d.data_ptr(), x2d.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        m, c, vec, _build.stream(x2d.device))
    _build.check_launch(rc, "bn_bwd_reduce")
    launches["bn_bwd_reduce"] += LAUNCHES_PER_CALL
    return out


def bn_stats(x2d, shift):
    """:func:`bn_stats_ref`'s sums: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _build.dispatch(x2d, _bn_stats_cuda, bn_stats_ref,
                           "bn_stats")(x2d, shift)


def bn_bwd_reduce(dy2d, x2d, mean, inv):
    """:func:`bn_bwd_reduce_ref`'s sums: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _build.dispatch(x2d, _bn_bwd_reduce_cuda, bn_bwd_reduce_ref,
                           "bn_bwd_reduce")(dy2d, x2d, mean, inv)


__all__ = [
    "LAUNCHES_PER_CALL", "bn_bwd_reduce", "bn_bwd_reduce_ref", "bn_stats",
    "bn_stats_ref", "launches", "reset_launch_counts",
]
