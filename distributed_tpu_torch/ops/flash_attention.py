"""Attention over (B, T, H, D): the dense path and flash attention.

``dense_attention`` is plain tensor code, the short-sequence path of
``MultiHeadAttention`` (and its ``flash=False`` choice).

``flash_attention`` never forms the (T, T) scores on the card. It is a
``torch.autograd.Function`` over three hand-written CUDA kernels in
``csrc/flash_attention.cu``: the forward (online softmax over kv tiles,
emitting O and the per-row max ``m`` and sum ``l``), dQ, and dK/dV (both
recomputing the probabilities from ``m`` and ``l``). They replace the JAX
package's Pallas kernels in ``distributed_tpu/ops/flash_attention.py``:
the folded ``_fwd_kernel``/``_dq_kernel``/``_dkv_kernel`` and the
lane-packed ``_fwd_kernel_packed``/``_dq_kernel_packed``/
``_dkv_kernel_packed``. On the card one kernel family covers both
layouts: it reads the heads out of (B, T, H, D) by strides, so neither a
fold to (B*H, T, D) nor a lane packing is needed.

Each kernel takes one of two routes by dtype (:func:`flash_route`): bf16
and f16 go to the Hopper kernels (``wgmma`` products with the sums in
registers, ``cp.async`` tile copies), whose tiles are 64, 128 or 256
columns wide (narrower heads are zero-padded in shared memory); float32
goes to the CUDA-core kernels, in full f32. Every head width from 1 to
``MAX_D`` runs the kernels: a head whose rows are not whole 16-byte chunks
(D not a multiple of 8, or of 4 in f32) is zero-padded to the next one in
a copy here, with the scale of the real D, and the padded columns of the
outputs are sliced away. That is exact: zero columns of Q and K add 0 to
every score, zero columns of V give zero output columns.

Dispatch is by the device of the tensors, with no fallback: CUDA tensors
launch the kernels (a failed build or launch raises), CPU tensors run
:func:`flash_fwd_ref` / :func:`flash_bwd_ref`, the plain versions of the
same arithmetic, dense over the full (T, T) scores. ``launches`` counts
each kernel's launches, ``route_launches`` the same per route and
``dtype_launches`` per input dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

import torch.nn.functional as F

from . import _build
from ._build import _I, _P
from ._common import NEG, round_up

#: Launches of each CUDA kernel; incremented only where it is launched.
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
#: The same launches by route (see :func:`flash_route`).
route_launches = {f"{k}/{r}": 0 for k in launches
                  for r in ("wgmma", "cuda_core")}
#: The same launches by input dtype (``"flash_fwd/float16"``): a precision
#: policy's compute dtype reaches the kernels.
dtype_launches = {f"{k}/{t}": 0 for k in launches
                  for t in ("float32", "bfloat16", "float16")}
#: The widest head the kernels take (the widest wgmma tile).
MAX_D = 256


def reset_launch_counts() -> None:
    for counts in (launches, route_launches, dtype_launches):
        for name in counts:
            counts[name] = 0


def flash_route(dtype, d: int):
    """``(route, width)`` of the kernels for heads of ``dtype`` and width
    ``d``: ``("wgmma", 64, 128 or 256)`` for bf16 and f16, the Hopper
    kernels with their tiles padded to that width; ``("cuda_core", d
    rounded up to a multiple of 4)`` for float32, the width the CUDA-core
    kernels see. Raises ``ValueError`` unless ``1 <= d <= MAX_D`` and the
    dtype is one of those three (float64 too: the JAX package, without
    x64, has no float64 arrays to take)."""
    if dtype not in _build.FLOAT_CODES:
        raise ValueError(f"flash_attention: dtype {dtype} not supported "
                         "(float32, bfloat16, float16)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"flash_attention: head_dim {d} must be in "
                         f"[1, {MAX_D}]")
    if dtype == torch.float32:
        return "cuda_core", round_up(d, 4)
    return "wgmma", 64 if d <= 64 else 128 if d <= 128 else 256


def _kernel_d(dtype, d: int) -> int:
    """The head width the kernels are given: ``d`` rounded up to whole
    16-byte chunks of a row (a multiple of 4 in f32, of 8 in 16 bits)."""
    return round_up(d, 4 if dtype == torch.float32 else 8)


def dense_attention(q, k, v, causal: bool):
    """Attention over (B, T, H, D) tensors: scores in f32 divided by
    ``sqrt(D)``, masked with ``NEG``, softmax in f32, probabilities cast to
    ``q.dtype`` before the product with ``v``."""
    hd = q.shape[-1]
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


# ----------------------------------------------------------- plain versions
def _scale(d: int) -> float:
    """1/sqrt(D), which the kernels take rounded to f32; scores are
    multiplied by it, as the TPU kernels do (not divided by sqrt(D))."""
    return 1.0 / math.sqrt(d)


def _scores(q, k, causal, scale=None):
    """(B, H, T, T) f32 scores ``(q . k) * scale`` and the valid mask;
    ``scale`` defaults to ``_scale(D)``."""
    t = q.shape[1]
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * (_scale(q.shape[-1]) if scale is None else scale)
    valid = torch.ones((t, t), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril()
    return s, valid


def flash_fwd_ref(q, k, v, causal: bool = False, scale=None):
    """Plain flash forward over (B, T, H, D): returns ``(o, m, l)``, ``o``
    in q's dtype and the row max ``m`` and row sum ``l`` as (B, H, T) f32.
    Dense over the full scores: ``p = exp(s - m)`` rounded to v's dtype
    for the product with V (f32 accumulation), ``o = acc / max(l,
    1e-30)``. ``scale`` (default ``1/sqrt(D)``): that of a narrower head
    this one zero-pads."""
    s, valid = _scores(q, k, causal, scale)
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    o = acc / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype), m, l


def flash_delta(do, o):
    """``delta = sum_d dO * O`` in f32, as (B, H, T): the backward's row
    term, computed in plain tensor code on every device (the TPU path
    computes it outside its kernels too)."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    return delta.transpose(1, 2).contiguous()


def flash_bwd_ref(q, k, v, do, m, l, delta, causal: bool = False,
                  scale=None):
    """Plain flash backward: ``(dq, dk, dv)`` in the dtypes of q, k, v.
    ``p = valid ? exp(s - m) / max(l, 1e-30) : 0`` from the saved row
    stats, ``ds = p * (dO . v - delta) * scale``; ``dq = ds.to(k) @ k``,
    ``dk = ds.to(q)^T @ q``, ``dv = p.to(dO)^T @ dO``, each accumulated in
    f32 and cast. ``scale`` as in :func:`flash_fwd_ref`."""
    f32 = torch.float32
    scale = _scale(q.shape[-1]) if scale is None else scale
    s, valid = _scores(q, k, causal, scale)
    p = torch.where(valid, torch.exp(s - m[..., None])
                    / torch.clamp_min(l, 1e-30)[..., None], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v.to(f32))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(f32), k.to(f32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(f32), q.to(f32))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(f32), do.to(f32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- CUDA kernels
_LAUNCH = [_I, _I]  # dtype, width
_SHAPE = [_I] * 5 + [ctypes.c_float, _P]  # B, T, H, D, causal, scale, stream
_LIB = _build.Library("flash_attention", {
    "dtt_flash_fwd": _LAUNCH + [_P] * 6 + _SHAPE,
    "dtt_flash_dq": _LAUNCH + [_P] * 8 + _SHAPE,
    "dtt_flash_dkv": _LAUNCH + [_P] * 9 + _SHAPE,
    "dtt_flash_wgmma_smem": [_I, _I],
})
_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def wgmma_smem_bytes(kernel: str, width: int) -> int:
    """Dynamic shared memory a block of the wgmma ``"flash_fwd"``,
    ``"flash_dq"`` or ``"flash_dkv"`` kernel asks for at padded width
    ``width`` (64, 128 or 256)."""
    return _LIB.get().dtt_flash_wgmma_smem(_KERNELS.index(kernel), width)


def _check_qkv(*tensors):
    """Device, dtype, layout and alignment checks of the kernels' inputs:
    contiguous (B, T, H, D) tensors of one dtype on 16-byte boundaries,
    with a dtype and D that :func:`flash_route` takes. Returns the
    route."""
    q = tensors[0]
    route = flash_route(q.dtype, q.shape[-1])
    for i, t in enumerate(tensors):
        _build.require(t, f"input {i}", q.device, q.dtype, 4)
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"flash_attention: shapes {tuple(t.shape)} and "
                             f"{tuple(q.shape)} differ")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be 16-byte aligned")
    return route


def _check_stats(q, *stats):
    b, t, h, _ = q.shape
    for x, name in zip(stats, ("m", "l", "delta")):
        _build.require(x, name, q.device, torch.float32, 3)
        if tuple(x.shape) != (b, h, t):
            raise ValueError(f"{name} must be (B, H, T) = {(b, h, t)}")


def _padded(*tensors):
    """The tensors zero-padded along D to the kernels' width (the same
    tensors where D already is one)."""
    d = tensors[0].shape[-1]
    dp = _kernel_d(tensors[0].dtype, d)
    return tuple(x if dp == d else F.pad(x, (0, dp - d)) for x in tensors)


def _launch(kernel, route, width, tensors, outs, causal, d):
    """Launches ``kernel`` on the padded inputs and outputs, with the
    scale of the real head width ``d``, and counts it."""
    q = tensors[0]
    b, t, h, dp = q.shape
    rc = getattr(_LIB.get(), f"dtt_{kernel}")(
        _build.FLOAT_CODES[q.dtype], width, *(x.data_ptr() for x in tensors),
        *(x.data_ptr() for x in outs), b, t, h, dp, int(causal), _scale(d),
        _build.stream(q.device))
    _build.check_launch(rc, kernel)
    launches[kernel] += 1
    route_launches[f"{kernel}/{route}"] += 1
    dtype_launches[f"{kernel}/{str(q.dtype).replace('torch.', '')}"] += 1


def _unpad(x, d):
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _flash_fwd_cuda(q, k, v, causal):
    route, width = _check_qkv(q, k, v)
    b, t, h, d = q.shape
    qp, kp, vp = _padded(q, k, v)
    o = torch.empty_like(qp)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("flash_fwd", route, width, (qp, kp, vp), (o, m, l), causal, d)
    return _unpad(o, d), m, l


def _flash_dq_cuda(q, k, v, do, m, l, delta, causal):
    route, width = _check_qkv(q, k, v, do)
    _check_stats(q, m, l, delta)
    d = q.shape[-1]
    padded = _padded(q, k, v, do)
    dq = torch.empty_like(padded[0])
    _launch("flash_dq", route, width, (*padded, m, l, delta), (dq,), causal,
            d)
    return _unpad(dq, d)


def _flash_dkv_cuda(q, k, v, do, m, l, delta, causal):
    route, width = _check_qkv(q, k, v, do)
    _check_stats(q, m, l, delta)
    d = q.shape[-1]
    padded = _padded(q, k, v, do)
    dk, dv = torch.empty_like(padded[1]), torch.empty_like(padded[2])
    _launch("flash_dkv", route, width, (*padded, m, l, delta), (dk, dv),
            causal, d)
    return _unpad(dk, d), _unpad(dv, d)


def _flash_bwd_cuda(q, k, v, do, m, l, delta, causal):
    dq = _flash_dq_cuda(q, k, v, do, m, l, delta, causal)
    return (dq, *_flash_dkv_cuda(q, k, v, do, m, l, delta, causal))


def flash_fwd(q, k, v, causal: bool = False):
    """``(o, m, l)`` of :func:`flash_fwd_ref`: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return _build.dispatch(q, _flash_fwd_cuda, flash_fwd_ref,
                           "flash_attention")(q, k, v, causal)


def flash_bwd(q, k, v, do, m, l, delta, causal: bool = False):
    """``(dq, dk, dv)`` of :func:`flash_bwd_ref`: the dQ and dK/dV kernels
    for CUDA tensors, the plain version for CPU tensors."""
    return _build.dispatch(q, _flash_bwd_cuda, flash_bwd_ref,
                           "flash_attention")(q, k, v, do, m, l, delta, causal)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, m, l = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = flash_delta(do, o)
        dq, dk, dv = flash_bwd(q, k, v, do, m, l, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = False,
                    block_q: Optional[int] = None, block_k: int = 1024):
    """softmax(Q K^T / sqrt(d)) V without forming the (T, T) scores on the
    card; differentiable in q, k and v.

    q, k, v: (B, T, H, D), the layout ``MultiHeadAttention`` produces.
    Returns (B, T, H, D) in q's dtype; scores and softmax compute in f32.
    ``block_q``/``block_k`` are the TPU kernels' VMEM tile sizes, kept so
    calls carry over from the JAX package; the card's kernels choose their
    own tiles and ignore them."""
    del block_q, block_k
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        bool(causal))


__all__ = [
    "MAX_D", "dense_attention", "dtype_launches", "flash_attention",
    "flash_bwd",
    "flash_bwd_ref", "flash_delta", "flash_fwd", "flash_fwd_ref",
    "flash_route", "launches", "reset_launch_counts", "route_launches",
]
