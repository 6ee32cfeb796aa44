"""The GEMM of a 1x1 convolution (kernel K12) and its gradient.

A 1x1 convolution over NHWC activations is one matrix product: the
activation's (N*H*W, Cin) rows times the (Cin, Cout) kernel. The JAX
package's ``examples/pallas_conv1x1.py`` wrote that product as a Pallas
kernel, ``_mm_kernel``; the port's ``nn.Conv2D`` routes every 1x1 kernel
here, and ``csrc/conv1x1.cu`` replaces it: bf16 and f16 on the tensor
cores, f32 on the CUDA cores (no TF32), the products summed in f32 and
rounded once to the input dtype, as ``_mm_kernel`` does
(``preferred_element_type=f32`` then ``.astype``). :func:`conv1x1_route`
picks the kernel from the dtype before the launch: bf16 and f16 go to the
Hopper kernel (``wgmma``, ``cp.async`` ring), whose rows are whole 16-byte
chunks, so a K or N that is not a multiple of 8 (no ResNet-50 shape) is
zero-padded in a copy; f32 goes to the CUDA-core kernel.

:func:`conv1x1_apply` is differentiable. Its backward computes dX = dY @
W^T through the same kernel (a block of rows times a small matrix, the
same shape class) and dW = X^T @ dY with ``torch.matmul``: the JAX package
leaves the convolution's backward to XLA, and K12 has no backward kernel.

Dispatch is by the device of the tensors, with no fallback: CUDA tensors
launch the kernel (a failed build or launch raises), CPU tensors run
:func:`conv1x1_ref`, the plain version. ``launches`` counts the kernel's
launches (one per call), ``route_launches`` the same per route.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import _I, _P
from ._common import round_up

#: Launches of the CUDA kernel; incremented only where it is launched.
launches = {"conv1x1": 0}
#: The same launches by route (see :func:`conv1x1_route`).
route_launches = {"conv1x1/cuda_core": 0, "conv1x1/wgmma": 0}


def reset_launch_counts() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


def conv1x1_route(dtype, k: int, n: int):
    """``(route, k, n)``: the kernel for an ``(M, k) @ (k, n)`` product of
    ``dtype`` and the widths it is launched at. bf16 and f16 take
    ``"wgmma"`` with ``k`` and ``n`` rounded up to multiples of 8 (rows of
    whole 16-byte chunks; the zero columns and rows of the padded copy add
    nothing to any sum); float32 takes ``"cuda_core"`` at ``k`` and
    ``n``."""
    if dtype == torch.float32:
        return "cuda_core", k, n
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"conv1x1: dtype {dtype} not supported "
                         "(float32, bfloat16, float16)")
    return "wgmma", round_up(k, 8), round_up(n, 8)


def padded(t, rows: int, cols: int):
    """``t`` as a ``(rows, cols)`` tensor on a 16-byte boundary: ``t``
    itself where it already is one, else a copy with zeros past ``t``'s
    rows and columns."""
    if tuple(t.shape) == (rows, cols) and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def conv1x1_ref(x2d, w):
    """(M, K) @ (K, N) summed in f32 and rounded once to ``x2d``'s dtype."""
    return (x2d.float() @ w.float()).to(x2d.dtype)


_LIB = _build.Library("conv1x1", {
    "dtt_conv1x1": [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    "dtt_conv1x1_wgmma_smem": [],
})


def wgmma_smem_bytes() -> int:
    """Dynamic shared memory a block of the wgmma kernel asks for."""
    return _LIB.get().dtt_conv1x1_wgmma_smem()


def _conv1x1_cuda(x2d, w):
    _build.require(x2d, "x2d", x2d.device, ndim=2)
    _build.require(w, "w", x2d.device, x2d.dtype, 2)
    m, k = x2d.shape
    if w.shape[0] != k:
        raise ValueError(f"conv1x1: x2d is {tuple(x2d.shape)}, w "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    route, k_run, n_run = conv1x1_route(x2d.dtype, k, n)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    if route == "wgmma":
        x2d, w = padded(x2d, m, k_run), padded(w, k_run, n_run)
    out = torch.empty((m, n_run), dtype=x2d.dtype, device=x2d.device)
    rc = _LIB.get().dtt_conv1x1(
        _build.FLOAT_CODES[x2d.dtype], x2d.data_ptr(), w.data_ptr(),
        out.data_ptr(), m, k_run, n_run, _build.stream(x2d.device))
    _build.check_launch(rc, "conv1x1")
    launches["conv1x1"] += 1
    route_launches[f"conv1x1/{route}"] += 1
    return out if n_run == n else out[:, :n].contiguous()


def conv1x1(x2d, w):
    """:func:`conv1x1_ref`'s product: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _build.dispatch(x2d, _conv1x1_cuda, conv1x1_ref, "conv1x1")(x2d, w)


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return conv1x1(x2d, w)

    @staticmethod
    def backward(ctx, dy):
        x2d, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = (conv1x1(dy, w.t().contiguous())
              if ctx.needs_input_grad[0] else None)
        dw = torch.matmul(x2d.t(), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv1x1_apply(x2d, w):
    """Differentiable ``(M, K) @ (K, N)`` of one dtype: K12 forward, K12
    for dX, ``torch.matmul`` for dW."""
    return _Conv1x1.apply(x2d.contiguous(), w.contiguous())


__all__ = [
    "conv1x1", "conv1x1_apply", "conv1x1_ref", "conv1x1_route", "launches",
    "padded", "reset_launch_counts", "route_launches", "wgmma_smem_bytes",
]
