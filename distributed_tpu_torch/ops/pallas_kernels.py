"""Fused softmax cross-entropy: forward and backward as CUDA kernels.

The JAX package's ``ops/pallas_kernels.py`` keeps this op under its Pallas
name, and so does the port, so ``compile(loss=
"pallas_sparse_categorical_crossentropy")`` carries over unchanged. The
kernels (``csrc/xent.cu``) replace the Pallas kernels ``_xent_fwd_kernel``
and ``_xent_bwd_kernel``: at the LM head's vocabulary (N rows of C = 32k
classes) the forward writes only the (N,) losses, never the (N, C)
log-probabilities, and the backward recomputes the softmax from the
logits instead of saving it.

Dispatch is by the device of the tensors, with no fallback: CUDA tensors
launch the kernels (a failed build or launch raises), CPU tensors run
:func:`xent_fwd_ref` / :func:`xent_bwd_ref`, the plain versions of the
same arithmetic. Logits may be f32, bf16 or f16, as the JAX package's
kernels take them; the losses are f32 and the dlogits take the logits'
dtype. ``launches`` counts each kernel's launches.

Above ``MAX_FUSED_CLASSES`` classes the registry-level losses use the
stock loss, with a one-time warning, exactly as the JAX package does: its
kernel blocks over rows only, and a row block must fit VMEM. The choice is
made by the class count, never by a failure.
"""

from __future__ import annotations

import logging

import torch

from . import _build
from ._build import _I, _P
from ._common import NEG

#: Launches of each CUDA kernel; incremented only where it is launched.
launches = {"xent_fwd": 0, "xent_bwd": 0}

# The JAX package's ceiling for the fused path (ops/pallas_kernels.py).
MAX_FUSED_CLASSES = 65536

_log = logging.getLogger(__name__)


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------- plain versions
def _row_stats(logits):
    """f32 logits, row max (at least NEG, the TPU's column padding) and
    ``exp(x - max)``."""
    x = logits.to(torch.float32)
    m = torch.clamp_min(x.amax(dim=-1, keepdim=True), NEG)
    return x, m, torch.exp(x - m)


def _onehot(labels, c, device):
    col = torch.arange(c, device=device)
    return col[None, :] == labels.reshape(-1, 1).long()


def xent_fwd_ref(logits, labels):
    """Per-row cross-entropy of (N, C) logits and (N,) int labels as (N,)
    f32: ``(log(sum(exp(x - m))) + m) - x[label]``, all in f32. A label
    outside [0, C) is not valid input; it picks 0 here and in the kernel."""
    x, m, e = _row_stats(logits)
    lse = torch.log(e.sum(dim=-1)) + m[:, 0]
    hit = _onehot(labels, x.shape[-1], x.device)
    picked = torch.where(hit, x, 0.0).sum(dim=-1)
    return lse - picked


def xent_bwd_ref(logits, labels, g):
    """Gradient of ``sum(g * xent_fwd_ref(logits, labels))`` in the
    logits: ``(exp(x - m) / sum - onehot) * g[:, None]`` in f32, cast to
    the logits' dtype. The softmax is recomputed and divided by the sum."""
    x, _, e = _row_stats(logits)
    p = e / e.sum(dim=-1, keepdim=True)
    onehot = _onehot(labels, x.shape[-1], x.device).to(torch.float32)
    return ((p - onehot) * g.to(torch.float32)[:, None]).to(logits.dtype)


# ------------------------------------------------------------- CUDA kernels
_LIB = _build.Library("xent", {
    "dtt_xent_fwd": [_I] + [_P] * 3 + [_I] * 3 + [_P],
    "dtt_xent_bwd": [_I] + [_P] * 4 + [_I] * 3 + [_P],
})


def _prepare(logits, labels):
    """Checks shared by both launches; labels as contiguous int64 and the
    kernels' 16-byte-vector flag."""
    if logits.dtype not in _build.FLOAT_CODES:
        raise ValueError(f"fused_softmax_xent: dtype {logits.dtype} not "
                         "supported (float32, bfloat16, float16)")
    _build.require(logits, "logits", logits.device, ndim=2)
    n, c = logits.shape
    labels = labels.reshape(-1).to(torch.int64).contiguous()
    if labels.shape[0] != n or labels.device != logits.device:
        raise ValueError(f"labels must be ({n},) on {logits.device}")
    per_vec = 16 // logits.element_size()
    vec = int(c % per_vec == 0 and logits.data_ptr() % 16 == 0)
    return labels, n, c, vec


def _xent_fwd_cuda(logits, labels):
    lib = _LIB.get()
    labels, n, c, vec = _prepare(logits, labels)
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    rc = lib.dtt_xent_fwd(
        _build.FLOAT_CODES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        loss.data_ptr(), n, c, vec, _build.stream(logits.device))
    _build.check_launch(rc, "xent_fwd")
    launches["xent_fwd"] += 1
    return loss


def _xent_bwd_cuda(logits, labels, g):
    lib = _LIB.get()
    labels, n, c, vec = _prepare(logits, labels)
    g = g.to(torch.float32).contiguous()
    _build.require(g, "g", logits.device, torch.float32, 1)
    dlogits = torch.empty_like(logits)
    rc = lib.dtt_xent_bwd(
        _build.FLOAT_CODES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
        g.data_ptr(), dlogits.data_ptr(), n, c, vec,
        _build.stream(logits.device))
    _build.check_launch(rc, "xent_bwd")
    launches["xent_bwd"] += 1
    return dlogits


def xent_fwd(logits, labels):
    """:func:`xent_fwd_ref`'s result: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _build.dispatch(logits, _xent_fwd_cuda, xent_fwd_ref,
                           "fused_softmax_xent")(logits, labels)


def xent_bwd(logits, labels, g):
    """:func:`xent_bwd_ref`'s result: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _build.dispatch(logits, _xent_bwd_cuda, xent_bwd_ref,
                           "fused_softmax_xent")(logits, labels, g)


def _check_classes(c: int):
    if c > MAX_FUSED_CLASSES:
        raise ValueError(
            f"fused_softmax_xent supports at most {MAX_FUSED_CLASSES} "
            f"classes (got {c}), as the JAX package's kernel does. Use "
            "losses.sparse_categorical_crossentropy (the registry-level "
            "pallas loss switches to it by itself)."
        )


# :func:`xent_fwd` as an operator of the dispatcher, so selective
# checkpointing sees it: the chunked head (``compile(head_chunks=)``) keeps
# its (N,) losses and recomputes only the logits, and the recompute launches
# no K9. It is defined through ``torch.library.Library``, not
# ``torch.library.custom_op``: a custom_op's first call imports
# ``torch._dynamo`` (its backend functions are wrapped in
# ``torch._disable_dynamo``), and with it FSDP, DTensor and sympy, 11-14 s
# of a fresh process's first training step on an H100 host that caches no
# bytecode (``tests/test_torch_xent.py::test_first_call_imports_no_dynamo``).
_OPS = torch.library.Library("dtt", "DEF")
_OPS.define("xent_fwd(Tensor logits, Tensor labels) -> Tensor")
_OPS.impl("xent_fwd", xent_fwd, "CompositeExplicitAutograd")


@torch.library.register_fake("dtt::xent_fwd", lib=_OPS)
def _(logits, labels):
    return logits.new_empty((logits.shape[0],), dtype=torch.float32)


#: The operator whose outputs a checkpoint may keep (``nn.remat``).
XENT_FWD_OP = torch.ops.dtt.xent_fwd.default


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        _check_classes(logits.shape[-1])
        ctx.save_for_backward(logits, labels)
        return torch.ops.dtt.xent_fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return xent_bwd(logits, labels, g), None


def fused_softmax_xent(logits, labels):
    """Per-example cross-entropy from logits: (N, C), (N,) -> (N,) float32.

    ``-log_softmax(logits)[labels]`` without the (N, C) log-probabilities;
    differentiable in the logits. C must be at most ``MAX_FUSED_CLASSES``;
    the registry-level loss switches to the stock loss above it."""
    return _FusedXent.apply(logits.contiguous(), labels)


_warned_stock = False


def _stock_above_ceiling(c: int) -> bool:
    global _warned_stock
    if c <= MAX_FUSED_CLASSES:
        return False
    if not _warned_stock:
        _log.warning(
            f"pallas loss: {c} classes exceeds the fused ceiling "
            f"({MAX_FUSED_CLASSES}); using the stock loss"
        )
        _warned_stock = True
    return True


def pallas_sparse_categorical_crossentropy(logits, labels):
    """Mean fused cross-entropy, the drop-in for the stock loss via
    ``compile(loss="pallas_sparse_categorical_crossentropy")``. Leading
    batch dims are flattened ((B, T, C) token losses included). Class
    counts beyond ``MAX_FUSED_CLASSES`` use the stock loss."""
    c = logits.shape[-1]
    if _stock_above_ceiling(c):
        from . import losses

        return losses.sparse_categorical_crossentropy(logits, labels)
    flat = logits.reshape(-1, c)
    return fused_softmax_xent(flat, labels.reshape(-1)).mean()


def per_example_pallas_xent(logits, labels):
    c = logits.shape[-1]
    if _stock_above_ceiling(c):
        from . import losses

        return losses._per_example_sparse_cce(logits, labels)
    out = fused_softmax_xent(logits.reshape(-1, c), labels.reshape(-1))
    return out.reshape(labels.shape)


__all__ = [
    "MAX_FUSED_CLASSES", "XENT_FWD_OP", "fused_softmax_xent", "launches",
    "pallas_sparse_categorical_crossentropy", "per_example_pallas_xent",
    "reset_launch_counts", "xent_bwd", "xent_bwd_ref", "xent_fwd",
    "xent_fwd_ref",
]
