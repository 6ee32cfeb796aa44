"""Paged-attention decode: the CUDA kernel and its plain PyTorch version.

The serving decode step reads each slot's KV through a block table. The
``reference`` path (``nn.MultiHeadAttention.paged_decode``) gathers every
slot's blocks into a contiguous ``(S, L, H, hd)`` view and runs dense
masked attention over it. The ``fused`` path calls :func:`paged_attention`
here, which does the gather and the attention in one pass and never forms
the view.

Dispatch is by the device of the tensors, with no fallback:

- CUDA tensors launch the hand-written kernel in
  ``csrc/paged_attention.cu`` (built by ``nvcc`` for ``sm_90a`` at first
  use, into ``_build/``; see ``ops._build``). A failed build or launch
  raises.
- CPU tensors run :func:`paged_attention_ref`, the plain version of the
  same arithmetic. On a card it is used only by tests and by
  ``chip_smoke.py`` to check the kernel.

The kernel replaces the JAX package's Pallas kernels ``_decode_kernel``
(plain pools) and ``_decode_kernel_quant`` (int8 pools) in
``distributed_tpu/ops/paged_attention.py``. ``launches`` counts the
kernel's launches per variant, so a run can show it went through them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..quant import QKEY, SKEY, dequantize
from . import _build
from ._build import _I, _P
from ._common import NEG

REFERENCE = "reference"
FUSED = "fused"
KINDS = (REFERENCE, FUSED)

#: Launches of the CUDA kernel, per variant: "paged_attention" (plain
#: f32/bf16 pools) and "paged_attention_int8" (int8 pools). Incremented
#: only where the kernel is launched.
launches = {"paged_attention": 0, "paged_attention_int8": 0}

def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain version
def paged_view(pool, block_tables, out_dtype=None, *, visible=None):
    """Gather each slot's blocks into a contiguous (S, nb*bs, H, hd) view
    (position j of slot s lives in block ``block_tables[s, j // bs]`` at
    offset ``j % bs``). Plain pools keep their dtype; int8 pools gather q +
    scale and dequantize to ``out_dtype``, zeroing the rows outside
    ``visible`` ((S, L) bool) BEFORE the multiply (payload -> 0, scale ->
    1), so trash and stale rows dequantize to exact zeros instead of
    ``garbage * scale``."""
    if isinstance(pool, dict):
        qv = paged_view(pool[QKEY], block_tables)
        sv = paged_view(pool[SKEY], block_tables)
        if visible is not None:
            vis = visible[:, :, None, None]
            qv = torch.where(vis, qv, torch.zeros_like(qv))
            sv = torch.where(vis, sv, torch.ones_like(sv))
        return dequantize({QKEY: qv, SKEY: sv}, out_dtype)
    g = pool[block_tables.long()]  # (S, nb, bs, H, hd)
    s, nb, bs = g.shape[:3]
    return g.reshape(s, nb * bs, *g.shape[3:])


def paged_attention_ref(q, k_pool, v_pool, block_tables, positions):
    """Plain PyTorch paged attention, with the kernel's arithmetic.

    ``q`` (S, kw, H, hd): kw query rows per slot at consecutive absolute
    positions from ``positions[s]`` (kw=1 is decode). ``k_pool``/
    ``v_pool``: (num_blocks, bs, H, hd) tensors, or int8 ``{"q","scale"}``
    dicts with scales (num_blocks, bs, H, 1). ``block_tables`` (S, nb)
    int32, ``positions`` (S,) int32. Row k of slot s attends to positions
    ``<= positions[s] + k``. Scores ``(q . k) / sqrt(hd)`` in f32, masked
    with ``NEG``; unnormalized probabilities rounded to the value dtype
    before the product with V (accumulated in f32); output
    ``acc / max(l, 1e-30)`` in ``q.dtype``, shape (S, kw, H, hd)."""
    s, kw, h, hd = q.shape
    kq = k_pool[QKEY] if isinstance(k_pool, dict) else k_pool
    bs = kq.shape[1]
    ll = block_tables.shape[1] * bs
    pos = positions.long()
    col = torch.arange(ll, device=q.device)
    rows = pos[:, None] + torch.arange(kw, device=q.device)[None]  # (S, kw)
    valid = col[None, None, :] <= rows[:, :, None]  # (S, kw, L)
    view_vis = col[None, :] <= rows[:, -1:]  # (S, L): any row sees it
    k = paged_view(k_pool, block_tables, q.dtype, visible=view_vis)
    v = paged_view(v_pool, block_tables, q.dtype, visible=view_vis)
    sc = torch.einsum(
        "skhd,slhd->shkl", q.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    sc = torch.where(valid[:, None], sc, NEG)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum(
        "shkl,slhd->shkd", p.to(v.dtype).to(torch.float32),
        v.to(torch.float32),
    )
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


# ------------------------------------------------------------- CUDA kernel
_LIB = _build.Library("paged_attention", {
    "dtt_paged_attention": [_I, _I] + [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P],
    "dtt_paged_attention_max_kw": [],
    "dtt_paged_attention_max_hd": [],
})


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, positions):
    lib = _LIB.get()
    dev = q.device
    quant = isinstance(k_pool, dict)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    _build.require(q, "q", dev, ndim=4)
    s, kw, h, hd = q.shape
    if kw > lib.dtt_paged_attention_max_kw() or \
            hd > lib.dtt_paged_attention_max_hd():
        raise ValueError(
            f"kw={kw}, hd={hd} above the kernel's limits "
            f"({lib.dtt_paged_attention_max_kw()}, "
            f"{lib.dtt_paged_attention_max_hd()})"
        )
    if quant:
        kq, vq = k_pool[QKEY], v_pool[QKEY]
        ksc, vsc = k_pool[SKEY], v_pool[SKEY]
        for t, n in ((kq, "k_pool.q"), (vq, "v_pool.q")):
            _build.require(t, n, dev, torch.int8, 4)
        for t, n in ((ksc, "k_pool.scale"), (vsc, "v_pool.scale")):
            _build.require(t, n, dev, torch.float32, 4)
            if t.shape != kq.shape[:3] + (1,):
                raise ValueError(f"{n} shape {tuple(t.shape)} mismatches")
    else:
        kq, vq, ksc, vsc = k_pool, v_pool, None, None
        for t, n in ((kq, "k_pool"), (vq, "v_pool")):
            _build.require(t, n, dev, q.dtype, 4)
    if kq.shape != vq.shape or tuple(kq.shape[2:]) != (h, hd):
        raise ValueError(
            f"pool shapes {tuple(kq.shape)}/{tuple(vq.shape)} do not match "
            f"q heads {(h, hd)}"
        )
    # The kernel reads pool rows as 16-byte chunks.
    if hd % 16 or kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError(
            f"the kernel needs head_dim % 16 == 0 and 16-byte aligned pools "
            f"(head_dim {hd})"
        )
    _build.require(block_tables, "block_tables", dev, torch.int32, 2)
    _build.require(positions, "positions", dev, torch.int32, 1)
    if block_tables.shape[0] != s or positions.shape[0] != s:
        raise ValueError("block_tables/positions must have one row per slot")
    out = torch.empty_like(q)
    rc = lib.dtt_paged_attention(
        _build.DTYPE_CODES[q.dtype], int(quant), q.data_ptr(), kq.data_ptr(),
        vq.data_ptr(), ksc.data_ptr() if quant else None,
        vsc.data_ptr() if quant else None, block_tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(), s, kw, h, hd, kq.shape[1],
        block_tables.shape[1], float(math.sqrt(hd)),
        _build.stream(dev),
    )
    _build.check_launch(rc, "paged_attention")
    launches["paged_attention_int8" if quant else "paged_attention"] += 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, positions):
    """Fused gather + masked attention over paged KV pools; the arguments
    and result are :func:`paged_attention_ref`'s. CUDA tensors run the
    kernel, CPU tensors the plain version."""
    return _build.dispatch(q, _paged_attention_cuda, paged_attention_ref,
                           "paged_attention")(q, k_pool, v_pool, block_tables,
                                              positions)


__all__ = [
    "FUSED", "KINDS", "REFERENCE", "build", "launches", "paged_attention",
    "paged_attention_ref", "paged_view", "reset_launch_counts",
]
