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
  use, into ``_build/``; see ``ops._build``), once per call, for any
  number of query rows kw >= 1 (the kernel takes them in row groups of
  8, each a kw <= 8 problem at positions shifted by the group's first
  row). It splits each (slot, head, row group)'s visible rows into
  chunks of :func:`chunk_blocks` pool blocks and merges the chunks in a
  fixed order, through a scratch of arrival counters and f32 partials
  kept per stream between calls. A failed build or launch raises.
- CPU tensors run :func:`paged_attention_ref`, the plain version of the
  same arithmetic. On a card it is used only by tests and by
  ``chip_smoke.py`` to check the kernel.

The kernel replaces the JAX package's Pallas kernels ``_decode_kernel``
(plain pools) and ``_decode_kernel_quant`` (int8 pools) in
``distributed_tpu/ops/paged_attention.py``. ``launches`` counts the
kernel's launches per variant, so a run can show it went through them.
"""

from __future__ import annotations

import functools
import math

import torch

from ..quant import QKEY, SKEY, dequantize
from . import _build
from ._common import NEG

REFERENCE = "reference"
FUSED = "fused"
KINDS = (REFERENCE, FUSED)

#: Launches of the CUDA kernel, per variant: "paged_attention" (plain
#: f32/bf16/f16 pools) and "paged_attention_int8" (int8 pools).
#: Incremented only where the kernel is launched.
launches = {"paged_attention": 0, "paged_attention_int8": 0}
#: The same launches by (variant, kw): decode reads kw = 1, a speculative
#: verify kw = spec_k.
launches_by_kw = {}
#: The same launches by (variant, read path): "vector" reads whole 16-byte
#: chunks, "scalar" element by element (a head width or a pool address
#: off 16 bytes, e.g. a stacked pool's slice).
launches_by_path = {}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
    launches_by_kw.clear()
    launches_by_path.clear()


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
#: Rows a chunk of the kernel's split over the sequence aims at: at the
#: serving shapes 128 beat 64 and 256 (PERF.md).
_CHUNK_ROWS = 128
#: Most pool blocks in one chunk: the kernel holds a chunk's block-table
#: entries one per lane of a warp.
MAX_CHUNK_BLOCKS = 32


@functools.lru_cache(maxsize=None)
def chunk_blocks(s, h, nb, bs, sms):
    """Pool blocks per chunk of the kernel's split over the sequence, from
    the shapes alone (the host never reads the positions): the whole
    blocks that cover ``_CHUNK_ROWS`` rows, halved while a server of ``s``
    slots at its full length of ``nb * bs`` would not give the card's
    ``sms`` SMs two waves of (chunk, head, slot) blocks."""
    cb = min(nb, MAX_CHUNK_BLOCKS, -(-_CHUNK_ROWS // bs))
    while cb > 1 and s * h * -(-nb // cb) < 2 * sms:
        cb = -(-cb // 2)
    return cb


#: The launcher's arguments (``PagedArgs`` in the source): q, k_pool,
#: v_pool, k_scale, v_scale, tables, positions, out, partials, counters,
#: stream, dtype, quant, vec, S, kw, H, hd, bs, nb, chunk_blocks.
_ARGS = _build.packed(21)
_LIB = _build.Library("paged_attention", {
    "dtt_paged_attention": _ARGS,
    "dtt_paged_attention_kw_group": [],
    "dtt_paged_attention_max_hd": [],
})
_WORKSPACE = {}  # (device index, stream) -> (counters, partials)
_sm_count = _build.sm_count


def _workspace(dev, st, n_counters, n_floats):
    """The merge's scratch for launches on stream ``st``
    (:func:`_build.workspace`)."""
    return _build.workspace(_WORKSPACE, dev, st, n_counters, n_floats)


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, positions):
    dev = q.device
    quant = isinstance(k_pool, dict)
    code = _build.FLOAT_CODES.get(q.dtype)
    if code is None:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16, f16)")
    _build.require(q, "q", dev, ndim=4)
    s, kw, h, hd = q.shape
    group = _LIB.constant("dtt_paged_attention_kw_group")
    max_hd = _LIB.constant("dtt_paged_attention_max_hd")
    if hd > max_hd:
        raise ValueError(f"hd={hd} above the kernel's limit ({max_hd})")
    if quant:
        kq, vq = k_pool[QKEY], v_pool[QKEY]
        ksc, vsc = k_pool[SKEY], v_pool[SKEY]
        for t, n in ((kq, "k_pool.q"), (vq, "v_pool.q")):
            _build.require(t, n, dev, torch.int8, 4)
        for t, n in ((ksc, "k_pool.scale"), (vsc, "v_pool.scale")):
            _build.require(t, n, dev, torch.float32, 4)
            if t.shape != kq.shape[:3] + (1,):
                raise ValueError(f"{n} shape {tuple(t.shape)} mismatches")
        kscp, vscp = ksc.data_ptr(), vsc.data_ptr()
    else:
        kq, vq, kscp, vscp = k_pool, v_pool, 0, 0
        for t, n in ((kq, "k_pool"), (vq, "v_pool")):
            _build.require(t, n, dev, q.dtype, 4)
    if kq.shape != vq.shape or kq.shape[2:] != (h, hd):
        raise ValueError(
            f"pool shapes {tuple(kq.shape)}/{tuple(vq.shape)} do not match "
            f"q heads {(h, hd)}"
        )
    _build.require(block_tables, "block_tables", dev, torch.int32, 2)
    _build.require(positions, "positions", dev, torch.int32, 1)
    if block_tables.shape[0] != s or positions.shape[0] != s:
        raise ValueError("block_tables/positions must have one row per slot")
    # Pool rows of whole 16-byte chunks on 16-byte boundaries are read as
    # chunks; any other head width element by element. Chosen from the
    # shape before the launch, never on failure; the pools are not copied.
    kp, vp = kq.data_ptr(), vq.data_ptr()
    vec = int(hd * kq.element_size() % 16 == 0 and kp % 16 == 0
              and vp % 16 == 0)
    bs, nb = kq.shape[1], block_tables.shape[1]
    index = q.get_device()
    cb = chunk_blocks(s, h, nb, bs, _sm_count(index))
    st = _build.raw_stream(index)
    groups = -(-kw // group)
    counters, partials = _workspace(
        dev, st, s * h * groups,
        s * h * groups * -(-nb // cb) * min(kw, group) * (2 + hd))
    out = torch.empty_like(q)
    rc = _LIB.get().dtt_paged_attention(_ARGS.pack(
        q.data_ptr(), kp, vp, kscp, vscp, block_tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(), partials.data_ptr(),
        counters.data_ptr(), st, code, quant, vec, s, kw, h, hd, bs, nb, cb))
    if rc:
        _build.check_launch(rc, "paged_attention")
    name = "paged_attention_int8" if quant else "paged_attention"
    launches[name] += 1
    launches_by_kw[(name, kw)] = launches_by_kw.get((name, kw), 0) + 1
    path = (name, "vector" if vec else "scalar")
    launches_by_path[path] = launches_by_path.get(path, 0) + 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, positions):
    """Fused gather + masked attention over paged KV pools; the arguments
    and result are :func:`paged_attention_ref`'s. CUDA tensors run the
    kernel, CPU tensors the plain version."""
    return _build.dispatch(q, _paged_attention_cuda, paged_attention_ref,
                           "paged_attention")(q, k_pool, v_pool, block_tables,
                                              positions)


__all__ = [
    "FUSED", "KINDS", "MAX_CHUNK_BLOCKS", "REFERENCE",
    "chunk_blocks", "launches", "launches_by_kw", "launches_by_path",
    "paged_attention",
    "paged_attention_ref", "paged_view", "reset_launch_counts",
]
