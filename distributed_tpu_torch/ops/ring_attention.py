"""Ring attention: exact attention over a sequence split across ranks.

The JAX package's ``ops/ring_attention.py`` in the port. Each rank of the
mesh's ``seq_axis`` line holds one block of T/n positions of q, k and v,
(B, T/n, H, D). The K/V blocks rotate round the ring (``collectives.
ppermute``, point-to-point sends to the next rank) while each rank folds
every block into a running (max, denominator, accumulator): the
online-softmax recurrence of flash attention, across ranks. No rank
forms the (T, T) scores or gathers K/V. Causal masks use global
positions, so the result equals masking the whole matrix.

Causal schedule: the naive ring folds every block on every rank, so
with causal masking about half of the (rank, block) pairs are fully
masked and the last rank does n live folds where the first does 1. The
default causal path is the ZIGZAG schedule: the sequence is 2n half
chunks, and boundary permutations give rank i chunks (i, 2n-1-i), one
early and one late; every rotated hop then has exactly two live chunk
pairs on every rank, unmasked, and only the resident hop masks.
``schedule="naive"`` keeps the plain ring.

The fold keeps JAX's arithmetic: f32 einsums, the scale ``1/sqrt(D)``
taken in f32, ``-inf`` masking and the guard chain for rows whose max is
still ``-inf``. It runs as plain torch products (the JAX package computes
it outside any Pallas kernel), and autograd runs through the fold and
the permutations, as JAX differentiates its scan: each hop keeps its
(B, H, T/n, T/n) f32 scores for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import ppermute


def _online_fold(m, l, acc, qf, kc, vc, scale, mask):
    """One block fold of the online-softmax recurrence; ``mask=None``:
    the block is fully live. Rows with no live key yet have ``m ==
    -inf``; the guards keep ``exp(-inf - -inf)`` out."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.to(torch.float32)) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    safe = torch.isfinite(m_new)
    m_ref = torch.where(safe, m_new, 0.0)
    alpha = torch.where(safe, torch.exp(m - m_ref), 0.0)
    p = torch.exp(s - m_ref[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = l * alpha + torch.sum(p, dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, vc.to(torch.float32))
    return m_new, l, acc


def _scale(d: int, device) -> torch.Tensor:
    # 1 / sqrt(D) in f32, as JAX computes it.
    return 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                       device=device))


def _finish(acc, l, dtype):
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, H, Tb, D)
    return out.permute(0, 2, 1, 3).to(dtype)


def _state(b, h, t, d, device):
    return (torch.full((b, h, t), float("-inf"), device=device),
            torch.zeros((b, h, t), device=device),
            torch.zeros((b, h, t, d), device=device))


def _ring(q, k, v, n, my, group, causal):
    b, tb, h, d = q.shape
    scale = _scale(d, q.device)
    qf = q.to(torch.float32)
    q_pos = my * tb + torch.arange(tb, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]

    def fold(state, kc, vc, i):
        # After i rotations this rank holds the block that started on
        # rank (my - i) mod n.
        mask = None
        if causal:
            k_pos = ((my - i) % n) * tb + torch.arange(tb, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        return _online_fold(*state, qf, kc, vc, scale, mask)

    state = fold(_state(b, h, tb, d, q.device), k, v, 0)
    kv = torch.stack((k, v))
    for i in range(1, n):
        kv = ppermute(kv, perm, group)
        state = fold(state, kv[0], kv[1], i)
    m, l, acc = state
    return _finish(acc, l, q.dtype)


def _zigzag_perms(n: int):
    """Boundary permutations between the contiguous and zigzag layouts
    (JAX's ``_zigzag_perms``): contiguous rank s holds chunks (2s, 2s+1),
    zigzag rank i holds (i, 2n-1-i); each list is the ``(source, dest)``
    pairs of one (source slot -> dest slot) permutation, the inverse
    four after the forward four."""
    lo_from_lo = [(s, 2 * s) for s in range(n) if 2 * s < n]
    lo_from_hi = [(s, 2 * s + 1) for s in range(n) if 2 * s + 1 < n]
    hi_from_lo = [(s, 2 * n - 1 - 2 * s) for s in range(n) if 2 * s >= n]
    hi_from_hi = [(s, 2 * n - 2 - 2 * s) for s in range(n) if 2 * s + 1 >= n]
    inv_lo_from_lo = [(2 * d, d) for d in range(n) if 2 * d < n]
    inv_lo_from_hi = [(2 * n - 1 - 2 * d, d) for d in range(n) if 2 * d >= n]
    inv_hi_from_lo = [(2 * d + 1, d) for d in range(n) if 2 * d + 1 < n]
    inv_hi_from_hi = [(2 * n - 2 - 2 * d, d) for d in range(n)
                      if 2 * d + 1 >= n]
    return ((lo_from_lo, lo_from_hi, hi_from_lo, hi_from_hi),
            (inv_lo_from_lo, inv_lo_from_hi, inv_hi_from_lo,
             inv_hi_from_hi))


def _relayout(lo, hi, perms, group):
    """Both slots through one set of four boundary permutations (a slot
    no pair fills receives zeros, so each sum is one chunk)."""
    p_ll, p_lh, p_hl, p_hh = perms
    return (ppermute(lo, p_ll, group) + ppermute(hi, p_lh, group),
            ppermute(lo, p_hl, group) + ppermute(hi, p_hh, group))


def _zigzag(q, k, v, n, my, group):
    b, tb, h, d = q.shape
    c = tb // 2
    scale = _scale(d, q.device)
    fwd, inv = _zigzag_perms(n)
    # q, k and v move together: one stacked tensor per permutation.
    qkv_lo, qkv_hi = _relayout(torch.stack((q[:, :c], k[:, :c], v[:, :c])),
                               torch.stack((q[:, c:], k[:, c:], v[:, c:])),
                               fwd, group)
    qf_lo, qf_hi = qkv_lo[0].to(torch.float32), qkv_hi[0].to(torch.float32)
    k_lo, v_lo, k_hi, v_hi = qkv_lo[1], qkv_lo[2], qkv_hi[1], qkv_hi[2]

    def fold(state, qf, kc, vc, mask=None):
        return _online_fold(*state, qf, kc, vc, scale, mask)

    lo = _state(b, h, c, d, q.device)
    hi = _state(b, h, c, d, q.device)
    # The resident hop, the only masked one: (q_lo, k_lo) and (q_hi,
    # k_hi) are diagonal chunks, (q_hi, k_lo) is live, (q_lo, k_hi) dead.
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    lo = fold(lo, qf_lo, k_lo, v_lo, tri)
    hi = fold(hi, qf_hi, k_lo, v_lo)
    hi = fold(hi, qf_hi, k_hi, v_hi, tri)
    perm = [(j, (j + 1) % n) for j in range(n)]
    kv = torch.stack((k_lo, k_hi, v_lo, v_hi))
    for j in range(1, n):
        kv = ppermute(kv, perm, group)
        klo, khi, vlo, vhi = kv.unbind(0)
        src = (my - j) % n
        # Always live: this rank's late chunk against src's early one.
        hi = fold(hi, qf_hi, klo, vlo)
        # The second live pair: the early q chunk with src's early k
        # chunk when my > src, else the late q chunk with its late chunk.
        if my > src:
            lo = fold(lo, qf_lo, klo, vlo)
        else:
            hi = fold(hi, qf_hi, khi, vhi)
    out_lo, out_hi = _relayout(_finish(lo[2], lo[1], q.dtype),
                               _finish(hi[2], hi[1], q.dtype), inv, group)
    return torch.cat([out_lo, out_hi], dim=1)


def ring_attention(q, k, v, *, mesh, seq_axis: str = "seq",
                   batch_axis: Optional[str] = None, causal: bool = False,
                   schedule: str = "auto"):
    """Attention over this rank's (B, T/n, H, D) blocks of q, k and v,
    whose T dimension is split over the ``n`` ranks of ``mesh``'s
    ``seq_axis`` line in rank order; returns this rank's (B, T/n, H, D)
    block of the output. ``batch_axis`` is JAX's argument, kept: a rank's
    rows are already its own here. ``schedule``: "auto" (zigzag for
    causal attention when the block splits in half, else naive),
    "zigzag" or "naive", with JAX's errors."""
    if schedule not in ("auto", "zigzag", "naive"):
        raise ValueError(f"unknown schedule {schedule!r}")
    n = int(mesh.size(tuple(mesh.mesh_dim_names).index(seq_axis)))
    group = mesh.get_group(seq_axis)
    my = int(mesh.get_local_rank(seq_axis))
    tb = q.shape[1]
    use_zigzag = causal and n > 1 and tb % 2 == 0
    if schedule == "zigzag" and not use_zigzag:
        raise ValueError(
            "schedule='zigzag' needs causal=True, >1 seq shard, and an "
            f"even per-shard length (got causal={causal}, shards={n}, "
            f"per-shard={tb})")
    if use_zigzag and schedule != "naive":
        return _zigzag(q, k, v, n, my, group)
    return _ring(q, k, v, n, my, group, causal)


__all__ = ["ring_attention"]
