"""Port paged attention (distributed_tpu_torch.ops.paged_attention).

The plain version ``paged_attention_ref`` against the JAX package's Pallas
kernel (interpret mode on the CPU, as tests/test_paged_kernel.py runs it)
on the same seeded inputs; the trash/future-row mask; and the dispatch
rule (CPU tensors never reach the CUDA path). The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py.

Tolerances: 2e-5 for f32 (the two sum in different orders), 2e-2 for bf16
(probabilities round to bf16 at different running maxima).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops import paged_attention as jax_paged
from distributed_tpu.quant import QKEY, SKEY
from distributed_tpu_torch.ops import paged_attention as port_paged
from distributed_tpu_torch.ops._common import NEG

torch.set_num_threads(1)


def _case(seed, s, nb, bs, h, hd, kw, int8=False):
    """Seeded numpy inputs: disjoint per-slot tables, positions spread
    over the span (early rows leave whole blocks invisible)."""
    rng = np.random.default_rng(seed)
    nblocks = s * nb + 1
    kp = rng.standard_normal((nblocks, bs, h, hd)).astype(np.float32)
    vp = rng.standard_normal((nblocks, bs, h, hd)).astype(np.float32)
    q = rng.standard_normal((s, kw, h, hd)).astype(np.float32)
    tables = (1 + np.arange(s * nb).reshape(s, nb)).astype(np.int32)
    positions = rng.integers(0, nb * bs - kw + 1, (s,)).astype(np.int32)
    positions[0] = 0
    if int8:
        def quant(pool):
            amax = np.max(np.abs(pool), axis=-1, keepdims=True)
            scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            return {QKEY: np.clip(np.round(pool / scale), -127, 127)
                    .astype(np.int8), SKEY: scale}
        kp, vp = quant(kp), quant(vp)
    return q, kp, vp, tables, positions


def _jax(q, kp, vp, tables, positions, dtype):
    pool = (lambda p: {k: jnp.asarray(v) for k, v in p.items()}
            if isinstance(p, dict) else jnp.asarray(p, dtype))
    out = jax_paged.paged_attention(
        jnp.asarray(q, dtype), pool(kp), pool(vp), jnp.asarray(tables),
        jnp.asarray(positions))
    return np.asarray(out.astype(jnp.float32))


def _port(q, kp, vp, tables, positions, dtype, device="cpu", fn=None):
    pool = (lambda p: {k: torch.from_numpy(v).to(device)
                       for k, v in p.items()}
            if isinstance(p, dict)
            else torch.from_numpy(p).to(device=device, dtype=dtype))
    fn = fn or port_paged.paged_attention
    out = fn(torch.from_numpy(q).to(device=device, dtype=dtype), pool(kp),
             pool(vp), torch.from_numpy(tables).to(device),
             torch.from_numpy(positions).to(device))
    return out.to(torch.float32).cpu().numpy()


MATRIX = [
    # (block_size, head_dim, dtype, kw, int8)
    (4, 4, "float32", 1, False),
    (4, 8, "float32", 3, False),
    (8, 4, "float32", 1, False),
    (4, 4, "bfloat16", 1, False),
    (8, 8, "bfloat16", 3, False),
    (4, 4, "float32", 1, True),
    (4, 8, "float32", 3, True),
    (8, 8, "bfloat16", 1, True),
]


@pytest.mark.parametrize(
    "bs,hd,dtype,kw,int8", MATRIX,
    ids=[f"bs{b}-hd{d}-{t}-kw{k}{'-int8' if q else ''}"
         for b, d, t, k, q in MATRIX])
def test_ref_matches_jax_kernel(bs, hd, dtype, kw, int8):
    case = _case(seed=bs * 100 + hd * 10 + kw, s=3, nb=3, bs=bs, h=2, hd=hd,
                 kw=kw, int8=int8)
    want = _jax(*case, getattr(jnp, dtype))
    got = _port(*case, getattr(torch, dtype))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_ref_ignores_trash_and_future_rows(int8):
    """Poison every row the causal mask hides (the trash block and the
    positions past each slot's last query row) with huge values, or with
    non-finite scales on int8 pools: the output must not move."""
    q, kp, vp, tables, positions = _case(
        seed=7, s=2, nb=2, bs=4, h=2, hd=4, kw=2, int8=int8)
    clean = _port(q, kp, vp, tables, positions, torch.float32)
    kp2 = {k: v.copy() for k, v in kp.items()} if int8 else kp.copy()
    vp2 = {k: v.copy() for k, v in vp.items()} if int8 else vp.copy()

    def poison(pool, blk, off):
        if int8:
            pool[QKEY][blk, off] = 127
            pool[SKEY][blk, off] = np.inf
        else:
            pool[blk, off] = 1e30

    for pool in (kp2, vp2):
        for off in range(4):
            poison(pool, 0, off)  # trash block
        for s, pos in enumerate(positions):
            for j in range(int(pos) + 2, tables.shape[1] * 4):
                poison(pool, tables[s, j // 4], j % 4)
    poisoned = _port(q, kp2, vp2, tables, positions, torch.float32)
    assert np.all(np.isfinite(poisoned))
    np.testing.assert_array_equal(clean, poisoned)


def test_cpu_dispatch_runs_plain_version_and_counts_no_launch():
    case = _case(seed=3, s=2, nb=2, bs=4, h=2, hd=4, kw=1)
    port_paged.reset_launch_counts()
    got = _port(*case, torch.float32)
    want = _port(*case, torch.float32, fn=port_paged.paged_attention_ref)
    np.testing.assert_array_equal(got, want)
    assert port_paged.launches == {
        "paged_attention": 0, "paged_attention_int8": 0}


# ------------------------------------------- the kernel's split over the sequence
# The CUDA kernel cuts each (slot, head)'s visible rows into chunks of whole
# pool blocks, one CTA each, and merges the chunks' (m, l, acc) in chunk
# order. Its planner is host code; its arithmetic is emulated below in
# plain torch and held to paged_attention_ref.

def chunk_plan(positions, kw, nb, bs, cb):
    """Each slot's chunks as the kernel cuts them (``paged_decode_kernel``:
    chunk ``c`` covers rows ``[c * cb * bs, ...)`` of the rows any of the
    slot's ``kw`` query rows can see, ``[0, min(position + kw, nb *
    bs))``; a CTA whose chunk starts past them exits, but chunk 0 always
    runs): ``[start, end)`` row ranges."""
    rows = cb * bs
    plan = []
    for p in positions:
        n = min(int(p) + kw, nb * bs)
        plan.append([(c, min(c + rows, n)) for c in range(0, max(n, 1), rows)])
    return plan


PLANS = [  # (slots, heads, table entries, block size, positions, kw)
    (8, 12, 64, 16, [0, 17, 255, 511, 700, 1023, 0, 0], 1),
    (8, 12, 64, 16, [1023] * 8, 1),
    (8, 12, 64, 16, [0, 60, 61, 63, 64, 1016, 0, 0], 8),
    (3, 2, 3, 4, [0, 5, 11], 1),
    (2, 2, 8, 4, [6, 28], 4),
    (4, 1, 40, 1, [0, 31, 32, 39], 1),
]


@pytest.mark.parametrize("s,h,nb,bs,positions,kw", PLANS)
def test_chunk_plan_covers_every_visible_row_once_in_whole_blocks(
        s, h, nb, bs, positions, kw):
    cb = port_paged.chunk_blocks(s, h, nb, bs, 132)
    assert 1 <= cb <= min(nb, port_paged.MAX_CHUNK_BLOCKS)
    assert cb == 1 or s * h * -(-nb // cb) >= 2 * 132
    plan = chunk_plan(positions, kw, nb, bs, cb)
    for pos, chunks in zip(positions, plan):
        n = min(pos + kw, nb * bs)
        rows = [r for a, b in chunks for r in range(a, b)]
        assert rows == list(range(n))  # each visible row once, in order
        for i, (a, b) in enumerate(chunks):
            assert a == i * cb * bs  # starts on a pool block
            assert b == min(a + cb * bs, n)  # whole blocks, but the last
        assert len(chunks) <= -(-nb // cb)  # within the grid
        if pos == 0 and kw == 1:
            assert len(chunks) == 1  # a free slot: one chunk


def test_chunk_blocks_fill_the_card_at_the_serving_shapes():
    """Phase b's mixed positions and a full server of 8 slots at 1,023:
    at least two waves of (chunk, head, slot) blocks on 132 SMs."""
    cb = port_paged.chunk_blocks(8, 12, 64, 16, 132)
    assert cb * 16 == port_paged._CHUNK_ROWS
    for positions in ([0, 17, 255, 511, 700, 1023, 0, 0], [1023] * 8):
        plan = chunk_plan(positions, 1, 64, 16, cb)
        assert 12 * sum(len(c) for c in plan) >= 2 * 132


def _split_merge(q, kp, vp, tables, positions, cb):
    """Test-only emulation of the kernel's split and merge: each chunk's
    softmax against its own maximum (probabilities rounded to the value
    dtype there), then out = sum_i acc_i e^(m_i - M) / max(sum_i l_i
    e^(m_i - M), 1e-30) over the chunks in order."""
    s, kw, h, hd = q.shape
    pool = kp[QKEY] if isinstance(kp, dict) else kp
    bs = pool.shape[1]
    ll = tables.shape[1] * bs
    pos = positions.long()
    col = torch.arange(ll)
    valid = col[None, None, :] <= (pos[:, None] + torch.arange(kw))[:, :, None]
    view_vis = valid[:, -1]
    k = port_paged.paged_view(kp, tables, q.dtype, visible=view_vis)
    v = port_paged.paged_view(vp, tables, q.dtype, visible=view_vis)
    sc = torch.einsum("skhd,slhd->shkl", q.float(), k.float()) / math.sqrt(hd)
    rows = cb * bs
    parts = []
    for c0 in range(0, ll, rows):
        vis = (valid & (col >= c0) & (col < c0 + rows))[:, None]  # (S,1,kw,L)
        m = torch.where(vis, sc, NEG).amax(-1, keepdim=True)
        p = torch.where(vis, torch.exp(sc - m), 0.0)
        acc = torch.einsum("shkl,slhd->shkd", p.to(v.dtype).float(), v.float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    num = den = 0.0
    for m, l, acc in parts:  # chunk order
        w = torch.exp(m - big_m)
        num = num + acc * w
        den = den + l * w
    out = num / torch.clamp_min(den, 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


SPLITS = [  # (block size, head_dim, dtype, kw, int8, positions)
    (4, 8, "float32", 1, False, [0, 7, 8, 11]),        # ends on a boundary, one past
    (4, 8, "float32", 4, False, [6, 0, 9, 13]),        # chunks masked for low rows
    (4, 4, "bfloat16", 3, False, [5, 1, 13, 10]),
    (8, 8, "bfloat16", 1, False, [15, 16, 0, 31]),
    (4, 8, "float32", 4, True, [6, 4, 12, 0]),
    (4, 8, "bfloat16", 1, True, [3, 4, 0, 15]),
]


@pytest.mark.parametrize("bs,hd,dtype,kw,int8,positions", SPLITS)
def test_split_and_merge_matches_the_plain_version(bs, hd, dtype, kw, int8,
                                                   positions):
    q, kp, vp, tables, _ = _case(seed=bs * 7 + hd + kw, s=4, nb=4, bs=bs,
                                 h=2, hd=hd, kw=kw, int8=int8)
    pos = np.array(positions, np.int32)
    tdt = getattr(torch, dtype)
    pool = (lambda p: {k2: torch.from_numpy(v2) for k2, v2 in p.items()}
            if isinstance(p, dict) else torch.from_numpy(p).to(tdt))
    args = (torch.from_numpy(q).to(tdt), pool(kp), pool(vp),
            torch.from_numpy(tables), torch.from_numpy(pos))
    want = port_paged.paged_attention_ref(*args).float()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for cb in (1, 2):  # one pool block a chunk, and two
        got = _split_merge(*args, cb).float()
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_split_and_merge_is_bit_exact_on_a_one_eighth_grid():
    """f32 inputs on a 1/8 grid whose scores are exact: "hot" keys score
    +200, "cold" ones -200, so every probability is exactly 1 (a score at
    its row's maximum) or 0 (400 below it), in both versions, and every
    sum is exact. The split (each chunk's maximum, the weights e^(m_i - M)
    of 1 or 0, chunks that a query row cannot see, a query row that sees
    only cold keys) must then give the plain version's bits."""
    rng = np.random.default_rng(5)
    s, kw, h, hd, bs, nb = 4, 4, 2, 4, 4, 4
    hot = rng.random((s * nb + 1, bs, h)) < 0.3
    hot[1, 0] = False  # slot 0 at position 0 sees only a cold key
    kp = (np.where(hot, 50.0, -50.0)[..., None] * np.ones(hd)).astype(np.float32)
    vp = (rng.integers(-16, 17, kp.shape) / 8).astype(np.float32)
    q = np.full((s, kw, h, hd), 2.0, np.float32)
    tables = (1 + np.arange(s * nb).reshape(s, nb)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables)]
    for positions in ([0, 7, 8, 13], [6, 11, 12, 3]):
        pos = torch.tensor(positions, dtype=torch.int32)
        want = port_paged.paged_attention_ref(*args, pos)
        for cb in (1, 2, 4):
            got = _split_merge(*args, pos, cb)
            assert torch.equal(got, want), (positions, cb)


def test_kernel_wrapper_packs_its_arguments_and_reads_limits_once(monkeypatch,
                                                                 tmp_path):
    """K1's launch path on the CPU with a stand-in library: the limits and
    the launcher are looked up once a process, every call packs one struct
    (pointers, stream, shapes, the chunk length) and counts one launch."""
    from distributed_tpu_torch.ops import _build

    calls = []

    class Lib:
        def dtt_paged_attention(self, buf):
            calls.append(buf)
            return 0

        def dtt_paged_attention_args_bytes(self):
            return port_paged._ARGS.size

        def dtt_paged_attention_kw_group(self):
            calls.append("kw_group")
            return 8

        def dtt_paged_attention_max_hd(self):
            calls.append("max_hd")
            return 256

    lib = _build.Library("paged_attention", port_paged._LIB.signatures)
    lib._handle = Lib()
    monkeypatch.setattr(port_paged, "_LIB", lib)
    monkeypatch.setattr(port_paged, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "raw_stream", lambda index: 0xABC)
    monkeypatch.setattr(port_paged, "_WORKSPACE", {})
    q, kp, vp, tables, pos = (torch.from_numpy(a) for a in _case(
        seed=1, s=3, nb=3, bs=4, h=2, hd=8, kw=2))
    port_paged.reset_launch_counts()
    outs = [port_paged._paged_attention_cuda(q, kp, vp, tables, pos)
            for _ in range(3)]
    assert calls.count("kw_group") == 1 and calls.count("max_hd") == 1
    bufs = [c for c in calls if isinstance(c, bytes)]
    assert len(bufs) == 3 and port_paged.launches["paged_attention"] == 3
    f = port_paged._ARGS.unpack(bufs[-1])
    counters, partials = port_paged._WORKSPACE[(None, 0xABC)]
    cb = port_paged.chunk_blocks(3, 2, 3, 4, 132)
    assert f == (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), 0, 0,
                 tables.data_ptr(), pos.data_ptr(), outs[-1].data_ptr(),
                 partials.data_ptr(), counters.data_ptr(), 0xABC, 0, 0, 1,
                 3, 2, 2, 8, 4, 3, cb)
    assert partials.numel() >= 3 * 2 * -(-3 // cb) * 2 * (2 + 8)
    assert torch.equal(counters, torch.zeros(6, dtype=torch.int32))
    # Any kw is one launch: kw 12 runs two row groups of 8, each with its
    # own arrival counters and partials.
    wide = port_paged._paged_attention_cuda(torch.zeros(3, 12, 2, 8), kp, vp,
                                            tables, pos)
    assert port_paged.launches["paged_attention"] == 4
    assert port_paged.launches_by_kw == {("paged_attention", 2): 3,
                                         ("paged_attention", 12): 1}
    assert port_paged._ARGS.unpack(calls[-1])[15] == 12
    counters, partials = port_paged._WORKSPACE[(None, 0xABC)]
    assert counters.numel() >= 3 * 2 * 2
    assert partials.numel() >= 3 * 2 * 2 * -(-3 // cb) * 8 * (2 + 8)
    assert wide.shape == (3, 12, 2, 8)
    assert calls.count("kw_group") == 1
    with pytest.raises(ValueError, match="above the kernel's limit"):
        port_paged._paged_attention_cuda(torch.zeros(3, 2, 2, 257), kp, vp,
                                         tables, pos)


# Speculative verification reads kw = spec_k query rows a slot, any width:
# the plain version against the JAX kernel at kw 8, 10 and 12 (past the 8
# rows one block of the CUDA kernel holds), plain and int8 pools.
WIDE = [
    # (block_size, head_dim, dtype, kw, int8)
    (4, 8, "float32", 8, False),
    (4, 8, "float32", 10, False),
    (8, 4, "float32", 12, False),
    (4, 8, "bfloat16", 12, False),
    (4, 8, "float32", 12, True),
    (8, 8, "bfloat16", 10, True),
]


@pytest.mark.parametrize(
    "bs,hd,dtype,kw,int8", WIDE,
    ids=[f"bs{b}-hd{d}-{t}-kw{k}{'-int8' if q else ''}"
         for b, d, t, k, q in WIDE])
def test_ref_matches_jax_kernel_at_wide_kw(bs, hd, dtype, kw, int8):
    case = _case(seed=bs * 100 + hd * 10 + kw, s=3, nb=5, bs=bs, h=2, hd=hd,
                 kw=kw, int8=int8)
    want = _jax(*case, getattr(jnp, dtype))
    got = _port(*case, getattr(torch, dtype))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_row_groups_of_wide_kw_are_calls_at_shifted_positions(dtype, int8):
    """Row r of a slot masks itself to positions <= positions + r, so rows
    8..11 of a kw 12 call are a kw 4 call at positions + 8 (the CUDA
    kernel's row groups): bit for bit, in the plain version too."""
    q, kp, vp, tables, pos = _case(seed=12, s=3, nb=6, bs=4, h=2, hd=8,
                                   kw=12, int8=int8)
    dt = getattr(torch, dtype)
    pool = (lambda p: {k: torch.from_numpy(v) for k, v in p.items()}
            if isinstance(p, dict) else torch.from_numpy(p).to(dt))
    qt, k, v = torch.from_numpy(q).to(dt), pool(kp), pool(vp)
    tb, ps = torch.from_numpy(tables), torch.from_numpy(pos)
    whole = port_paged.paged_attention(qt, k, v, tb, ps)
    head = port_paged.paged_attention(qt[:, :8].contiguous(), k, v, tb, ps)
    tail = port_paged.paged_attention(qt[:, 8:].contiguous(), k, v, tb, ps + 8)
    assert torch.equal(whole[:, :8], head)
    assert torch.equal(whole[:, 8:], tail)
