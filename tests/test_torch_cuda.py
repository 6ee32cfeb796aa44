"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without an NVIDIA card (a CUDA kernel has
no CPU mode). The module imports neither JAX nor the JAX package, so on the
card it runs without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, per entry: 2e-5 for f32 (sums in different orders); bf16
outputs 2e-2 (probabilities round to bf16 at different running maxima),
bf16 flash gradients atol 2e-3 + rtol 2e-2; f16 the bf16 limits scaled by
the ratio of the two types' ulps (2^-10 / 2^-7) and doubled: outputs 5e-3,
gradients atol 5e-4 + rtol 5e-3; flash dQ and dK/dV the same bits on a
second run (no atomics); the cross-entropy: 1e-5 on
the f32 losses, one ulp of each entry on bf16 and f16 gradients. The fused
Adam kernel: bit for bit (both sides round every operation once, in the
same order). The 1x1-convolution GEMM (K12): f32 within 2e-5 relative of
the sum of |x||w| (sums in another order); bf16 and f16 within one ulp
of each entry plus that bound, and the same bits on a second run.
BatchNorm's reductions (K13/K14): rtol 1e-5 plus 1e-5 times the sum of the
terms' magnitudes, and the same bits on a second call (fixed order, no
atomics). The launch probe (K15): bit for bit.
Paged decode also gives the same bits on a second call (its chunks merge
in a fixed order).
"""

import pytest
import torch

from distributed_tpu_torch.ops import bn_reduce as bn_ops
from distributed_tpu_torch.ops import conv1x1 as conv_ops
from distributed_tpu_torch.ops import flash_attention as flash_ops
from distributed_tpu_torch.ops import fused_update as adam_ops
from distributed_tpu_torch.ops import launch_probe as probe_ops
from distributed_tpu_torch.ops import paged_attention as paged_ops
from distributed_tpu_torch.ops import pallas_kernels as xent_ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, dtype, kw, int8, s=8, nb=8, bs=16, h=4, hd=64, seed=11):
    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn((s * nb + 1, bs, h, hd), generator=g, device=dev)
    vp = torch.randn((s * nb + 1, bs, h, hd), generator=g, device=dev)
    q = torch.randn((s, kw, h, hd), generator=g, device=dev).to(dtype)
    tables = (1 + torch.arange(s * nb, device=dev).reshape(s, nb)).int()
    tables[-1] = 0  # a free slot on the trash block
    positions = torch.randint(0, nb * bs - kw + 1, (s,), generator=g,
                              device=dev).int()
    positions[0] = 0
    positions[-1] = 0
    if int8:
        def quant(pool):
            amax = pool.abs().amax(dim=-1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, 1.0)
            qv = torch.clamp(torch.round(pool / scale), -127, 127)
            return {"q": qv.to(torch.int8), "scale": scale}
        return q, quant(kp), quant(vp), tables, positions
    return q, kp.to(dtype), vp.to(dtype), tables, positions


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,kw,int8",
    [(torch.float32, 1, False), (torch.bfloat16, 1, False),
     (torch.bfloat16, 4, False), (torch.bfloat16, 1, True),
     (torch.float32, 4, True)])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, kw, int8):
    args = _inputs(cuda_device, dtype, kw, int8)
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = paged_ops.launches[key]
    got = paged_ops.paged_attention(*args)
    want = paged_ops.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert paged_ops.launches[key] == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# Every head width up to 256 and f16: rows of whole 16-byte chunks go
# through the register prefetch (hd 24 and 256 in 16 bits, 8 in f32),
# others element by element (hd 8 and 24 in int8, 100 in bf16); 256 runs
# the 256-thread class.
PAGED_WIDTHS = [(dtype, kw, int8, hd) for hd in (8, 24, 256)
                for dtype, kw, int8 in ((torch.float32, 1, False),
                                        (torch.bfloat16, 4, False),
                                        (torch.float16, 1, False),
                                        (torch.bfloat16, 1, True),
                                        (torch.float16, 4, True))]
PAGED_WIDTHS.append((torch.bfloat16, 3, False, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw,int8,hd", PAGED_WIDTHS)
def test_paged_attention_kernel_matches_plain_at_every_width(cuda_device, dtype,
                                                             kw, int8, hd):
    args = _inputs(cuda_device, dtype, kw, int8, hd=hd, seed=hd)
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = paged_ops.launches[key]
    got = paged_ops.paged_attention(*args)
    want = paged_ops.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert paged_ops.launches[key] == before + 1
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# The split over the sequence (K1/K2): slots ending exactly at the end of
# a chunk and one row past it, every slot at the last position of a
# 1,024-row table, kw 1, 4 and 8, hd 8, 24, 64 and 256, every pool type.
def _chunk_rows(s, h, nb, bs):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return paged_ops.chunk_blocks(s, h, nb, bs, sms) * bs


SPLIT_CASES = [(dtype, int8, kw, hd)
               for dtype, int8 in ((torch.float32, False),
                                   (torch.bfloat16, False),
                                   (torch.float16, False),
                                   (torch.bfloat16, True))
               for kw in (1, 4, 8) for hd in (8, 24, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,kw,hd", SPLIT_CASES)
def test_paged_attention_split_matches_plain_at_chunk_boundaries(
        cuda_device, dtype, int8, kw, hd):
    s, nb, bs, h = 8, 64, 16, 4
    args = list(_inputs(cuda_device, dtype, kw, int8, s=s, nb=nb, bs=bs,
                        h=h, hd=hd, seed=kw * 1000 + hd))
    rows = _chunk_rows(s, h, nb, bs)
    # Visible lengths pos + kw: a chunk's end, one past it, two chunks'
    # end, one row, the whole table (twice), a trash slot, mid-chunk.
    lengths = [rows, rows + 1, 2 * rows, kw, nb * bs, nb * bs, kw, rows // 2 + kw]
    args[4] = torch.tensor([n - kw for n in lengths], dtype=torch.int32,
                           device=cuda_device)
    key = "paged_attention_int8" if int8 else "paged_attention"
    before = paged_ops.launches[key]
    got = paged_ops.paged_attention(*args)
    again = paged_ops.paged_attention(*args)
    want = paged_ops.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert paged_ops.launches[key] == before + 2  # one launch per call
    assert torch.equal(got, again)  # chunks merge in a fixed order
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False),
                                        (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_paged_attention_every_slot_at_position_1023(cuda_device, dtype, int8):
    args = list(_inputs(cuda_device, dtype, 1, int8, s=8, nb=64, bs=16, h=12,
                        hd=64, seed=3))
    args[3] = (1 + torch.arange(8 * 64, device=cuda_device).reshape(8, 64)).int()
    args[4] = torch.full((8,), 1023, dtype=torch.int32, device=cuda_device)
    got = paged_ops.paged_attention(*args)
    want = paged_ops.paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# Any kw in one launch (row groups of 8 query rows): kw 9, 12 and 17 at
# chunk-boundary lengths on a side stream, one launch counted, against the
# plain version; and each row group of two or more rows bit for bit as a
# call of its own rows at positions shifted by the group's first row (a
# one-row call runs the kw = 1 instantiation, whose code may round apart).
KW_WIDE = [(dtype, int8, kw)
           for dtype, int8 in ((torch.float32, False), (torch.bfloat16, False),
                               (torch.float16, False), (torch.bfloat16, True),
                               (torch.float32, True))
           for kw in (9, 12, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,kw", KW_WIDE)
def test_paged_attention_any_kw_in_one_launch(cuda_device, dtype, int8, kw):
    s, nb, bs, h = 8, 64, 16, 4
    args = list(_inputs(cuda_device, dtype, kw, int8, s=s, nb=nb, bs=bs, h=h,
                        seed=kw))
    rows = _chunk_rows(s, h, nb, bs)
    lengths = [rows, rows + 1, 2 * rows, kw, nb * bs, nb * bs, kw,
               rows // 2 + kw]
    args[4] = torch.tensor([n - kw for n in lengths], dtype=torch.int32,
                           device=cuda_device)
    key = "paged_attention_int8" if int8 else "paged_attention"
    torch.cuda.synchronize()
    before = paged_ops.launches[key]
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        got = paged_ops.paged_attention(*args)
    assert paged_ops.launches[key] == before + 1
    torch.cuda.synchronize()
    want = paged_ops.paged_attention_ref(*args)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for r0 in range(0, kw, 8):
        if kw - r0 < 2:
            continue
        part = list(args)
        part[0] = args[0][:, r0:r0 + 8].contiguous()
        part[4] = args[4] + r0
        assert torch.equal(got[:, r0:r0 + 8], paged_ops.paged_attention(*part))


@pytest.mark.cuda
def test_kernels_launch_on_the_callers_stream(cuda_device):
    """Inside ``torch.cuda.stream(s)`` the binding reads ``s``'s handle,
    and the kernels run on ``s``: they see what ``s`` wrote just before
    them, after a ~50 ms spin on ``s`` that the default stream does not
    wait for."""
    from distributed_tpu_torch.ops import _build

    args = list(_inputs(cuda_device, torch.bfloat16, 1, False, hd=64, seed=4))
    q_new = torch.randn_like(args[0])
    x = torch.zeros(probe_ops.SHAPE, device=cuda_device)
    x_new = torch.randn_like(x)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        assert _build.stream(cuda_device) == side.cuda_stream != 0
        torch.cuda._sleep(100_000_000)
        args[0].copy_(q_new)
        x.copy_(x_new)
        got = paged_ops.paged_attention(*args)
        probe = probe_ops.launch_probe(x)
    assert _build.stream(cuda_device) == torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    args[0] = q_new
    torch.testing.assert_close(got.float(),
                               paged_ops.paged_attention_ref(*args).float(),
                               atol=2e-2, rtol=2e-2)
    assert torch.equal(probe, probe_ops.launch_probe_ref(x_new))


# ----------------------------------------------- fused softmax cross-entropy
def _ulp(want, dtype):
    """One ulp of each entry of ``want`` in ``dtype`` (bf16: 2^-7 of its
    binade; f16: 2^-10, and 2^-24 below the normal range)."""
    bits = 7 if dtype == torch.bfloat16 else 10
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - bits)
    return ulp.clamp_min(2.0 ** -24) if dtype == torch.float16 else ulp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,c", [(37, 300), (64, 4096)])
def test_xent_kernels_match_plain(cuda_device, dtype, n, c):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    logits = (3 * torch.randn((n, c), generator=g, device=cuda_device)).to(dtype)
    labels = torch.randint(0, c, (n,), generator=g, device=cuda_device)
    labels[0] = c  # out of range: picks 0, one-hot of nothing
    gout = torch.rand((n,), generator=g, device=cuda_device)
    before = dict(xent_ops.launches)
    loss = xent_ops.xent_fwd(logits, labels)
    dl = xent_ops.xent_bwd(logits, labels, gout)
    torch.cuda.synchronize()
    assert xent_ops.launches["xent_fwd"] == before["xent_fwd"] + 1
    assert xent_ops.launches["xent_bwd"] == before["xent_bwd"] + 1
    torch.testing.assert_close(loss, xent_ops.xent_fwd_ref(logits, labels),
                               atol=1e-5, rtol=1e-5)
    want = xent_ops.xent_bwd_ref(logits, labels, gout).float()
    assert dl.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(dl, want, atol=1e-6, rtol=0)
    else:  # every entry within one ulp of its own value
        assert bool(((dl.float() - want).abs() <= _ulp(want, dtype)).all())


# ---------------------------------------------------------- flash attention
# bf16 takes the wgmma kernels (forward, dQ and dK/dV), whose tiles are 64
# or 128 columns wide: D of 32 and 48 are zero-padded to 64, 128 fills its
# tile. T of 77, 130 and
# 1000 leave ragged tiles (64 q and kv rows in the forward, 64 keys and 32
# queries in dK/dV); 1024 none. Those cases take inputs on a grid of 1/8
# (normals rounded, within +-4): every score and every dO . v is then exact
# in f32 whatever the order of its sum, so the kernels and the plain
# versions round the same probabilities and dS to bf16, and the comparison
# sees the kernels' own layouts and the order of their f32 products. With
# unrounded normals one dS entry in a few thousand lies within a few f32
# ulps of a bf16 rounding midpoint, and the two sides may round it apart:
# at (2, 77, 2, 32) causal, seed 5, one such entry moves one dK entry by
# 0.0045 on its value of 0.10, past atol 2e-3 + rtol 2e-2.
FLASH_CASES = (
    [(dtype, shape, False) for dtype in (torch.float32, torch.bfloat16)
     for shape in ((2, 64, 4, 32), (1, 100, 3, 32), (2, 200, 2, 64))]
    + [(torch.bfloat16, (2, t, 2, d), True) for d in (32, 48, 64, 128)
       for t in (77, 130, 1000, 1024)])


def _flash_inputs(dev, dtype, shape, seed=5, grid=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(4):
        x = torch.randn(shape, generator=g, device=dev)
        if grid:
            x = torch.round(x * 8).clamp(-32, 32) / 8
        out.append(x.to(dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,shape,grid", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, dtype, causal, shape, grid):
    q, k, v, do = _flash_inputs(cuda_device, dtype, shape, grid=grid)
    before = dict(flash_ops.launches)
    o, m, l = flash_ops.flash_fwd(q, k, v, causal)
    delta = flash_ops.flash_delta(do, o)
    dq, dk, dv = flash_ops.flash_bwd(q, k, v, do, m, l, delta, causal)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert flash_ops.launches[name] == before[name] + 1
    o_ref, m_ref, l_ref = flash_ops.flash_fwd_ref(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=tol, rtol=tol)
    want = flash_ops.flash_bwd_ref(q, k, v, do, m, l, delta, causal)
    # Every gradient entry within atol + rtol * |its reference|.
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (2e-3, 2e-2)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)


# Every head width and f16: D of 8, 24 and 40 pad to the 64-column tile,
# 256 fills the widest tile, whose blocks each write one 128-column half;
# D of 7 and 100 are first padded in a copy to whole 16-byte rows. f32 at
# D 112 and 128: dK/dV takes 32-row tiles there (64 would not fit in
# shared memory), the forward and dQ 64. 16-bit inputs on the 1/8 grid,
# as above.
FLASH_WIDTHS = (
    [(dtype, (2, 130, 2, d)) for dtype in (torch.bfloat16, torch.float16,
                                           torch.float32)
     for d in (8, 24, 40, 256)]
    + [(torch.float16, (2, 1000, 2, 64)), (torch.float16, (1, 77, 2, 128)),
       (torch.bfloat16, (1, 77, 2, 7)), (torch.float32, (1, 77, 2, 7)),
       (torch.bfloat16, (1, 200, 3, 100)), (torch.bfloat16, (1, 1000, 1, 256)),
       (torch.float32, (1, 77, 2, 112)), (torch.float32, (1, 130, 2, 128))])
FLASH_TOLS = {torch.float32: ((2e-5, 2e-5), (2e-5, 2e-5)),
              torch.bfloat16: ((2e-2, 2e-2), (2e-3, 2e-2)),
              torch.float16: ((5e-3, 5e-3), (5e-4, 5e-3))}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,shape", FLASH_WIDTHS)
def test_flash_kernels_match_plain_at_every_width(cuda_device, dtype, causal,
                                                  shape):
    q, k, v, do = _flash_inputs(cuda_device, dtype, shape, seed=shape[-1],
                                grid=dtype != torch.float32)
    before = dict(flash_ops.route_launches)
    o, m, l = flash_ops.flash_fwd(q, k, v, causal)
    delta = flash_ops.flash_delta(do, o)
    dq, dk, dv = flash_ops.flash_bwd(q, k, v, do, m, l, delta, causal)
    torch.cuda.synchronize()
    route = "cuda_core" if dtype == torch.float32 else "wgmma"
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert flash_ops.route_launches[f"{name}/{route}"] == \
            before[f"{name}/{route}"] + 1
    assert o.shape == dq.shape == dk.shape == dv.shape == q.shape
    (vat, vrt), (gat, grt) = FLASH_TOLS[dtype]
    o_ref, m_ref, l_ref = flash_ops.flash_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=vat, rtol=vrt)
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=max(vat, 2e-5), rtol=max(vrt, 2e-5))
    want = flash_ops.flash_bwd_ref(q, k, v, do, m, l, delta, causal)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=gat, rtol=grt)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_identity_v_gives_the_probabilities(cuda_device, causal):
    """With T = D = 64 and V the identity, O = P / l: each output entry is
    one probability, so a misplaced score in the register A operand of
    O += P V (the packing of the S fragment) shows as a wrong entry."""
    q, k, _, _ = _flash_inputs(cuda_device, torch.bfloat16, (1, 64, 1, 64), 9)
    v = torch.eye(64, device=cuda_device, dtype=torch.bfloat16)[None, :, None]
    o, _, l = flash_ops.flash_fwd(q, k, v, causal)
    o_ref, _, l_ref = flash_ops.flash_fwd_ref(q, k, v, causal)
    s = (q[0, :, 0].float() @ k[0, :, 0].float().T) * flash_ops._scale(64)
    if causal:
        s = s.masked_fill(~torch.ones_like(s, dtype=torch.bool).tril(), -1e30)
    probs = torch.softmax(s, dim=-1)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l, l_ref, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o[0, :, 0].float(), probs, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float16, "wgmma"),
                                         (torch.float32, "cuda_core")])
def test_flash_dtype_takes_its_route_once(cuda_device, dtype, route):
    q, k, v, do = _flash_inputs(cuda_device, dtype, (1, 130, 2, 64))
    before = dict(flash_ops.route_launches)
    o, m, l = flash_ops.flash_fwd(q, k, v, True)
    flash_ops.flash_bwd(q, k, v, do, m, l, flash_ops.flash_delta(do, o), True)
    torch.cuda.synchronize()
    grown = {name: n - before[name]
             for name, n in flash_ops.route_launches.items()}
    assert grown == {name: int(name.endswith("/" + route)) for name in grown}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1000, 3, 64), (1, 130, 2, 128)])
def test_flash_dkv_is_bit_identical_from_run_to_run(cuda_device, shape):
    """dK/dV has no atomics: each block owns its key rows and sums its q
    tiles in one order, so two runs give the same bits."""
    q, k, v, do = _flash_inputs(cuda_device, torch.bfloat16, shape)
    o, m, l = flash_ops.flash_fwd(q, k, v, True)
    delta = flash_ops.flash_delta(do, o)
    first = flash_ops._flash_dkv_cuda(q, k, v, do, m, l, delta, True)
    second = flash_ops._flash_dkv_cuda(q, k, v, do, m, l, delta, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (2, 1000, 3, 64)),
                                         (torch.bfloat16, (1, 130, 2, 128)),
                                         (torch.float16, (1, 130, 2, 256))])
def test_flash_dq_is_bit_identical_from_run_to_run(cuda_device, dtype, shape):
    """dQ has no atomics: each block owns its query rows and sums its kv
    tiles in one order in registers, so two runs give the same bits."""
    q, k, v, do = _flash_inputs(cuda_device, dtype, shape)
    o, m, l = flash_ops.flash_fwd(q, k, v, True)
    delta = flash_ops.flash_delta(do, o)
    first = flash_ops._flash_dq_cuda(q, k, v, do, m, l, delta, True)
    second = flash_ops._flash_dq_cuda(q, k, v, do, m, l, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
def test_flash_attention_autograd_matches_dense(cuda_device):
    """flash_attention's gradients through autograd against the dense
    path's, in f32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(7)
    shape = (2, 130, 3, 64)
    base = [torch.randn(shape, generator=g, device=cuda_device)
            for _ in range(3)]
    w = torch.randn(shape, generator=g, device=cuda_device)

    def grads(fn):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        (fn(q, k, v) * w).sum().backward()
        return q.grad, k.grad, v.grad

    got = grads(lambda q, k, v: flash_ops.flash_attention(q, k, v, causal=True))
    want = grads(lambda q, k, v: flash_ops.dense_attention(q, k, v, True))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=1e-4)


# ------------------------------------------------------------- fused Adam
def _adam_leaves(dev, sizes, offset, seed):
    """(params, grads, mus, nus): one view per size into one flat buffer
    per role, starting ``offset`` elements in, so odd sizes and offsets
    give leaves that are not 16-byte aligned."""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = offset + sum(sizes)

    def views(buf):
        out, at = [], offset
        for n in sizes:
            out.append(buf[at:at + n])
            at += n
        return out

    return (views(torch.randn(total, generator=g, device=dev)),
            views(torch.randn(total, generator=g, device=dev) * 1e-2),
            views(torch.randn(total, generator=g, device=dev) * 1e-3),
            views(torch.rand(total, generator=g, device=dev) * 1e-5))


def _bits(ts):
    return [t.view(torch.int32) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("sizes,offset", [
    ([1, 3, 1001, 8192, 8193, 70001], 0),  # odd lengths, aligned starts
    ([4096, 37, 12, 5000], 1),  # starts off the 16-byte grid
    ([97] * 150, 3),  # more leaves than one launch takes
])
def test_fused_adam_kernel_matches_plain_bit_for_bit(cuda_device, wd, sizes,
                                                     offset):
    p, g, m, v = _adam_leaves(cuda_device, sizes, offset, seed=len(sizes))
    p2, m2, v2 = ([t.clone() for t in ts] for ts in (p, m, v))
    before = adam_ops.launches["fused_adam"]
    for count in (1, 2, 3):
        s = adam_ops.AdamScalars(
            neg_lr=-1e-3, b1=0.9, b2=0.999, c1=1 - 0.9, c2=1 - 0.999,
            eps=1e-8, wd=wd, bc1=1 - 0.9 ** count, bc2=1 - 0.999 ** count)
        s = adam_ops.AdamScalars(*(float(torch.tensor(x)) for x in s))
        adam_ops.adam_update(p, g, m, v, s)
        adam_ops.adam_update_ref(p2, g, m2, v2, s)
    torch.cuda.synchronize()
    per_update = -(-len(sizes) // adam_ops.MAX_LEAVES)
    assert adam_ops.launches["fused_adam"] == before + 3 * per_update
    for got, want in ((p, p2), (m, m2), (v, v2)):
        for a, b in zip(_bits(got), _bits(want)):
            assert torch.equal(a, b)


# ------------------------------------------------- 1x1 convolution GEMM (K12)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n", [(3136, 64, 256), (1000, 256, 64),
                                   (77, 24, 40), (130, 2048, 512)])
def test_conv1x1_kernel_matches_plain(cuda_device, dtype, m, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda_device) * 0.1).to(dtype)
    before = conv_ops.launches["conv1x1"]
    got = conv_ops.conv1x1(x, w)
    torch.cuda.synchronize()
    assert conv_ops.launches["conv1x1"] == before + 1
    want = conv_ops.conv1x1_ref(x, w).float()
    bound = x.float().abs() @ w.float().abs()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert bool((diff <= 2e-5 * bound + 1e-30).all())
    else:
        limit = _ulp(want, dtype) + 2 * k * 2.0 ** -24 * bound + 1e-30
        assert bool((diff <= limit).all())


def _close_to_plain_bf16(got, x, w):
    """Each entry within one ulp (of x's 16-bit type) of the plain
    version's plus the f32 sums' rounding bound 2 K 2^-24 sum|x||w| (phase
    m's limit)."""
    want = conv_ops.conv1x1_ref(x, w).float()
    bound = x.float().abs() @ w.float().abs()
    limit = (_ulp(want, x.dtype) + 2 * x.shape[1] * 2.0 ** -24 * bound
             + 1e-30)
    return bool(((got.float() - want).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset", [
    (3136, 64, 256, 0), (12544, 2048, 512, 0), (1000, 256, 64, 0),
    (1000, 200, 72, 0), (500, 64, 36, 0), (500, 36, 64, 0), (500, 64, 64, 1)])
def test_conv1x1_routes_match_plain_and_repeat_bit_for_bit(cuda_device, m, k,
                                                            n, offset):
    """The wgmma kernel at ResNet-50 shapes, a ragged M (1000 rows: the last
    128-row tile part empty), ragged K and N tails (200 = 3 x 64 + 8, 72);
    N = 36 and K = 36 (rows not whole 16-byte chunks) and an X that starts
    2 bytes past a 16-byte boundary, each through the wrapper's zero-padded
    copy."""
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    x = torch.randn((m * k + offset,), generator=g, device=cuda_device).to(
        torch.bfloat16)[offset:].view(m, k)
    w = (torch.randn((k, n), generator=g, device=cuda_device) / k ** 0.5).to(
        torch.bfloat16)
    before = dict(conv_ops.route_launches)
    first = conv_ops.conv1x1(x, w)
    second = conv_ops.conv1x1(x, w)
    torch.cuda.synchronize()
    grown = {r: c - before[r] for r, c in conv_ops.route_launches.items()}
    assert grown == {r: 2 * (r == "conv1x1/wgmma") for r in grown}
    assert _close_to_plain_bf16(first, x, w)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(3136, 64, 256), (3136, 64, 36),
                                   (1000, 36, 64)])
def test_conv1x1_f16_takes_the_wgmma_route_and_repeats(cuda_device, m, k, n):
    """f16 at a ResNet-50 shape and with N or K not a multiple of 8 (the
    wrapper's zero-padded copy), through the same wgmma kernel as bf16."""
    g = torch.Generator(device=cuda_device).manual_seed(k * n)
    x = torch.randn((m, k), generator=g, device=cuda_device).half()
    w = (torch.randn((k, n), generator=g, device=cuda_device) / k ** 0.5).half()
    before = dict(conv_ops.route_launches)
    first = conv_ops.conv1x1(x, w)
    second = conv_ops.conv1x1(x, w)
    torch.cuda.synchronize()
    grown = {r: c - before[r] for r, c in conv_ops.route_launches.items()}
    assert grown == {r: 2 * (r == "conv1x1/wgmma") for r in grown}
    assert first.dtype == torch.float16 and first.shape == (m, n)
    assert _close_to_plain_bf16(first, x, w)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
def test_conv1x1_autograd_matches_plain(cuda_device):
    """dX through K12 and dW through torch.matmul against the plain
    product's autograd, f32, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((500, 64), generator=g, device=cuda_device)
    w = torch.randn((64, 96), generator=g, device=cuda_device)
    dy = torch.randn((500, 96), generator=g, device=cuda_device)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = torch.autograd.grad(conv_ops.conv1x1_apply(xs, ws), (xs, ws), dy)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = torch.autograd.grad(xs @ ws, (xs, ws), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


# ---------------------------------------------- BatchNorm reductions (K13/14)
def _close_sums(got, want, terms):
    atol = 1e-5 * terms.abs().sum(0)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + atol + 1e-30).all())


def _bn_inputs(dev, m, c, dtype, seed, offset=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((m * c + offset,), generator=g, device=dev) * 2 + 1).to(
        dtype)[offset:].view(m, c)
    dy = torch.randn((m, c), generator=g, device=dev).to(dtype)
    shift = torch.randn((c,), generator=g, device=dev) * 0.5
    mean = torch.randn((c,), generator=g, device=dev) * 0.5
    inv = torch.rand((c,), generator=g, device=dev) + 0.5
    return x, dy, shift, mean, inv


def _check_bn(stats, bwd, x, dy, shift, mean, inv):
    xc = x.float() - shift
    want = bn_ops.bn_stats_ref(x, shift)
    _close_sums(stats[0], want[0], xc)
    _close_sums(stats[1], want[1], xc * xc)
    want = bn_ops.bn_bwd_reduce_ref(dy, x, mean, inv)
    _close_sums(bwd[0], want[0], dy.float())
    _close_sums(bwd[1], want[1], dy.float() * (x.float() - mean) * inv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,c", [(50176, 64), (4099, 96), (777, 2048),
                                 (1000, 3)])
def test_bn_reduce_kernels_match_plain(cuda_device, dtype, m, c):
    x, dy, shift, mean, inv = _bn_inputs(cuda_device, m, c, dtype, seed=c)
    before = dict(bn_ops.launches)
    stats = bn_ops.bn_stats(x, shift)
    again = bn_ops.bn_stats(x, shift)
    bwd = bn_ops.bn_bwd_reduce(dy, x, mean, inv)
    torch.cuda.synchronize()
    per_call = bn_ops.LAUNCHES_PER_CALL
    assert bn_ops.launches["bn_stats"] == before["bn_stats"] + 2 * per_call
    assert (bn_ops.launches["bn_bwd_reduce"]
            == before["bn_bwd_reduce"] + per_call)
    assert torch.equal(stats, again)
    _check_bn(stats, bwd, x, dy, shift, mean, inv)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,dtype,offset", [
    (100003, 3, torch.bfloat16, 0),      # ragged M (prime), C = 3
    (4099, 64, torch.bfloat16, 1),       # x off a 16-byte boundary
    (12547, 96, torch.float16, 0),       # f16, ragged M
    (50176, 256, torch.float16, 0),      # f16 at a ResNet-50 shape
    (3211264, 64, torch.bfloat16, 0),    # ResNet-50's largest BatchNorm
])
def test_bn_reduce_one_launch_same_bits_every_route(cuda_device, m, c, dtype,
                                                    offset):
    """One launch a call, the same bits on a second call, and the plain
    versions' sums, on the per-element route (C = 3, an input one element
    past a 16-byte boundary: chosen before the launch, not an error) and on
    the 16-byte route."""
    x, dy, shift, mean, inv = _bn_inputs(cuda_device, m, c, dtype, seed=m,
                                         offset=offset)
    before = dict(bn_ops.launches)
    stats = [bn_ops.bn_stats(x, shift) for _ in range(2)]
    bwd = [bn_ops.bn_bwd_reduce(dy, x, mean, inv) for _ in range(2)]
    torch.cuda.synchronize()
    assert bn_ops.launches["bn_stats"] == before["bn_stats"] + 2
    assert bn_ops.launches["bn_bwd_reduce"] == before["bn_bwd_reduce"] + 2
    assert torch.equal(stats[0], stats[1]) and torch.equal(bwd[0], bwd[1])
    _check_bn(stats[0], bwd[0], x, dy, shift, mean, inv)


@pytest.mark.cuda
def test_bn_reduce_launches_on_the_callers_stream(cuda_device):
    """Inside ``torch.cuda.stream(s)`` K13 and K14 run on ``s``: they see
    what ``s`` wrote just before them, after a ~50 ms spin the default
    stream does not wait for."""
    x, dy, shift, mean, inv = _bn_inputs(cuda_device, 50176, 256,
                                         torch.bfloat16, seed=8)
    x_new, dy_new = torch.randn_like(x), torch.randn_like(dy)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        x.copy_(x_new)
        dy.copy_(dy_new)
        stats = bn_ops.bn_stats(x, shift)
        bwd = bn_ops.bn_bwd_reduce(dy, x, mean, inv)
    torch.cuda.synchronize()
    _check_bn(stats, bwd, x_new, dy_new, shift, mean, inv)


@pytest.mark.cuda
def test_bn_reduce_streams_in_turn_never_share_counters(cuda_device):
    """Calls on two streams in turn, with no wait between them: each
    stream has its own counters and partials, every result is its plain
    version's, and the counters are back at zero."""
    shapes = [(200704, 128), (12544, 512), (802816, 64)]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    cases = [_bn_inputs(cuda_device, m, c, torch.bfloat16, seed=i)
             for i, (m, c) in enumerate(shapes)]
    torch.cuda.synchronize()
    results = []
    for r in range(3):
        for j, st in enumerate(streams):
            case = cases[(r + j) % len(cases)]
            with torch.cuda.stream(st):
                x, dy, shift, mean, inv = case
                results.append((case, bn_ops.bn_stats(x, shift),
                                bn_ops.bn_bwd_reduce(dy, x, mean, inv)))
    torch.cuda.synchronize()
    for case, stats, bwd in results:
        _check_bn(stats, bwd, *case)
    keys = [(cuda_device.index or 0, st.cuda_stream) for st in streams]
    ws = [bn_ops._WORKSPACE[k] for k in keys]
    assert ws[0][0].data_ptr() != ws[1][0].data_ptr()
    assert ws[0][1].data_ptr() != ws[1][1].data_ptr()
    for counters, _ in ws:
        assert not counters.any()


# ------------------------------------------------------ launch probe (K15)
@pytest.mark.cuda
def test_launch_probe_matches_plain_bit_for_bit(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(probe_ops.SHAPE, generator=g, device=cuda_device)
    before = probe_ops.launches["launch_probe"]
    got = probe_ops.launch_probe(x)
    torch.cuda.synchronize()
    assert probe_ops.launches["launch_probe"] == before + 1
    assert torch.equal(got.view(torch.int32),
                       probe_ops.launch_probe_ref(x).view(torch.int32))


# ------------------------------------------- speculative serving (K1/K2)
@pytest.mark.cuda
@pytest.mark.parametrize("draft,spec_k,int8", [("self", 4, False),
                                               ("cold", 4, False),
                                               ("self", 12, False),
                                               ("cold", 12, False),
                                               ("self", 4, True)])
def test_spec_engine_token_exact_on_the_card(cuda_device, draft, spec_k,
                                             int8):
    """f32 with TF32 off: the speculating engine's tokens equal the plain
    engine's (both "fused"), the verify reads through the kernel (kw
    spec_k, past one row group at 12), and no read falls back."""
    import numpy as np

    import distributed_tpu_torch as dtt

    torch.backends.cuda.matmul.allow_tf32 = False

    def lm(layers, seed):
        return dtt.Model(dtt.models.transformer_lm(
            512, num_layers=layers, d_model=64, num_heads=4, max_len=128),
            device=cuda_device).build((16,), seed=seed)

    target = lm(2, 3)
    drafter = target if draft == "self" else lm(1, 4)
    rng = np.random.default_rng(spec_k)
    reqs = [(rng.integers(0, 512, (int(p),)).astype(np.int32), int(m))
            for p, m in zip(rng.integers(4, 40, 6), rng.integers(8, 40, 6))]
    kw = dict(max_slots=4, block_size=8, max_len=128, decode_kernel="fused",
              kv_dtype="int8" if int8 else None)
    plain = dtt.serving.Engine(target, **kw).run(
        [dtt.serving.Request(p, m) for p, m in reqs])
    key = "paged_attention_int8" if int8 else "paged_attention"
    paged_ops.reset_launch_counts()
    eng = dtt.serving.Engine(target, draft_model=drafter, spec_k=spec_k, **kw)
    spec = eng.run([dtt.serving.Request(p, m) for p, m in reqs])
    tel = eng.last_run_telemetry
    for i, (a, b) in enumerate(zip(plain, spec)):
        assert np.array_equal(a, b), f"request {i}"
    rounds = tel["speculative"]["rounds"]
    target_reads = 2 * tel["decode_steps"]  # one per layer and pass
    draft_reads = (2 if draft == "self" else 1) * (spec_k - 1) * rounds
    if int8:  # the draft's pool is never int8
        assert paged_ops.launches[key] == target_reads
        assert paged_ops.launches["paged_attention"] == draft_reads
    else:
        assert paged_ops.launches[key] == target_reads + draft_reads


# ------------------------------------------------- the fit loop on the card
def _tiny_lm(dev, k=None, seed=0):
    import distributed_tpu_torch as dtt

    m = dtt.Model(dtt.models.transformer_lm(
        128, num_layers=2, d_model=64, num_heads=4, max_len=32, flash=True),
        device=dev)
    m.compile(optimizer=dtt.optim.fused_adam(1e-3),
              loss="pallas_sparse_categorical_crossentropy",
              metrics=["accuracy"], steps_per_execution=k)
    return m.build((32,), seed=seed)


def _tiny_resnet(dev, k=None):
    import distributed_tpu_torch as dtt

    m = dtt.Model(dtt.models.resnet(50, 10, small_inputs=True,
                                    stage_blocks=(1, 1, 1, 1), width=16),
                  device=dev)
    m.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9),
              loss="sparse_categorical_crossentropy", steps_per_execution=k)
    return m.build((16, 16, 3))


# Each counted kernel's name in the profiler's trace (demangled): a CUDA
# graph's replay runs the kernels without their wrappers.
_TRACE_NAMES = {
    "xent_fwd": r"\bxent_fwd_kernel\b", "xent_bwd": r"\bxent_bwd_kernel\b",
    "flash_fwd": r"\bflash_fwd_(wgmma|f32)_kernel\b",
    "flash_dq": r"\bflash_dq_(wgmma|f32)_kernel\b",
    "flash_dkv": r"\bflash_dkv_(wgmma|f32)_kernel\b",
    "fused_adam": r"\bfused_adam_kernel\b",
    "conv1x1": r"\bconv1x1_(wgmma|f32)_kernel\b",
    "bn_stats": r"\bbn_reduce_kernel<[^>]*\bfalse>",
    "bn_bwd_reduce": r"\bbn_reduce_kernel<[^>]*\btrue>",
}


def _traced_kernel_runs(run):
    """(``run()``, {kernel: its runs on the card}) from the profiler's
    trace (CUPTI, which sees a graph's kernels)."""
    import re

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, {k: sum(bool(re.search(p, n)) for n in names)
                 for k, p in _TRACE_NAMES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["lm", "resnet"])
def test_graph_replayed_steps_hold_against_eager_steps(cuda_device,
                                                        workload):
    """f32, TF32 off, cuDNN's deterministic algorithms (its default
    weight-gradient ones may add in any order, so two eager runs of the
    ResNet part too): twice 6 steps at K = 3 (each step's forward and
    backward replayed from a CUDA graph, the update eager) against K = 1
    eager from the same start: per-epoch losses rtol 1e-6, parameters and
    BatchNorm buffers atol 1e-6 after both. In the second run (no
    capture) the wrappers count only the eager update's launches, and the
    profiler's trace shows each kernel run as often as the eager run
    launched it."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _graph_against_eager(cuda_device, workload)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _graph_against_eager(cuda_device, workload):
    import numpy as np

    rng = np.random.default_rng(0)
    if workload == "lm":
        tok = rng.integers(0, 128, (12, 33))
        x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
        make, mods = _tiny_lm, (flash_ops, xent_ops, adam_ops)
    else:
        x = rng.standard_normal((12, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 10, 12).astype(np.int32)
        make, mods = _tiny_resnet, (conv_ops, bn_ops)

    def fit(m):
        for mod in mods:
            mod.reset_launch_counts()
        hist = m.fit(x, y, batch_size=4, epochs=2, steps_per_epoch=3,
                     shuffle=False, verbose=0)
        counts = {n: c for mod in mods for n, c in mod.launches.items()}
        return hist.history["loss"], counts

    me, mg = make(cuda_device), make(cuda_device, 3)
    (eager, _), (graph, _) = fit(me), fit(mg)  # mg's first dispatch captures
    np.testing.assert_allclose(graph, eager, rtol=1e-6)
    eager, ce = fit(me)
    (graph, cg), runs = _traced_kernel_runs(lambda: fit(mg))  # replays only
    np.testing.assert_allclose(graph, eager, rtol=1e-6)
    assert all(ce.values())
    assert cg == {n: c if n == "fused_adam" else 0 for n, c in ce.items()}
    assert {n: runs[n] for n in ce} == ce
    assert len(mg._graphs) == 1  # one capture serves every replay
    for a, b in ((me.params, mg.params), (me.state, mg.state)):
        for path in a:
            torch.testing.assert_close(b[path], a[path], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_pinned_staging_gives_the_bytes_of_a_synchronous_copy(cuda_device):
    """The stager's pinned, non-blocking copies on its side stream (its
    ring of pinned buffers reused many times, from another thread) equal
    a synchronous copy of the same arrays, byte for byte."""
    import threading

    import numpy as np

    from distributed_tpu_torch.data import DeviceStager

    stager = DeviceStager(cuda_device)
    rng = np.random.default_rng(1)
    arrays = [{"x": rng.standard_normal((64, 33)).astype(np.float32),
               "y": rng.integers(0, 9, (64,)).astype(np.int32)}
              for _ in range(9)]
    staged = []
    worker = threading.Thread(
        target=lambda: staged.extend(stager.stage(a) for a in arrays))
    worker.start()
    worker.join()
    for a, s in zip(arrays, staged):
        t = s.tensors
        for name, host in a.items():
            want = torch.from_numpy(host).to(cuda_device)
            assert t[name].dtype == want.dtype
            assert torch.equal(t[name], want), name


@pytest.mark.cuda
def test_generate_on_the_card_matches_its_cpu_run(cuda_device):
    """f32, TF32 off, a tiny LM: greedy and sampled (temperature 0.8,
    top_k 20) tokens on the card equal the CPU run's."""
    import numpy as np

    import distributed_tpu_torch as dtt

    torch.backends.cuda.matmul.allow_tf32 = False
    lms = [dtt.Model(dtt.models.transformer_lm(
        97, num_layers=2, d_model=32, num_heads=2, max_len=160),
        device=dev).build((16,), seed=3) for dev in ("cpu", cuda_device)]
    prompt = np.random.default_rng(2).integers(0, 97, (3, 9)).astype(
        np.int32)
    for kw in (dict(temperature=0.0), dict(temperature=0.8, top_k=20,
                                           seed=5)):
        cpu, card = (m.generate(prompt, 40, **kw) for m in lms)
        np.testing.assert_array_equal(card, cpu)


# ----------------------------------------- precision, remat, head chunks --
def _lm_run(dev, k=None, steps=2, batch=4, t_len=512, **kw):
    """A 2-layer LM (vocab 256, d 64, 2 heads, flash) fitted ``steps``
    steps on seeded tokens, launch counts zeroed before; returns the
    model, its losses and the launches. ``kw``: ``transformer_lm``'s
    ``dtype``/``remat``/``remat_policy`` and ``compile``'s
    ``precision``/``head_chunks``."""
    import numpy as np

    import distributed_tpu_torch as dtt

    lm_kw = {n: kw.pop(n) for n in ("dtype", "remat", "remat_policy")
             if n in kw}
    tok = np.random.default_rng(0).integers(0, 256, (batch * steps,
                                                     t_len + 1))
    x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
    m = dtt.Model(dtt.models.transformer_lm(
        256, num_layers=2, d_model=64, num_heads=2, max_len=t_len,
        flash=True, **lm_kw), device=dev)
    m.compile(optimizer=dtt.optim.Adam(1e-3),
              loss="pallas_sparse_categorical_crossentropy",
              steps_per_execution=k, **kw)
    m.build((t_len,), seed=0)
    for mod in (flash_ops, xent_ops):
        mod.reset_launch_counts()
    hist = m.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
                 shuffle=False, verbose=0)
    counts = dict(flash_ops.launches, **xent_ops.launches)
    return m, hist.history["loss"], counts


def _same_bits(a, b):
    pa, pb = a.params, b.params
    return [n for n in pa if not torch.equal(pa[n], pb[n])]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "nothing_saveable",
                                    "dots_with_no_batch_dims_saveable"])
def test_remat_recomputes_the_flash_forward_and_keeps_the_bits(cuda_device,
                                                               policy):
    """bf16 layers: remat's parameters after 2 steps are the plain run's
    bit for bit (the kernels are deterministic, the recompute runs them on
    the same stream); K3 runs twice a layer a step, K4/K5 once."""
    plain, lp, cp = _lm_run(cuda_device, dtype="bfloat16")
    remat, lr, cr = _lm_run(cuda_device, dtype="bfloat16", remat=True,
                            remat_policy=policy)
    assert lr == lp and not _same_bits(plain, remat)
    assert (cp["flash_fwd"], cp["flash_dq"], cp["flash_dkv"]) == (4, 4, 4)
    assert (cr["flash_fwd"], cr["flash_dq"], cr["flash_dkv"]) == (8, 4, 4)


@pytest.mark.cuda
def test_remat_under_cuda_graphs_matches_eager(cuda_device):
    """remat with K=2 steps a dispatch (each step's forward, backward and
    recompute captured into a graph on the capture's side stream) against
    K=1 eager from the same start: the same bits."""
    kw = dict(dtype="bfloat16", remat=True,
              remat_policy="dots_with_no_batch_dims_saveable")
    eager, _, _ = _lm_run(cuda_device, steps=4, **kw)
    graph, _, _ = _lm_run(cuda_device, k=2, steps=4, **kw)
    assert not _same_bits(eager, graph)


@pytest.mark.cuda
def test_head_chunks_launch_the_loss_once_a_chunk(cuda_device):
    """f32, TF32 off: head_chunks=4 launches K9 and K10 four times a step,
    and its losses hold the unchunked run's to rtol 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, lp, cp = _lm_run(cuda_device)
    _, lc, cc = _lm_run(cuda_device, head_chunks=4)
    assert (cp["xent_fwd"], cp["xent_bwd"]) == (2, 2)
    assert (cc["xent_fwd"], cc["xent_bwd"]) == (8, 8)
    for a, b in zip(lc, lp):
        assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,dtype", [("mixed_bfloat16", "bfloat16"),
                                          ("mixed_float16", "float16")])
def test_policy_reaches_the_flash_kernels_in_its_dtype(cuda_device, policy,
                                                       dtype):
    """Layers with no dtype= under a policy compute in its dtype: every
    flash launch takes the policy's dtype on the wgmma route; the losses
    are finite."""
    _, losses, counts = _lm_run(cuda_device, precision=policy)
    want = {f"{k}/{dtype}": 4 for k in ("flash_fwd", "flash_dq",
                                         "flash_dkv")}
    got = {k: n for k, n in flash_ops.dtype_launches.items() if n}
    assert got == want
    assert all(flash_ops.route_launches[f"{k}/wgmma"] == 4
               for k in ("flash_fwd", "flash_dq", "flash_dkv"))
    import math
    assert all(math.isfinite(v) for v in losses)


@pytest.mark.cuda
def test_loss_scale_is_a_graph_input_not_a_frozen_float(cuda_device):
    """mixed_float16: K=2 as CUDA graphs against K=1 eager, 4 steps: the
    same bits and the same scale. Then the live scale is set to 2^60 on
    the graph model: the replayed steps overflow, are skipped (parameters
    and Adam's count unchanged) and halve the scale each time, which a
    scale frozen into the graph at its captured 2^15 would not."""
    eager, _, _ = _lm_run(cuda_device, steps=4, precision="mixed_float16")
    graph, _, _ = _lm_run(cuda_device, k=2, steps=4,
                          precision="mixed_float16")
    assert not _same_bits(eager, graph)
    assert float(eager.opt_state.scale) == float(graph.opt_state.scale)
    import numpy as np

    state = graph.opt_state
    before = {n: t.clone() for n, t in graph.params.items()}
    count = state.inner_state["count"]
    state.scale.fill_(2.0 ** 60)
    tok = np.random.default_rng(1).integers(0, 256, (8, 513))
    graph.fit(tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32),
              batch_size=4, epochs=1, steps_per_epoch=2, shuffle=False,
              verbose=0)
    assert float(state.scale) == 2.0 ** 58
    assert state.inner_state["count"] == count
    assert all(torch.equal(before[n], t) for n, t in graph.params.items())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_quantized_engine_fused_matches_reference_on_the_card(cuda_device,
                                                              kv_dtype):
    """An f32 LM with int8 weights (quant.quantize_model), TF32 off, on the
    card: the Engine's fused decode (K1/K2) gives the reference read's
    tokens, greedy and sampled, as phase d holds the unquantized model;
    K1 (or K2) launched."""
    import numpy as np

    import distributed_tpu_torch as dtt

    torch.backends.cuda.matmul.allow_tf32 = False
    m = dtt.Model(dtt.models.transformer_lm(
        97, num_layers=2, d_model=32, num_heads=2, max_len=64),
        device=cuda_device).build((16,), seed=3)
    dtt.quant.quantize_model(m)
    rng = np.random.default_rng(4)
    reqs = [dtt.serving.Request(rng.integers(0, 97, (int(n),)).astype(
        np.int32), 8, seed=i) for i, n in enumerate(rng.integers(3, 20, 5))]
    for temp in (0.0, 0.8):
        paged_ops.reset_launch_counts()
        outs = [dtt.serving.Engine(
            m, max_slots=2, block_size=8, max_len=64, kv_dtype=kv_dtype,
            temperature=temp, decode_kernel=kind).run(reqs)
            for kind in ("reference", "fused")]
        assert sum(paged_ops.launches.values()) > 0
        for a, b in zip(*outs):
            np.testing.assert_array_equal(b, a)


@pytest.mark.cuda
@pytest.mark.parametrize("int8,nb,bs,h,hd", [
    (False, 8, 16, 4, 64), (True, 8, 16, 4, 64),
    # An odd-sized int8 pool: 7 blocks of 5 rows of 3 heads of 16, so a
    # layer's slice is 1,680 bytes apart: whole 16-byte chunks, as every
    # vector-read head width makes it (hd * itemsize a multiple of 16).
    (True, 7, 5, 3, 16), (False, 7, 5, 3, 24)])
def test_paged_attention_on_stacked_pool_slices(cuda_device, int8, nb, bs,
                                                h, hd):
    """K1/K2 on slice i of a stacked (S, NB, bs, H, hd) pool, as a
    ScannedBlocks layer's paged hook hands it: each slice against its
    plain version, and the read path the wrapper chose, which is the
    vector one at every slice."""
    s_blocks, slots = 3, 2
    g = torch.Generator(device=cuda_device).manual_seed(5)
    shape = (s_blocks, nb, bs, h, hd)
    kp = torch.randn(shape, generator=g, device=cuda_device)
    vp = torch.randn(shape, generator=g, device=cuda_device)
    dtype = torch.float32 if int8 else torch.bfloat16
    if int8:
        def quant(pool):
            amax = pool.abs().amax(dim=-1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, 1.0)
            return {"q": torch.clamp(torch.round(pool / scale), -127,
                                     127).to(torch.int8), "scale": scale}
        kp, vp = quant(kp), quant(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.randn((slots, 1, h, hd), generator=g, device=cuda_device).to(
        dtype)
    tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32,
                          device=cuda_device)
    positions = torch.tensor([3 * bs - 1, bs + 1], dtype=torch.int32,
                             device=cuda_device)
    key = "paged_attention_int8" if int8 else "paged_attention"
    for i in range(s_blocks):
        ki = {k: v[i] for k, v in kp.items()} if int8 else kp[i]
        vi = {k: v[i] for k, v in vp.items()} if int8 else vp[i]
        paged_ops.reset_launch_counts()
        got = paged_ops.paged_attention(q, ki, vi, tables, positions)
        want = paged_ops.paged_attention_ref(q, ki, vi, tables, positions)
        torch.cuda.synchronize()
        vec = hd * (1 if int8 else 2) % 16 == 0
        assert paged_ops.launches_by_path == {
            (key, "vector" if vec else "scalar"): 1}, (i, paged_ops.launches_by_path)
        tol = 2e-5 if int8 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_scanned_engine_fused_matches_unrolled_on_the_card(cuda_device,
                                                           kv_dtype):
    """A scan=True LM served on the card through the stacked pools (f32,
    TF32 off) gives the unrolled LM's tokens on the same weights, fused and
    reference; K1 (or K2) launched once a layer and decode step."""
    import numpy as np

    import distributed_tpu_torch as dtt

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(num_layers=3, d_model=32, num_heads=2, max_len=64)
    un = dtt.Model(dtt.models.transformer_lm(97, **kw),
                   device=cuda_device).build((16,), seed=3)
    sc = dtt.Model(dtt.models.transformer_lm(97, scan=True, **kw),
                   device=cuda_device).build((16,), seed=3)
    # The same generator draws the blocks in the same order: the stacked
    # leaves are the unrolled layers' leaves.
    stacked = sc.params["scanned_blocks/blocks/residual/main/"
                        "multi_head_attention/wq"]
    assert torch.equal(stacked[1], un.params[
        "residual_2/main/multi_head_attention/wq"])
    rng = np.random.default_rng(4)
    reqs = [dtt.serving.Request(rng.integers(0, 97, (int(n),)).astype(
        np.int32), 8) for n in rng.integers(3, 20, 5)]
    outs = {}
    for name, m in (("unrolled", un), ("scanned", sc)):
        for kind in ("reference", "fused"):
            paged_ops.reset_launch_counts()
            eng = dtt.serving.Engine(m, max_slots=2, block_size=8,
                                     max_len=64, kv_dtype=kv_dtype,
                                     decode_kernel=kind)
            outs[name, kind] = eng.run(reqs)
            if kind == "fused":
                steps = eng.last_run_telemetry["decode_steps"]
                assert sum(paged_ops.launches.values()) == 3 * steps
    for key, got in outs.items():
        for a, b in zip(outs["unrolled", "reference"], got):
            np.testing.assert_array_equal(b, a, err_msg=str(key))


# ------------------------------- sharded strategies' collectives (NCCL, 1)
@pytest.fixture
def nccl_world1(cuda_device):
    """A world-1 NCCL group (``FSDP()`` forms one), shut down after."""
    import distributed_tpu_torch as dtt

    strategy = dtt.FSDP()
    yield strategy
    dtt.cluster.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dim", [((64, 48), 0), ((64, 48), 1),
                                       ((4, 6, 8), 1)])
def test_gather_functions_world1_nccl(nccl_world1, dtype, shape, dim):
    """At world 1 the gather's forward is the block itself, its backward
    (the reduce-scatter, a sum of one) the cotangent itself; the same for
    the asynchronous form, the owner's broadcast and the no-grad gathers,
    bit for bit."""
    from distributed_tpu_torch.parallel import collectives

    lay = collectives.Layout(shape, dim, 1, 0)
    g = torch.Generator(device=nccl_world1.device).manual_seed(dim)
    x = torch.randn(shape, generator=g, device=nccl_world1.device).to(dtype)
    dy = torch.randn(shape, generator=g, device=nccl_world1.device).to(dtype)
    for start in (lambda t: collectives.gather(t, lay),
                  lambda t: collectives.start_gather(t, lay).wait(),
                  lambda t: collectives.start_owner_copy(t, 0, shape).wait()):
        leaf = x.clone().requires_grad_()
        y = start(leaf)
        assert y.dtype == dtype and torch.equal(y, x)
        (dx,) = torch.autograd.grad(y, leaf, dy)
        assert torch.equal(dx, dy)
    assert torch.equal(collectives.gather_full(x, lay), x)
    out = torch.empty_like(x)
    collectives.all_gather_blocks([out], [x], [lay])
    assert torch.equal(out, x)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_over_shard_blocks_bit_for_bit(cuda_device, wd):
    """K11 over rank blocks of sharded leaves (2 ranks' layouts, blocks on
    dims 0 and 1, contiguous copies as ZeRO-1 and FSDP hand it) equals its
    plain version bit for bit, and each block equals that block of the
    whole leaves' update."""
    from distributed_tpu_torch.parallel.collectives import Layout
    from distributed_tpu_torch.parallel.strategy import \
        _largest_divisible_spec

    g = torch.Generator(device=cuda_device).manual_seed(7)
    shapes = [(768, 3072), (3072, 768), (768,), (12, 64, 96), (10,)]
    whole = [[torch.randn(s, generator=g, device=cuda_device) * scale
              for s in shapes] for scale in (1.0, 1e-2, 1e-3)]
    whole.append([torch.rand(s, generator=g, device=cuda_device) * 1e-5
                  for s in shapes])
    s = adam_ops.AdamScalars(*(float(torch.tensor(v)) for v in (
        -1e-3, 0.9, 0.999, 1 - 0.9, 1 - 0.999, 1e-8, wd, 1 - 0.9,
        1 - 0.999)))
    full = [[t.clone() for t in role] for role in whole]
    adam_ops.adam_update_ref(full[0], full[1], full[2], full[3], s)
    for rank in (0, 1):
        lays = [Layout(sh, d, 2, rank) if d is not None else None
                for sh in shapes for d in [_largest_divisible_spec(sh, 2)]]
        blocks = [[t.clone() if lay is None else lay.block(t)
                   for t, lay in zip(role, lays)] for role in whole]
        plain = [[t.clone() for t in role] for role in blocks]
        before = adam_ops.launches["fused_adam"]
        adam_ops.adam_update(blocks[0], blocks[1], blocks[2], blocks[3], s)
        adam_ops.adam_update_ref(plain[0], plain[1], plain[2], plain[3], s)
        torch.cuda.synchronize()
        assert adam_ops.launches["fused_adam"] == before + 1
        for role in (0, 2, 3):
            for got, want, ref, lay in zip(blocks[role], plain[role],
                                           full[role], lays):
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                ref = ref if lay is None else ref[lay.index()]
                assert torch.equal(got, ref)


@pytest.mark.cuda
def test_steps_per_execution_under_sharded_strategies(nccl_world1):
    """ZeRO-1 keeps its collectives in the eager update, so K=2 steps as
    CUDA graphs give K=1's parameters bit for bit; under FSDP the forward
    gathers, which a graph would capture, so K > 1 raises naming 1.3a."""
    import numpy as np

    import distributed_tpu_torch as dtt

    x = np.random.default_rng(0).integers(0, 64, (8, 33))
    x, y = x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)

    def model(strategy, k):
        with strategy.scope():
            m = dtt.Model(dtt.models.transformer_lm(
                64, num_layers=2, d_model=32, num_heads=2, max_len=32))
            m.compile(optimizer=dtt.optim.fused_adam(1e-3), metrics=[],
                      steps_per_execution=k)
        return m.build((32,), seed=0)

    zero = dtt.ZeroDataParallel()
    params = []
    for k in (1, 2):
        m = model(zero, k)
        m.fit(x, y, batch_size=8, epochs=1, steps_per_epoch=4, verbose=0)
        params.append({n: t.clone() for n, t in m.params.items()})
    assert all(torch.equal(params[0][n], params[1][n]) for n in params[0])
    with pytest.raises(NotImplementedError, match="ROADMAP 1.3a"):
        model(nccl_world1, 2).fit(x, y, batch_size=8, epochs=1,
                                  steps_per_epoch=2, verbose=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding", [0, 4])
def test_random_crop_gather_on_the_card_equals_cpu(cuda_device, dtype,
                                                   padding):
    """RandomCrop's one indexed gather (and RandomFlip) from a device key
    on the card: the CPU result from the same key data, bit for bit."""
    from distributed_tpu_torch import nn
    from distributed_tpu_torch.nn.core import rng_scope
    from distributed_tpu_torch.utils import threefry

    g = torch.Generator().manual_seed(3)
    x = torch.randn((16, 40, 36, 3), generator=g).to(dtype)
    layers = [nn.RandomCrop(32, 30, padding=padding),
              nn.RandomFlip("horizontal_and_vertical")]
    for layer in layers:
        layer.build((40, 36, 3), None)
        layer.train()
    key = threefry.fold_in(threefry.PRNGKey(7), 5)
    outs = []
    for dev in ("cpu", cuda_device):
        with rng_scope(threefry.device_key(key, dev)):
            y = layers[0](x.to(dev))
            outs.append(layers[1](y).cpu())
    assert outs[1].shape == (16, 32, 30, 3)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0][0], outs[0][1])


@pytest.mark.cuda
def test_measured_kl_on_the_card_equals_the_cpu_formula(cuda_device):
    """PostTrainer's measured KL (the log-softmax and the gather on the
    card, a few rows at a time) against the k3 formula over the whole f32
    logits computed on the CPU from the same parameters."""
    import numpy as np

    import distributed_tpu_torch as dtt
    from distributed_tpu_torch import rl

    torch.backends.cuda.matmul.allow_tf32 = False
    lm = dict(num_layers=2, d_model=64, num_heads=4, max_len=64)
    card = dtt.Model(dtt.models.transformer_lm(96, **lm), device="cuda")
    card.build((63,), seed=0)
    cpu = dtt.Model(dtt.models.transformer_lm(96, **lm), device="cpu")
    cpu.build((63,), seed=0)
    cpu.load_params({k: v.cpu() for k, v in card.params.items()})
    rng = np.random.default_rng(0)
    rolls = [rl.Rollout(rng.integers(0, 96, int(n)), 5,
                        rng.normal(-4.0, 1.0, int(n) - 5))
             for n in rng.integers(8, 64, 10)]
    x, y = rl.pack_rollouts(rolls, 64)
    pt = rl.PostTrainer.__new__(rl.PostTrainer)
    pt.model = card
    got = pt._measured_kl(x, y)
    logits = torch.from_numpy(cpu.predict(x, batch_size=len(x)))
    lp = torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(y[..., 0].astype(np.int64))[..., None])[..., 0]
    w = y[..., 3]
    d = (y[..., 2] - lp.numpy()) * w
    want = float(np.sum(w * (np.exp(d) - 1 - d)) / max(w.sum(), 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
