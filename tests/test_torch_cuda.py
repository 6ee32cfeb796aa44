"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without an NVIDIA card (a CUDA kernel has
no CPU mode). The module imports neither JAX nor the JAX package, so on the
card it runs without them (``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances, per entry: 2e-5 for f32 (sums in different orders); bf16
outputs 2e-2 (probabilities round to bf16 at different running maxima),
bf16 flash gradients atol 2e-3 + rtol 2e-2, and flash dK/dV the same bits
on a second run (no atomics); the cross-entropy: 1e-5 on
the f32 losses, one bf16 ulp of each entry on bf16 gradients. The fused
Adam kernel: bit for bit (both sides round every operation once, in the
same order). The 1x1-convolution GEMM (K12): f32 within 2e-5 relative of
the sum of |x||w| (sums in another order); bf16 within one ulp of each
entry plus that bound. BatchNorm's reductions (K13/K14): rtol 1e-5 plus
1e-5 times the sum of the terms' magnitudes, and the same bits on a second
call (fixed order, no atomics). The launch probe (K15): bit for bit.
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


# ----------------------------------------------- fused softmax cross-entropy
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    else:  # every entry within one bf16 ulp of its own value
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
        assert bool(((dl.float() - want).abs() <= ulp).all())


# ---------------------------------------------------------- flash attention
# bf16 takes the wgmma kernels, whose tiles are 64 or 128 columns wide: D
# of 32 and 48 are zero-padded to 64, 128 fills its tile. T of 77, 130 and
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
        assert bool((diff <= ulp + 2 * k * 2.0 ** -24 * bound + 1e-30).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", [(50176, 64), (4099, 96), (777, 2048),
                                 (1000, 3)])
def test_bn_reduce_kernels_match_plain(cuda_device, dtype, m, c):
    g = torch.Generator(device=cuda_device).manual_seed(c)
    x = (torch.randn((m, c), generator=g, device=cuda_device) * 2 + 1).to(dtype)
    dy = torch.randn((m, c), generator=g, device=cuda_device).to(dtype)
    shift = torch.randn((c,), generator=g, device=cuda_device) * 0.5
    mean = torch.randn((c,), generator=g, device=cuda_device) * 0.5
    inv = torch.rand((c,), generator=g, device=cuda_device) + 0.5
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
    xc = x.float() - shift
    want = bn_ops.bn_stats_ref(x, shift)
    _close_sums(stats[0], want[0], xc)
    _close_sums(stats[1], want[1], xc * xc)
    want = bn_ops.bn_bwd_reduce_ref(dy, x, mean, inv)
    _close_sums(bwd[0], want[0], dy.float())
    _close_sums(bwd[1], want[1], dy.float() * (x.float() - mean) * inv)


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
