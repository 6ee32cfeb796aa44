"""Every head width and f16 through the port's flash and paged attention,
held to the JAX package on the CPU.

The card's kernels take every head width from 1 to 256: 16-bit heads are
zero-padded to a wgmma tile of 64, 128 or 256 columns, and heads whose
rows are not whole 16-byte chunks are zero-padded in a copy with the
scale of the real width (``ops.flash_attention``); the paged decode
kernel reads any width in place. On the CPU the port runs the kernels'
plain versions, so the tests here hold those to the JAX package:

- flash attention's values and gradients at D in {8, 24, 40, 256} in f32,
  and at D in {24, 64, 256} in f16, causal and not, against JAX's
  ``flash_attention`` (its Pallas kernels in interpret mode, tiles of 32);
- the padding identity the card relies on: the plain versions on heads
  zero-padded to the kernels' widths, with the real width's scale, sliced
  back, equal the unpadded ones bit for bit (inputs on a 1/8 grid, so every
  dot product over D is exact in f32 whatever its length);
- paged decode's plain read at hd in {8, 24, 256} against JAX's Pallas
  decode kernel (interpret mode), and the port's Engine with
  ``decode_kernel="fused"`` token-exact against the JAX Engine's at those
  widths.

The card's kernels are held to the same plain versions at these widths in
``tests/test_torch_cuda.py``.

Tolerances: f32 as the JAX package's own flash test (values atol 2e-5 /
rtol 1e-5, gradients atol 5e-5 / rtol 1e-4; paged 2e-5). f16: atol and
rtol 4e-3, four f16 ulps at 1.0: the probabilities round to f16 at other
running maxima (the JAX kernel walks 32-column tiles, the plain version
takes the row's maximum), which moves an output or gradient of magnitude
1-4 by one or two of its ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_tpu.ops import flash_attention as jax_fa
from distributed_tpu.ops import paged_attention as jax_paged
from distributed_tpu.serving import Engine as JaxEngine
from distributed_tpu.serving import Request as JaxRequest
from distributed_tpu_torch.ops import flash_attention as port_fa
from distributed_tpu_torch.ops import paged_attention as port_paged
from distributed_tpu_torch.serving import Engine, Request
from torch_parity import as_np, lm_pair

torch.set_num_threads(1)

TOL = {"float32": dict(value=(2e-5, 1e-5), grad=(5e-5, 1e-4)),
       "float16": dict(value=(4e-3, 4e-3), grad=(4e-3, 4e-3))}
FLASH_CASES = ([("float32", d) for d in (8, 24, 40, 256)]
               + [("float16", d) for d in (24, 64, 256)])


def _normals(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,d", FLASH_CASES)
def test_flash_attention_matches_jax_at_every_width(dtype, d, causal):
    q, k, v, w = _normals((1, 64, 2, d), 4, seed=d)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]

    def loss(q, k, v):
        out = jax_fa.flash_attention(q, k, v, causal=causal, block_q=32,
                                     block_k=32)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    want = jax_fa.flash_attention(*jargs, causal=causal, block_q=32,
                                  block_k=32)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
             for a in (q, k, v)]
    got = port_fa.flash_attention(*targs, causal=causal)
    (got.to(torch.float32) * torch.from_numpy(w)).sum().backward()
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    atol, rtol = TOL[dtype]["value"]
    np.testing.assert_allclose(as_np(got), as_np(want), atol=atol, rtol=rtol)
    atol, rtol = TOL[dtype]["grad"]
    for name, a, b in zip("qkv", targs, want_g):
        np.testing.assert_allclose(as_np(a.grad), as_np(b), atol=atol,
                                   rtol=rtol, err_msg=f"d{name}")


def _grid(shape, seed, dtype):
    """Normals rounded to a 1/8 grid within +-4: products and their sums
    over D are exact in f32."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.clip(np.round(rng.standard_normal(shape) * 8),
                                     -32, 32) / 8).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 24, 40, 200])
def test_padding_identity_is_exact(d, dtype, causal):
    """Both padded widths the card uses: the copy's (whole 16-byte rows)
    and the tile's (64 / 128 / 256, padded in shared memory)."""
    q, k, v, do = _grid((2, 37, 2, d), d, dtype)
    o, m, l = port_fa.flash_fwd_ref(q, k, v, causal)
    delta = port_fa.flash_delta(do, o)
    grads = port_fa.flash_bwd_ref(q, k, v, do, m, l, delta, causal)
    scale = port_fa._scale(d)
    for dp in sorted({port_fa._kernel_d(dtype, d),
                      port_fa.flash_route(torch.bfloat16, d)[1]}):
        pad = lambda x: F.pad(x, (0, dp - d))
        op, mp, lp = port_fa.flash_fwd_ref(pad(q), pad(k), pad(v), causal,
                                           scale=scale)
        assert torch.equal(op[..., :d], o) and not op[..., d:].any()
        assert torch.equal(mp, m) and torch.equal(lp, l)
        padded = port_fa.flash_bwd_ref(pad(q), pad(k), pad(v), pad(do), m, l,
                                       delta, causal, scale=scale)
        for name, a, b in zip(("dq", "dk", "dv"), grads, padded):
            assert torch.equal(b[..., :d], a), (name, dp)
            assert not b[..., d:].any(), (name, dp)


def test_kernel_width_is_whole_16_byte_rows():
    assert [port_fa._kernel_d(torch.bfloat16, d) for d in (1, 8, 9, 24, 255)] \
        == [8, 8, 16, 24, 256]
    assert [port_fa._kernel_d(torch.float32, d) for d in (1, 4, 5, 250)] \
        == [4, 4, 8, 252]


# -------------------------------------------------------------- paged decode
def _paged_case(seed, hd, kw, int8=False, s=3, nb=3, bs=4, h=2):
    rng = np.random.default_rng(seed)
    kp, vp = _normals((s * nb + 1, bs, h, hd), 2, seed)
    q = rng.standard_normal((s, kw, h, hd)).astype(np.float32)
    tables = (1 + np.arange(s * nb).reshape(s, nb)).astype(np.int32)
    positions = rng.integers(0, nb * bs - kw + 1, (s,)).astype(np.int32)
    positions[0] = 0
    if int8:
        def quant(pool):
            amax = np.max(np.abs(pool), axis=-1, keepdims=True)
            scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            return {"q": np.clip(np.round(pool / scale), -127, 127)
                    .astype(np.int8), "scale": scale}
        kp, vp = quant(kp), quant(vp)
    return q, kp, vp, tables, positions


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("kw", [1, 3])
@pytest.mark.parametrize("hd", [8, 24, 256])
def test_paged_ref_matches_jax_kernel_at_every_width(hd, kw, int8):
    q, kp, vp, tables, positions = _paged_case(hd + kw, hd, kw, int8)
    jpool = (lambda p: {k: jnp.asarray(v) for k, v in p.items()}
             if isinstance(p, dict) else jnp.asarray(p))
    want = jax_paged.paged_attention(
        jnp.asarray(q), jpool(kp), jpool(vp), jnp.asarray(tables),
        jnp.asarray(positions))
    tpool = (lambda p: {k: torch.from_numpy(v) for k, v in p.items()}
             if isinstance(p, dict) else torch.from_numpy(p))
    got = port_paged.paged_attention(
        torch.from_numpy(q), tpool(kp), tpool(vp), torch.from_numpy(tables),
        torch.from_numpy(positions))
    np.testing.assert_allclose(as_np(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("hd,heads", [(8, 2), (24, 2), (256, 1)])
def test_fused_engine_token_exact_vs_jax_at_width(hd, heads):
    """A one-layer LM of head width hd served by both Engines with the
    fused decode read (the port's plain version here, JAX's Pallas kernel
    in interpret mode): identical greedy tokens."""
    jm, pm = lm_pair(vocab=64, num_layers=1, d_model=hd * heads,
                     num_heads=heads, max_len=64, seed=hd)
    rng = np.random.default_rng(hd)
    prompts = [rng.integers(0, 64, (int(t),)).astype(np.int32)
               for t in (3, 9, 5)]
    news = [6, 4, 7]
    want = JaxEngine(jm, max_slots=2, block_size=4, max_len=64,
                     decode_kernel="fused").run(
        [JaxRequest(p, m) for p, m in zip(prompts, news)])
    got = Engine(pm, max_slots=2, block_size=4, max_len=64,
                 decode_kernel="fused").run(
        [Request(p, m) for p, m in zip(prompts, news)])
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(w), g), f"hd {hd} request {i}"
