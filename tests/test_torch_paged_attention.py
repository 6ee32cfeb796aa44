"""Port paged attention (distributed_tpu_torch.ops.paged_attention).

The plain version ``paged_attention_ref`` against the JAX package's Pallas
kernel (interpret mode on the CPU, as tests/test_paged_kernel.py runs it)
on the same seeded inputs; the trash/future-row mask; and the dispatch
rule (CPU tensors never reach the CUDA path). The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py.

Tolerances: 2e-5 for f32 (the two sum in different orders), 2e-2 for bf16
(probabilities round to bf16 at different running maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops import paged_attention as jax_paged
from distributed_tpu.quant import QKEY, SKEY
from distributed_tpu_torch.ops import paged_attention as port_paged

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
