"""The port's flash attention against the JAX package's, on the CPU.

The JAX ``flash_attention`` runs its Pallas kernels in interpret mode with
``block_q=block_k=32``: the lane-packed kernels at (2, 64, 4, 32) (four
32-wide heads fill a 128-lane vector) and the folded ones at (1, 100, 3,
32) (T not a multiple of the tile), and at the head widths the card's
bf16 kernels pad (48, to 64) and fill (128), with a ragged T of 77. The
port runs the plain versions of its CUDA kernels (CPU tensors), which
form the full (T, T) scores; the card's kernels are held to those in
``tests/test_torch_cuda.py``. :func:`flash_route`, the wrapper's choice
of kernel family and padded width, is plain Python and tested here.

Values and the gradients of q, k and v (through ``sum(out * w)``), causal
and not. Tolerances: f32 as the JAX package's own flash test (values
atol 2e-5 / rtol 1e-5, grads atol 5e-5 / rtol 1e-4); bf16 2e-2 (the
probabilities round to bf16 at different running maxima: the JAX kernel
walks 32-column tiles, the plain version takes the row's maximum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.ops import flash_attention as jax_fa
from distributed_tpu_torch.ops import flash_attention as port_fa
from torch_parity import as_np, lm_pair

torch.set_num_threads(1)

SHAPES = [(2, 64, 4, 32), (1, 100, 3, 32), (1, 77, 2, 48), (1, 77, 1, 128)]
TOL = {"float32": dict(value=(2e-5, 1e-5), grad=(5e-5, 1e-4)),
       "bfloat16": dict(value=(2e-2, 2e-2), grad=(2e-2, 2e-2))}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, w, causal, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    wj = jnp.asarray(w, jnp.float32)

    def loss(q, k, v):
        out = jax_fa.flash_attention(q, k, v, causal=causal, block_q=32,
                                     block_k=32)
        return jnp.sum(out.astype(jnp.float32) * wj)

    out = jax_fa.flash_attention(*args, causal=causal, block_q=32,
                                 block_k=32)
    return out, jax.grad(loss, argnums=(0, 1, 2))(*args)


def _port(q, k, v, w, causal, dtype):
    args = [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in (q, k, v)]
    out = port_fa.flash_attention(*args, causal=causal, block_q=32,
                                  block_k=32)
    (out.to(torch.float32) * torch.from_numpy(w)).sum().backward()
    return out, [a.grad for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_jax(shape, causal, dtype):
    q, k, v, w = _inputs(shape)
    want, want_g = _jax(q, k, v, w, causal, getattr(jnp, dtype))
    got, got_g = _port(q, k, v, w, causal, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    atol, rtol = TOL[dtype]["value"]
    np.testing.assert_allclose(as_np(got), as_np(want), atol=atol, rtol=rtol)
    atol, rtol = TOL[dtype]["grad"]
    for name, a, b in zip("qkv", got_g, want_g):
        assert a.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(as_np(a), as_np(b), atol=atol, rtol=rtol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_row_stats_match_jax_forward_kernel(causal):
    """m and l of flash_fwd_ref against the values the JAX forward kernel
    (``_fwd_pallas``, folded layout) returns for the backward."""
    b, t, h, d = SHAPES[1]
    q, k, v, _ = _inputs(SHAPES[1], seed=1)
    fold = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, t, d)
    _, m_want, l_want = jax_fa._fwd_pallas(
        fold(q), fold(k), fold(v), 1.0 / np.sqrt(d), causal, 32, 32)
    _, m, l = port_fa.flash_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal)
    assert m.shape == l.shape == (b, h, t)
    np.testing.assert_allclose(as_np(m).reshape(b * h, t), as_np(m_want),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(as_np(l).reshape(b * h, t), as_np(l_want),
                               atol=1e-5, rtol=1e-5)


def test_flash_bwd_ref_is_the_gradient_of_flash_fwd_ref():
    """The plain backward against autograd through dense attention, both
    in f32 (the two round differently: scale multiplied vs divided)."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(SHAPES[1], 2))
    args = [a.clone().requires_grad_(True) for a in (q, k, v)]
    (port_fa.dense_attention(*args, True) * w).sum().backward()
    o, m, l = port_fa.flash_fwd_ref(q, k, v, True)
    do = w.to(o.dtype)
    got = port_fa.flash_bwd(q, k, v, do, m, l, port_fa.flash_delta(do, o),
                            True)
    for a, b in zip(got, args):
        torch.testing.assert_close(a, b.grad, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("flash", [True, False, "auto"])
def test_attention_layer_paths_match_jax(flash):
    """transformer_lm(flash=...) logits in both packages: flash=True takes
    the flash path (plain versions here), False and "auto" on the CPU the
    dense path, as the JAX layer does off the TPU."""
    jm, pm = lm_pair(vocab=64, max_len=64, flash=flash)
    x = np.random.default_rng(3).integers(0, 64, (2, 64)).astype(np.int32)
    want, _ = jm.module.apply(jm.params, jm.state, jnp.asarray(x))
    mha = [m for m in pm.module.modules()
           if isinstance(m, dtt.nn.MultiHeadAttention)]
    assert mha and all(m._use_flash(torch.zeros(1, 64, 1)) == (flash is True)
                       for m in mha)
    with torch.inference_mode():
        got = pm.module(torch.from_numpy(x))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,width", [(16, 64), (32, 64), (48, 64), (64, 64),
                                     (80, 128), (112, 128), (128, 128)])
def test_bf16_takes_the_wgmma_route_at_a_padded_width(d, width):
    assert port_fa.flash_route(torch.bfloat16, d) == ("wgmma", width)


@pytest.mark.parametrize("d", [16, 48, 64, 128])
def test_float32_takes_the_cuda_core_route_unpadded(d):
    assert port_fa.flash_route(torch.float32, d) == ("cuda_core", d)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 144), (torch.float32, 144),
                                     (torch.bfloat16, 40), (torch.float32, 8),
                                     (torch.bfloat16, 0), (torch.float16, 64)])
def test_flash_route_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="head_dim|dtype"):
        port_fa.flash_route(dtype, d)


def test_flash_option_is_validated():
    with pytest.raises(ValueError, match="flash"):
        dtt.nn.MultiHeadAttention(2, flash="yes")
    assert dtpu is not None
