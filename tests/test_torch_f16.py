"""float16 through the kernels' plain versions against the JAX package.

The JAX package takes f16 where the port's K9/K10, K12 and K13/K14 run:
``fused_softmax_xent`` on f16 logits, ``examples/pallas_conv1x1.py``'s
``_mm_kernel`` on f16 operands, ``examples/bn_pallas.py``'s reductions on
any float dtype, and ``nn.BatchNorm`` in an f16 model. Here the JAX side
runs its Pallas kernels in interpret mode (off the TPU) and the port its
plain versions (CPU tensors), which the card's kernels are held to in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances. Cross-entropy losses: 1e-6 absolute (f32 sums of the same
f16 values in another order); f16 dlogits and GEMM outputs: one f16 ulp
of each entry (2^-10 of its binade, 2^-24 below the normal range), plus,
for the GEMM, the f32 sums' rounding bound 2 K 2^-24 sum|x||w| (both sides
round one f32 sum once). BatchNorm's sums: rtol 1e-5 plus 1e-5 times the
sum of the terms' magnitudes. The f16 layer: the running statistics and
the f32 gradients of scale and bias rtol/atol 1e-5; the f16 output and dx
round at other places in the two frameworks, 2 f16 ulps: rtol/atol 2e-3
(2 x 2^-10).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.ops import pallas_kernels as jax_pk
from distributed_tpu_torch.ops import bn_reduce
from distributed_tpu_torch.ops import conv1x1 as conv_ops
from distributed_tpu_torch.ops import pallas_kernels as port_pk
from torch_parity import as_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_examples_{name}_f16", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f16(a):
    """The same f16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float16)
    return j, torch.from_numpy(np.array(j))


def _ulp16(v):
    v = np.abs(np.asarray(v, np.float64))
    return np.maximum(np.exp2(np.floor(np.log2(np.maximum(v, 1e-30))) - 10),
                      2.0 ** -24)


@pytest.mark.parametrize("n,c", [(37, 300), (16, 1024)])
def test_xent_f16_matches_the_pallas_kernels(n, c):
    rng = np.random.default_rng(c)
    logits, tl = _f16(rng.standard_normal((n, c)) * 3)
    labels = rng.integers(0, c, (n,)).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    want = jax_pk.fused_softmax_xent(logits, jnp.asarray(labels))
    want_g = jax.grad(lambda x: jnp.sum(
        jax_pk.fused_softmax_xent(x, jnp.asarray(labels)) * w))(logits)
    tl.requires_grad_(True)
    got = port_pk.fused_softmax_xent(tl, torch.from_numpy(labels))
    (got * torch.from_numpy(w)).sum().backward()
    assert got.dtype == torch.float32 and tl.grad.dtype == torch.float16
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-6, rtol=0)
    want_g = np.asarray(want_g, np.float32)
    assert np.all(np.abs(as_np(tl.grad) - want_g) <= _ulp16(want_g))


@pytest.mark.parametrize("m,k,n,block_m", [(256, 64, 256, 64),
                                           (96, 128, 40, 32)])
def test_conv1x1_f16_matches_the_pallas_gemm(m, k, n, block_m):
    from jax.experimental import pallas as pl

    mod = _example("pallas_conv1x1")
    rng = np.random.default_rng(k + n)
    x, xt = _f16(rng.standard_normal((m, k)))
    w, wt = _f16(rng.standard_normal((k, n)) / np.sqrt(k))
    want = pl.pallas_call(
        mod._mm_kernel, grid=(m // block_m,),
        in_specs=[pl.BlockSpec((block_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((block_m, n), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype), interpret=True,
    )(x, w)
    got = conv_ops.conv1x1(xt, wt)
    assert got.dtype == torch.float16 and got.shape == (m, n)
    want = np.asarray(want, np.float32)
    bound = 2 * k * 2.0 ** -24 * (np.abs(as_np(xt)) @ np.abs(as_np(wt)))
    np.testing.assert_array_less(np.abs(as_np(got) - want),
                                 _ulp16(want) + bound + 1e-30)
    assert conv_ops.conv1x1_route(torch.float16, 36, 36) == ("wgmma", 40, 40)


@pytest.mark.parametrize("c", [64, 96])
def test_bn_reduce_f16_matches_the_pallas_kernels(c):
    mod = _example("bn_pallas")
    rng = np.random.default_rng(c)
    m = 512
    x, xt = _f16(rng.standard_normal((m, c)) * 2 + 0.5)
    dy, dyt = _f16(rng.standard_normal((m, c)))
    shift = rng.standard_normal(c).astype(np.float32) * 0.3
    mean = rng.standard_normal(c).astype(np.float32) * 0.3
    inv = rng.uniform(0.5, 2.0, c).astype(np.float32)

    def close(got, want, terms):
        atol = 1e-5 * np.abs(terms).sum(axis=0)
        np.testing.assert_array_less(np.abs(got - want),
                                     1e-5 * np.abs(want) + atol + 1e-30)

    xc = np.asarray(x, np.float32) - shift
    want = np.asarray(mod.bn_stats(x, jnp.asarray(shift)))
    got = bn_reduce.bn_stats(xt, torch.from_numpy(shift)).numpy()
    close(got[0], want[0], xc)
    close(got[1], want[1], xc * xc)
    dyf = np.asarray(dy, np.float32)
    xhat = (np.asarray(x, np.float32) - mean) * inv
    want = np.asarray(mod.bn_bwd_reduce(dy, x, jnp.asarray(mean),
                                        jnp.asarray(inv)))
    got = bn_reduce.bn_bwd_reduce(dyt, xt, torch.from_numpy(mean),
                                  torch.from_numpy(inv)).numpy()
    close(got[0], want[0], dyf)
    close(got[1], want[1], dyf * xhat)


@pytest.mark.parametrize("shift", ["data", "running"])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_f16_matches_jax(shift, train):
    c = 8
    rng = np.random.default_rng(5)
    jl = dtpu.nn.BatchNorm(stats_shift=shift)
    jl.init(jax.random.PRNGKey(0), (5, 6, c))
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(c) * 0.2, jnp.float32)}
    state = {"mean": jnp.asarray(rng.standard_normal(c) * 0.5, jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)}
    model = dtt.Model(dtt.nn.BatchNorm(stats_shift=shift), device="cpu")
    model.build((5, 6, c))
    model.load_params(dtt.interop.params_from_jax(params))
    model.load_state(dtt.interop.state_from_jax(state))
    x, xt = _f16(rng.standard_normal((4, 5, 6, c)) * 1.5 + 0.7)
    dy, dyt = _f16(rng.standard_normal((4, 5, 6, c)))

    (want, new_state), vjp = jax.vjp(
        lambda x, p: jl.apply(p, state, x, train=train), x, params)
    want_dx, want_dp = vjp((dy, jax.tree_util.tree_map(jnp.zeros_like,
                                                        new_state)))
    layer = model.module
    layer.train(train)
    xt.requires_grad_(True)
    got = layer(xt)
    got_dx, got_dscale, got_dbias = torch.autograd.grad(
        got, (xt, layer.scale, layer.bias), dyt)
    assert got.dtype == torch.float16 and got_dx.dtype == torch.float16
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(as_np(got_dx), as_np(want_dx), rtol=2e-3,
                               atol=2e-3)
    if train:  # the VJP's f32 sums (eval sums through the f16 casts)
        np.testing.assert_allclose(as_np(got_dscale), as_np(want_dp["scale"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(as_np(got_dbias), as_np(want_dp["bias"]),
                                   rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(as_np(model.state[k]),
                                   as_np((new_state if train else state)[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
