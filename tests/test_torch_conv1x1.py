"""K12's plain version against the Pallas GEMM it replaces, and the layers
around it (Conv2D's 1x1 route, SpaceToDepth, Residual with a shortcut)
against the JAX package's.

- ``ops.conv1x1.conv1x1_ref`` against ``examples/pallas_conv1x1.py``'s
  ``_mm_kernel``, run by a ``pl.pallas_call(..., interpret=True)`` built
  here with ``pallas_gemm``'s specs (``pallas_gemm`` itself has no
  interpret flag), and against ``xla_gemm``.
- Conv2D with a 1x1 kernel (which the port computes as that GEMM) at
  strides 1 and 2, odd sizes, with and without a bias: outputs and the
  gradients of x, the kernel and the bias against ``jax.vjp``.
- SpaceToDepth; Residual with a projection shortcut and an activation.

Tolerances. f32: rtol 1e-5 (atol 1e-5 for layers: sums in another order).
bf16 GEMM: each entry within one bf16 ulp of the reference's, plus the f32
sums' own rounding bound, 2 K 2^-24 sum|x||w| (both sides round one f32
sum once; the sums may differ in their last bits, which moves the rounded
value by at most one ulp, or by more only where the sum is near 0).
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
from distributed_tpu_torch.ops import conv1x1 as conv_ops
from torch_parity import as_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def gemm_example():
    spec = importlib.util.spec_from_file_location(
        "_examples_pallas_conv1x1", ROOT / "examples" / "pallas_conv1x1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret_gemm(mod, x, w, block_m):
    """``pallas_gemm``'s pallas_call with ``interpret=True``."""
    from jax.experimental import pallas as pl

    m, k = x.shape
    n = w.shape[1]
    return pl.pallas_call(
        mod._mm_kernel,
        grid=(m // block_m,),
        in_specs=[pl.BlockSpec((block_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((block_m, n), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        interpret=True,
    )(x, w)


def _within_one_ulp(got, want, x, w):
    """Every bf16 entry of ``got`` within one ulp of ``want``'s plus the
    f32 sums' rounding bound."""
    got, want = as_np(got), as_np(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    k = x.shape[1]
    bound = 2 * k * 2.0 ** -24 * (np.abs(as_np(x)) @ np.abs(as_np(w)))
    np.testing.assert_array_less(np.abs(got - want), ulp + bound + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,block_m", [(256, 64, 256, 64),
                                           (96, 128, 40, 32)])
def test_conv1x1_plain_version_matches_the_pallas_gemm(gemm_example, dtype,
                                                       m, k, n, block_m):
    rng = np.random.default_rng(m + k)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.dtype(dtype))
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.1, jnp.dtype(dtype))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    wt = torch.from_numpy(np.array(w.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = conv_ops.conv1x1(xt, wt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (m, n)
    for want in (_interpret_gemm(gemm_example, x, w, block_m),
                 gemm_example.xla_gemm(x, w)):
        if dtype == "float32":
            np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5,
                                       atol=1e-5)
        else:
            _within_one_ulp(got, want, xt, wt)


def _layer_pair(jax_layer, port_layer, input_shape, seed=0):
    params, state, out_shape = jax_layer.init(jax.random.PRNGKey(seed),
                                              input_shape)
    model = dtt.Model(port_layer, device="cpu").build(input_shape)
    assert model.module.build(tuple(input_shape),
                              torch.Generator()) == out_shape
    model.load_params(dtt.interop.params_from_jax(jax.device_get(params)))
    return params, state, model


def _check_grads(jax_layer, params, state, model, x, dy):
    def f(x, p):
        return jax_layer.apply(p, state, x)[0]

    want, vjp = jax.vjp(f, jnp.asarray(x), params)
    want_dx, want_dp = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = model.module(xt)
    names = list(model.params)
    grads = torch.autograd.grad(got, [xt] + list(model.params.values()),
                                torch.from_numpy(dy))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(as_np(grads[0]), as_np(want_dx), rtol=1e-5,
                               atol=1e-5)
    flat = dtt.interop.flatten_tree(jax.device_get(want_dp))
    assert set(flat) == set(names)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(as_np(g), flat[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("strides", [1, 2])
def test_conv2d_1x1_and_its_gradients_match_jax(strides, use_bias):
    shape = (7, 9, 6)
    kw = dict(strides=strides, padding="same", use_bias=use_bias)
    params, state, model = _layer_pair(dtpu.nn.Conv2D(5, 1, **kw),
                                       dtt.nn.Conv2D(5, 1, **kw), shape)
    assert set(model.params) == ({"kernel", "bias"} if use_bias
                                 else {"kernel"})
    rng = np.random.default_rng(strides)
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    ho, wo = -(-7 // strides), -(-9 // strides)
    dy = rng.standard_normal((3, ho, wo, 5)).astype(np.float32)
    if use_bias:
        params = {"kernel": params["kernel"],
                  "bias": jnp.asarray(rng.standard_normal(5), jnp.float32)}
        model.load_params(dtt.interop.params_from_jax(params))
    _check_grads(dtpu.nn.Conv2D(5, 1, **kw), params, state, model, x, dy)


def test_conv2d_kernel_initializers_and_bf16_1x1():
    conv = dtt.nn.Conv2D(4, 1, kernel_initializer="glorot_uniform",
                         dtype="bfloat16", use_bias=False)
    conv.build((3, 3, 64), torch.Generator().manual_seed(0))
    limit = (6 / (64 + 4)) ** 0.5
    assert float(conv.kernel.detach().abs().max()) <= limit
    assert abs(float(conv.kernel.detach().std()) - limit / 3 ** 0.5) < 0.03
    x = torch.randn((2, 3, 3, 64), generator=torch.Generator().manual_seed(1))
    y = conv(x)
    want = conv_ops.conv1x1_ref(x.reshape(-1, 64).bfloat16(),
                                conv.kernel.reshape(64, 4).bfloat16())
    assert y.dtype == torch.bfloat16
    assert torch.equal(y.reshape(-1, 4), want)
    # he_normal is ported: a normal truncated at 2 sigma, sigma =
    # sqrt(2 / fan_in) / 0.8796 (fan_in 64 here).
    he = dtt.nn.Conv2D(4, 1, kernel_initializer="he_normal")
    he.build((3, 3, 64), torch.Generator().manual_seed(0))
    sigma = (2 / 64) ** 0.5 / 0.87962566103423978
    assert float(he.kernel.detach().abs().max()) <= 2 * sigma


def test_space_to_depth_matches_jax():
    jl, pl_ = dtpu.nn.SpaceToDepth(2), dtt.nn.SpaceToDepth(2)
    params, state, model = _layer_pair(jl, pl_, (6, 8, 3))
    x = np.random.default_rng(0).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    want = jl.apply(params, state, jnp.asarray(x))[0]
    got = model.module(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 4, 12)
    assert np.array_equal(as_np(got), as_np(want))
    with pytest.raises(ValueError, match="divisible"):
        dtt.nn.SpaceToDepth(2).build((5, 8, 3), torch.Generator())


@pytest.mark.parametrize("strides", [1, 2])
def test_residual_with_projection_and_activation_matches_jax(strides):
    def block(nn):
        main = nn.Sequential([
            nn.Conv2D(8, 3, strides=strides, padding="same", use_bias=False),
            nn.Activation("relu"),
            nn.Conv2D(8, 1, padding="same"),
        ], name="main")
        shortcut = nn.Sequential([nn.Conv2D(8, 1, strides=strides,
                                            padding="same")],
                                 name="shortcut")
        return nn.Residual(main, shortcut, activation="relu")

    jl = block(dtpu.nn)
    params, state, model = _layer_pair(jl, block(dtt.nn), (6, 7, 4))
    assert {p.split("/")[0] for p in model.params} == {"main", "shortcut"}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    out = model.module(torch.from_numpy(x))
    dy = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    _check_grads(jl, params, state, model, x, dy)
    with pytest.raises(ValueError, match="shapes differ"):
        dtt.nn.Residual(dtt.nn.Conv2D(3, 1)).build((4, 4, 2),
                                                   torch.Generator())


@pytest.mark.parametrize("dtype,k,n,route", [
    (torch.bfloat16, 64, 256, ("wgmma", 64, 256)),
    (torch.bfloat16, 2048, 512, ("wgmma", 2048, 512)),
    (torch.bfloat16, 24, 40, ("wgmma", 24, 40)),
    (torch.bfloat16, 64, 36, ("wgmma", 64, 40)),
    (torch.bfloat16, 3, 64, ("wgmma", 8, 64)),
    (torch.bfloat16, 1, 1, ("wgmma", 8, 8)),
    (torch.float32, 64, 256, ("cuda_core", 64, 256)),
    (torch.float32, 3, 36, ("cuda_core", 3, 36)),
])
def test_conv1x1_route_is_chosen_from_the_shape(dtype, k, n, route):
    """bf16 products take the wgmma kernel at K and N rounded up to
    multiples of 8 (rows of whole 16-byte chunks), f32 the CUDA-core one
    at their own widths; decided before the launch (the card tests count
    the routes)."""
    assert conv_ops.conv1x1_route(dtype, k, n) == route


@pytest.mark.parametrize("m,k,n", [(37, 3, 36), (16, 64, 36), (5, 1, 1)])
def test_conv1x1_zero_padding_is_exact(m, k, n):
    """The plain product of the zero-padded copies the wrapper gives the
    wgmma kernel, sliced back to N columns, is the unpadded product bit
    for bit: the padded columns of X meet zero rows of W. Inputs on a 1/8
    grid, whose sums are exact in f32 in any order."""
    rng = np.random.default_rng(m + k + n)
    x, w = (torch.from_numpy(np.round(rng.standard_normal(shape) * 8) / 8).to(
        torch.bfloat16) for shape in ((m, k), (k, n)))
    _, kp, np_ = conv_ops.conv1x1_route(torch.bfloat16, k, n)
    xp, wp = conv_ops.padded(x, m, kp), conv_ops.padded(w, kp, np_)
    assert xp.shape == (m, kp) and wp.shape == (kp, np_)
    assert xp.data_ptr() % 16 == 0 and wp.data_ptr() % 16 == 0
    assert not xp[:, k:].any() and not wp[k:].any() and not wp[:, n:].any()
    got = conv_ops.conv1x1_ref(xp, wp)[:, :n]
    assert torch.equal(got.view(torch.int16),
                       conv_ops.conv1x1_ref(x, w).view(torch.int16))
    assert conv_ops.padded(xp, m, kp) is xp


def test_conv1x1_route_refuses_other_dtypes():
    """float16 takes the wgmma route as bf16 does (the reference's
    ``_mm_kernel`` takes any float dtype); float64, which the JAX package
    does not run, is refused."""
    assert conv_ops.conv1x1_route(torch.float16, 64, 36) == ("wgmma", 64, 40)
    with pytest.raises(ValueError, match="dtype"):
        conv_ops.conv1x1_route(torch.float64, 64, 64)
