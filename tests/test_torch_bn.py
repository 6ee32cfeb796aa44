"""BatchNorm in the port against the JAX package's, and K13/K14's plain
versions against the Pallas kernels they replace.

- ``ops.bn_reduce.bn_stats_ref`` / ``bn_bwd_reduce_ref`` (the plain
  versions of K13/K14) against ``examples/bn_pallas.py``'s ``bn_stats`` /
  ``bn_bwd_reduce``, which run their Pallas kernels in interpret mode off
  the TPU, at C = 64 (folded into 128 lanes there) and C = 96, in f32 and
  bf16.
- ``nn.BatchNorm`` against the JAX layer in train and eval mode, under
  both shifts, in f32 and bf16: the output, the new running statistics and
  the gradients of x, scale and bias (through ``_bn_norm``'s custom VJP in
  train mode).

Tolerances. The sums: rtol 1e-5 plus atol 1e-5 times the sum of the
terms' magnitudes (f32 sums in another order; a sum of signed terms can
cancel to near 0). f32 layer outputs, states and gradients: rtol/atol
1e-5. bf16: the running statistics and the f32 gradients of scale and bias
are computed in f32 from the same bf16 values, rtol/atol 1e-5; the bf16
output and dx round at other places in the two frameworks (XLA may keep
an elementwise chain in f32 and round once), so 2 bf16 ulps, rtol/atol
1.6e-2.
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
from distributed_tpu_torch.ops import bn_reduce
from torch_parity import as_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bn_pallas():
    return _example("bn_pallas")


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DTYPES[dtype])


def _close_sums(got, want, terms):
    atol = 1e-5 * np.abs(terms).sum(axis=0)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * np.abs(want) + atol
                                 + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 96])
def test_bn_reduce_plain_versions_match_the_pallas_kernels(bn_pallas, dtype, c):
    rng = np.random.default_rng(c)
    m = 512
    x, xt = _pair(rng.standard_normal((m, c)) * 2 + 0.5, dtype)
    dy, dyt = _pair(rng.standard_normal((m, c)), dtype)
    shift = rng.standard_normal(c).astype(np.float32) * 0.3
    mean = rng.standard_normal(c).astype(np.float32) * 0.3
    inv = rng.uniform(0.5, 2.0, c).astype(np.float32)

    want = np.asarray(bn_pallas.bn_stats(x, jnp.asarray(shift)))
    got = bn_reduce.bn_stats(xt, torch.from_numpy(shift))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, c)
    xc = np.asarray(x.astype(jnp.float32)) - shift
    _close_sums(got[0].numpy(), want[0], xc)
    _close_sums(got[1].numpy(), want[1], xc * xc)

    want = np.asarray(bn_pallas.bn_bwd_reduce(dy, x, jnp.asarray(mean),
                                              jnp.asarray(inv)))
    got = bn_reduce.bn_bwd_reduce(dyt, xt, torch.from_numpy(mean),
                                  torch.from_numpy(inv))
    dyf = np.asarray(dy.astype(jnp.float32))
    xhat = (np.asarray(x.astype(jnp.float32)) - mean) * inv
    _close_sums(got[0].numpy(), want[0], dyf)
    _close_sums(got[1].numpy(), want[1], dyf * xhat)


def _bn_case(shift, seed=0, c=8):
    """A JAX BatchNorm with non-trivial parameters and state, and the
    port's holding the same."""
    rng = np.random.default_rng(seed)
    jl = dtpu.nn.BatchNorm(stats_shift=shift)
    params, state, _ = jl.init(jax.random.PRNGKey(0), (5, 6, c))
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(c) * 0.2, jnp.float32)}
    state = {"mean": jnp.asarray(rng.standard_normal(c) * 0.5, jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)}
    model = dtt.Model(dtt.nn.BatchNorm(stats_shift=shift), device="cpu")
    model.build((5, 6, c))
    model.load_params(dtt.interop.params_from_jax(params))
    model.load_state(dtt.interop.state_from_jax(state))
    return jl, params, state, model, rng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", ["data", "running"])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(dtype, shift, train):
    jl, params, state, model, rng = _bn_case(shift)
    assert set(model.params) == {"scale", "bias"}
    assert set(model.state) == {"mean", "var"}
    x, xt = _pair(rng.standard_normal((4, 5, 6, 8)) * 1.5 + 0.7, dtype)
    dy, dyt = _pair(rng.standard_normal((4, 5, 6, 8)), dtype)

    def f(x, p):
        return jl.apply(p, state, x, train=train)

    (want, new_state), vjp = jax.vjp(f, x, params)
    want_dx, want_dp = vjp((dy, jax.tree_util.tree_map(jnp.zeros_like,
                                                        new_state)))
    layer = model.module
    layer.train(train)
    xt.requires_grad_(True)
    got = layer(xt)
    got_dx, got_dscale, got_dbias = torch.autograd.grad(
        got, (xt, layer.scale, layer.bias), dyt)
    assert got.dtype == xt.dtype and got_dx.dtype == xt.dtype
    loose = 1.6e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=loose, atol=loose)
    np.testing.assert_allclose(as_np(got_dx), as_np(want_dx), rtol=loose,
                               atol=loose)
    if train or dtype == "float32":
        # In bf16 eval mode both frameworks sum scale's and bias's
        # gradients through the bf16 casts in bf16, each in its own order:
        # no common value to hold them to. Training takes the VJP's f32
        # sums.
        np.testing.assert_allclose(as_np(got_dscale),
                                   as_np(want_dp["scale"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(as_np(got_dbias), as_np(want_dp["bias"]),
                                   rtol=1e-5, atol=1e-5)
    want_state = new_state if train else state
    for k in ("mean", "var"):
        np.testing.assert_allclose(as_np(model.state[k]),
                                   as_np(want_state[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_batchnorm_dot_stats_and_options():
    jl, params, state, model, rng = _bn_case("running", seed=1)
    x, xt = _pair(rng.standard_normal((4, 5, 6, 8)), "float32")
    want, want_state = dtpu.nn.BatchNorm(
        stats_impl="dot", stats_shift="running").apply(params, state, x,
                                                       train=True)
    dot = dtt.nn.BatchNorm(stats_impl="dot", stats_shift="running")
    dot.build((5, 6, 8), torch.Generator())
    dot.load_state_dict(model.module.state_dict())
    dot.train()
    np.testing.assert_allclose(as_np(dot(xt)), as_np(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(as_np(getattr(dot, k)),
                                   as_np(want_state[k]), rtol=1e-5, atol=1e-6)
    assert dtt.nn.BatchNorm.stats_shift == dtpu.nn.BatchNorm.stats_shift
    assert dtt.nn.BatchNorm.stats_impl == dtpu.nn.BatchNorm.stats_impl
    with pytest.raises(ValueError, match="stats_impl"):
        dtt.nn.BatchNorm(stats_impl="sum")
    with pytest.raises(ValueError, match="stats_shift"):
        dtt.nn.BatchNorm(stats_shift="zero")
