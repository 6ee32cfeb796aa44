"""Port layers against the JAX package's, on carried-over parameters.

Each layer is initialised in JAX, its parameters are loaded into the port
with ``interop.params_from_jax``, and both run on the same seeded numpy
input. Tolerances: f32 rtol/atol 1e-5 (sums in different orders); layers
computing in bf16 2e-2 (bf16 keeps about 3 significant digits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import as_np

torch.set_num_threads(1)


def _pair(jax_layer, port_layer, input_shape, seed=0):
    params, state, _ = jax_layer.init(jax.random.PRNGKey(seed), input_shape)
    model = dtt.Model(port_layer, device="cpu").build(input_shape)
    model.load_params(dtt.interop.params_from_jax(jax.device_get(params)))
    return params, state, model.module


def _check(jax_layer, port_layer, x, input_shape, tol):
    params, state, mod = _pair(jax_layer, port_layer, input_shape)
    want, _ = jax_layer.apply(params, state, jnp.asarray(x))
    got = mod(torch.from_numpy(np.asarray(x)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


DTYPES = [(None, 1e-5), ("bfloat16", 2e-2)]


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_dense_gelu(dtype, tol):
    x = np.random.default_rng(0).standard_normal((3, 5, 16)).astype(np.float32)
    _check(dtpu.nn.Dense(24, activation="gelu", dtype=dtype),
           dtt.nn.Dense(24, activation="gelu", dtype=dtype), x, (5, 16), tol)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    got = dtt.nn.activations.get("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_layer_norm(in_dtype):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((2, 7, 32))).astype(np.float32)
    jl, pl = dtpu.nn.LayerNorm(), dtt.nn.LayerNorm()
    params, state, mod = _pair(jl, pl, (7, 32))
    # Non-trivial scale/bias so the affine part is exercised too.
    params = {"scale": params["scale"] + 0.5, "bias": params["bias"] + 0.1}
    with torch.no_grad():
        mod.scale += 0.5
        mod.bias += 0.1
    want, _ = jl.apply(params, state, jnp.asarray(x, getattr(jnp, in_dtype)))
    got = mod(torch.from_numpy(x).to(getattr(torch, in_dtype)))
    assert got.dtype == getattr(torch, in_dtype)
    tol = 1e-5 if in_dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)
    assert pl.epsilon == 1e-6


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_embedding(dtype, tol):
    x = np.random.default_rng(2).integers(0, 50, (3, 9)).astype(np.int32)
    _check(dtpu.nn.Embedding(50, 16, dtype=dtype),
           dtt.nn.Embedding(50, 16, dtype=dtype), x, (9,), tol)


def test_positional_embedding_apply_and_paged_rows():
    jl, pl = dtpu.nn.PositionalEmbedding(32), dtt.nn.PositionalEmbedding(32)
    x = np.random.default_rng(3).standard_normal((2, 6, 8)).astype(np.float32)
    params, state, mod = _pair(jl, pl, (6, 8))
    want, _ = jl.apply(params, state, jnp.asarray(x))
    np.testing.assert_allclose(as_np(mod(torch.from_numpy(x))), as_np(want),
                               rtol=1e-6, atol=1e-6)
    # Paged decode reads per-slot rows; prefill a contiguous span.
    positions = np.array([5, 0], np.int32)
    want, _ = jl.paged_decode(params, state, {}, jnp.asarray(x[:, :1]),
                              block_tables=None,
                              positions=jnp.asarray(positions))
    got, _ = mod.paged_decode({}, torch.from_numpy(x[:, :1]),
                              block_tables=None,
                              positions=torch.from_numpy(positions))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-6, atol=1e-6)
    want, _ = jl.paged_prefill(params, state, {}, jnp.asarray(x[:1]),
                               block_table=None, start=7)
    got, _ = mod.paged_prefill({}, torch.from_numpy(x[:1]), block_table=None,
                               start=7)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_multi_head_attention_apply(dtype, tol, causal):
    x = np.random.default_rng(4).standard_normal((2, 10, 32)).astype(np.float32)
    _check(dtpu.nn.MultiHeadAttention(4, causal=causal, dtype=dtype),
           dtt.nn.MultiHeadAttention(4, causal=causal, dtype=dtype),
           x, (10, 32), tol)


def test_parameter_tree_paths_match_jax():
    """The weight carry-over keys on identical tree paths and shapes."""
    jm = dtpu.models.transformer_lm(64, num_layers=2, d_model=32,
                                    num_heads=2, max_len=16)
    params, _, _ = jm.init(jax.random.PRNGKey(0), (16,))
    want = {p: tuple(v.shape) for p, v in
            dtt.interop.flatten_tree(jax.device_get(params)).items()}
    pm = dtt.Model(dtt.models.transformer_lm(
        64, num_layers=2, d_model=32, num_heads=2, max_len=16),
        device="cpu").build((16,))
    got = {p: tuple(v.shape) for p, v in pm.params.items()}
    assert got == want
    assert "residual_1/main/dense_1/kernel" in got
