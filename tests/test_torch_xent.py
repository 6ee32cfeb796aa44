"""The port's fused softmax cross-entropy against the JAX package's.

The JAX ``fused_softmax_xent`` runs its Pallas kernels in interpret mode;
the port runs the plain versions of its CUDA kernels (CPU tensors), which
the card's kernels are held to in ``tests/test_torch_cuda.py``. N = 37
rows (not a multiple of 8) of C = 300 classes (not a multiple of 128),
f32 and bf16 logits; values and ``jax.grad`` of ``sum(w * loss)``.

Tolerances: losses 1e-6 absolute (f32 sums of 300 exponentials in another
order); f32 dlogits 1e-6 absolute; bf16 dlogits one bf16 ulp (both sides
round the same f32 value once to bf16; a last-bit difference before the
rounding can move it by one ulp).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu_torch as dtt
from distributed_tpu.ops import losses as jax_losses
from distributed_tpu.ops import pallas_kernels as jax_pk
from distributed_tpu_torch.ops import losses as port_losses
from distributed_tpu_torch.ops import pallas_kernels as port_pk
from torch_parity import as_np

torch.set_num_threads(1)

N, C = 37, 300


def _inputs(seed=0, n=N, c=C):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    labels = rng.integers(0, c, (n,)).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    return logits, labels, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_xent_values_and_grad_match_jax(dtype):
    logits, labels, w = _inputs()
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    want = jax_pk.fused_softmax_xent(jl, jnp.asarray(labels))
    want_g = jax.grad(lambda x: jnp.sum(
        jax_pk.fused_softmax_xent(x, jnp.asarray(labels)) * w))(jl)

    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    tl.requires_grad_(True)
    got = port_pk.fused_softmax_xent(tl, torch.from_numpy(labels))
    (got * torch.from_numpy(w)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (N,)
    assert tl.grad.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-6, rtol=0)
    want_g = as_np(want_g)
    if dtype == "float32":
        np.testing.assert_allclose(as_np(tl.grad), want_g, atol=1e-6, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_g), 1e-30))) - 7)
        assert np.all(np.abs(as_np(tl.grad) - want_g) <= ulp)


def test_plain_versions_are_the_kernels_contract():
    """xent_fwd_ref/xent_bwd_ref (what the kernels are held to) against
    the JAX kernels directly."""
    logits, labels, w = _inputs(seed=1)
    want = jax_pk._xent_forward(jnp.asarray(logits), jnp.asarray(labels))
    want_g = jax_pk._xent_backward(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(w))
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(as_np(port_pk.xent_fwd_ref(tl, tb)),
                               as_np(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        as_np(port_pk.xent_bwd_ref(tl, tb, torch.from_numpy(w))),
        as_np(want_g), atol=1e-6, rtol=0)


def test_registry_name_and_token_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, C)).astype(np.float32)
    labels = rng.integers(0, C, (2, 5)).astype(np.int32)
    name = "pallas_sparse_categorical_crossentropy"
    port_fn = port_losses.get(name)
    assert port_fn is port_pk.pallas_sparse_categorical_crossentropy
    assert port_losses.get_per_example(port_fn) is port_pk.per_example_pallas_xent
    jax_fn = jax_losses.get(name)
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(
        float(port_fn(tl, tb)), float(jax_fn(jnp.asarray(logits),
                                             jnp.asarray(labels))),
        atol=1e-6)
    per = port_pk.per_example_pallas_xent(tl, tb)
    assert per.shape == (2, 5)
    np.testing.assert_allclose(
        as_np(per), as_np(jax_pk.per_example_pallas_xent(
            jnp.asarray(logits), jnp.asarray(labels))), atol=1e-6)
    np.testing.assert_allclose(
        float(port_losses.sparse_categorical_crossentropy(tl, tb)),
        float(jax_losses.sparse_categorical_crossentropy(
            jnp.asarray(logits), jnp.asarray(labels))), atol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss"):
        port_losses.get("bogus")


def test_above_the_class_ceiling_uses_the_stock_loss(caplog, monkeypatch):
    """Above MAX_FUSED_CLASSES the registry losses switch to the stock
    loss with one warning, as the JAX package's do; the fused function
    itself refuses."""
    c = port_pk.MAX_FUSED_CLASSES + 1
    logits, labels, _ = _inputs(seed=4, n=2, c=c)
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    monkeypatch.setattr(port_pk, "_warned_stock", False)
    with caplog.at_level(logging.WARNING, logger=port_pk.__name__):
        got = port_pk.pallas_sparse_categorical_crossentropy(tl, tb)
        per = port_pk.per_example_pallas_xent(tl, tb)
    warned = [r for r in caplog.records if "fused ceiling" in r.message]
    assert len(warned) == 1
    want = jax_pk.pallas_sparse_categorical_crossentropy(
        jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    np.testing.assert_allclose(
        as_np(per), as_np(port_losses._per_example_sparse_cce(tl, tb)))
    with pytest.raises(ValueError, match="at most"):
        port_pk.fused_softmax_xent(tl, tb)


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    """Dispatch is by device: a tensor on neither CPU nor CUDA raises
    rather than falling back."""
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_pk.xent_fwd(meta, torch.empty((2,), dtype=torch.int64,
                                           device="meta"))
    assert dtt.ops.pallas_kernels is port_pk


def test_first_call_imports_no_dynamo():
    """The fused loss's operator (``dtt::xent_fwd``, there for selective
    checkpointing) is a plain dispatcher operator: its first call, in a
    fresh process, imports neither ``torch._dynamo`` nor what that pulls
    in (FSDP, DTensor, sympy), which a ``torch.library.custom_op`` does
    and which made a fresh worker's first training step seconds long."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "import distributed_tpu_torch as dtt\n"
        "logits = torch.randn(6, 10, requires_grad=True)\n"
        "labels = torch.tensor([0, 1, 2, 3, 4, 9])\n"
        "loss = dtt.ops.pallas_kernels.fused_softmax_xent(logits, labels)\n"
        "loss.sum().backward()\n"
        "heavy = [m for m in ('torch._dynamo', 'torch.distributed.fsdp',\n"
        "         'torch.distributed.tensor', 'sympy') if m in sys.modules]\n"
        "print(heavy)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(
                             __import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
