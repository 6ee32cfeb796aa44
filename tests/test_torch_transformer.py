"""Port transformer_lm against the JAX package's, on carried-over weights.

Full-sequence logits in f32 and with bf16 layers, then the paged path:
``paged_prefill`` of a prompt followed by ``paged_decode`` steps on the
same block tables, in both packages, through both decode read paths of
the port. Tolerances: f32 1e-4 (two layers of differently ordered sums
feeding a 64-way head), bf16 layers 2e-2 relative to the logit scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops import paged_attention as jax_paged
from torch_parity import as_np, lm_pair

torch.set_num_threads(1)

VOCAB, BS, NB = 64, 4, 16


@pytest.fixture(scope="module")
def f32_pair():
    return lm_pair(vocab=VOCAB)


@pytest.fixture(scope="module")
def bf16_pair():
    return lm_pair(vocab=VOCAB, dtype="bfloat16")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)


@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_full_sequence_logits(which, f32_pair, bf16_pair):
    jm, pm = f32_pair if which == "f32" else bf16_pair
    x = _tokens(0, (2, 16))
    want, _ = jm.module.apply(jm.params, jm.state, jnp.asarray(x))
    with torch.inference_mode():
        got = pm.module(torch.from_numpy(x))
    assert got.dtype == (torch.float32 if which == "f32" else torch.bfloat16)
    if which == "f32":
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-4,
                                   atol=1e-4)
    else:
        scale = np.abs(as_np(want)).max()
        assert np.abs(as_np(got) - as_np(want)).max() <= 2e-2 * scale


def _jax_paged(jm, kv_dtype, prompt, steps, tables, positions0):
    """JAX: prefill slot 0's prompt, then decode both slots ``steps``
    times (slot 1 rides the trash block), returning each step's logits."""
    mod = jm.module
    caches = mod.init_paged_cache(jm.params, NB, BS, kv_dtype)
    out, caches = mod.paged_prefill(
        jm.params, jm.state, caches, jnp.asarray(prompt[None]),
        block_table=jnp.asarray(tables[0]), start=0)
    logits = [np.asarray(out[0, -1])]
    tok = np.array([int(np.argmax(logits[0])), 0], np.int32)
    pos = positions0.copy()
    for _ in range(steps):
        out, caches = mod.paged_decode(
            jm.params, jm.state, caches, jnp.asarray(tok[:, None]),
            block_tables=jnp.asarray(tables), positions=jnp.asarray(pos))
        logits.append(np.asarray(out[0, 0]))
        tok = np.array([int(np.argmax(logits[-1])), 0], np.int32)
        pos[0] += 1
    return logits


def _port_paged(pm, kv_dtype, prompt, steps, tables, positions0, kind):
    mod = pm.module
    caches = mod.init_paged_cache(NB, BS, kv_dtype, "cpu")
    with torch.inference_mode():
        out, caches = mod.paged_prefill(
            caches, torch.from_numpy(prompt[None]),
            block_table=torch.from_numpy(tables[0]), start=0)
        logits = [as_np(out[0, -1])]
        tok = np.array([int(np.argmax(logits[0])), 0], np.int32)
        pos = positions0.copy()
        for _ in range(steps):
            out, caches = mod.paged_decode(
                caches, torch.from_numpy(tok[:, None]),
                block_tables=torch.from_numpy(tables),
                positions=torch.from_numpy(pos), decode_kernel=kind)
            logits.append(as_np(out[0, 0]))
            tok = np.array([int(np.argmax(logits[-1])), 0], np.int32)
            pos[0] += 1
    return logits


@pytest.mark.parametrize("kind", ["reference", "fused"])
@pytest.mark.parametrize("kv", ["plain", "int8"])
def test_paged_prefill_then_decode(kind, kv, f32_pair):
    jm, pm = f32_pair
    prompt = _tokens(1, (9,))
    tables = np.zeros((2, 4), np.int32)
    tables[0] = [3, 7, 1, 5]  # slot 0: scattered pool blocks; slot 1: trash
    positions0 = np.array([9, 0], np.int32)
    jax_kv = jnp.int8 if kv == "int8" else jnp.float32
    port_kv = torch.int8 if kv == "int8" else torch.float32
    want = _jax_paged(jm, jax_kv, prompt, 5, tables, positions0)
    got = _port_paged(pm, port_kv, prompt, 5, tables, positions0, kind)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert jax_paged.current_decode_kernel() == jax_paged.REFERENCE
