"""The port's ``Model.generate`` and its Threefry draw against the JAX
package's.

The Threefry helpers (``utils.threefry``) must give ``jax.random``'s bits,
keys and categorical draws exactly; ``generate`` must give the JAX
``Model.generate``'s tokens exactly, greedy and sampled (``temperature``,
``top_k``, several seeds and prompt lengths), including a run whose
bucket is longer than the positional table (the exact length then). Both
models hold the same weights (``tests/torch_parity.py``), in f32 on the
CPU; the tolerance is none: every token must match.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import distributed_tpu_torch as dtt
from distributed_tpu_torch.utils import threefry

from torch_parity import lm_pair

torch.set_num_threads(1)

VOCAB = 97


@functools.lru_cache(maxsize=None)
def _pair(max_len):
    return lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                   max_len=max_len, seed=3)


@pytest.mark.parametrize("seed", [0, 1, 12345, -3, 2 ** 31 + 5])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    mine = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)), mine)
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, 5)),
                                  threefry.split(mine, 5))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, (3, 41))).astype(np.int64),
        threefry.bits(mine, (3, 41), "cpu").numpy())
    rng = np.random.default_rng(seed & 0xFF)
    logits = (3 * rng.standard_normal((6, VOCAB))).astype(np.float32)
    logits[:, ::7] = -np.inf  # masked entries, as top_k leaves them
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits)),
        threefry.categorical(mine, torch.from_numpy(logits)).numpy())


def test_row_bits_are_each_keys_bits():
    """The engine's per-row draw: row r is ``bits(keys[r], (n,))``."""
    keys = threefry.split(threefry.PRNGKey(9), 4)
    rows = threefry.row_bits(keys, 33, "cpu").numpy()
    for r in range(4):
        np.testing.assert_array_equal(
            rows[r], threefry.bits(keys[r], (33,), "cpu").numpy())


@pytest.mark.parametrize("t_p,new,temperature,top_k,seed", [
    (1, 20, 0.0, None, 0),
    (5, 30, 0.0, None, 0),
    (17, 60, 0.0, None, 0),  # 77 positions: the 128 bucket
    (5, 30, 0.8, None, 0),
    (5, 30, 0.8, None, 7),
    (9, 24, 1.3, 10, 1),
    (3, 40, 1.0, 1, 2),  # top_k 1 is greedy through the sampler
])
def test_generate_token_exact(t_p, new, temperature, top_k, seed):
    jm, pm = _pair(160)
    prompt = np.random.default_rng(t_p).integers(
        0, VOCAB, (3, t_p)).astype(np.int32)
    kw = dict(temperature=temperature, top_k=top_k, seed=seed)
    want = np.asarray(jm.generate(prompt, new, **kw))
    got = pm.generate(prompt, new, **kw)
    assert got.dtype == np.int32 and got.shape == (3, t_p + new)
    np.testing.assert_array_equal(got[:, :t_p], prompt)
    np.testing.assert_array_equal(got, want)


def test_generate_past_the_positional_table():
    """40 positions: the 64 bucket exceeds the table, so both packages
    cache exactly the requested length."""
    jm, pm = _pair(40)
    prompt = np.random.default_rng(4).integers(0, VOCAB, (2, 8)).astype(
        np.int32)
    for kw in (dict(temperature=0.0), dict(temperature=0.9, top_k=20,
                                           seed=5)):
        np.testing.assert_array_equal(
            pm.generate(prompt, 32, **kw),
            np.asarray(jm.generate(prompt, 32, **kw)))
    with pytest.raises(ValueError, match="exceeds positional table"):
        pm.generate(prompt, 33, temperature=0.0)


def test_generate_checks_its_arguments():
    _, pm = _pair(40)
    with pytest.raises(ValueError, match="batch, tokens"):
        pm.generate(np.zeros(4, np.int32), 2)
    with pytest.raises(ValueError, match="at least one token"):
        pm.generate(np.zeros((2, 0), np.int32), 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        pm.generate(np.zeros((2, 2), np.int32), 0)
    with pytest.raises(ValueError, match="top_k"):
        pm.generate(np.zeros((2, 2), np.int32), 2, top_k=0)
    with pytest.raises(RuntimeError, match="not built"):
        dtt.Model(dtt.models.transformer_lm(8, num_layers=1, d_model=8,
                                            num_heads=2, max_len=8),
                  device="cpu").generate(np.zeros((1, 1), np.int32), 1)


def test_decode_protocol_refuses_what_jax_refuses():
    """A bidirectional LM has no cached decode, and layers that mix
    positions refuse the token-wise default, as in JAX."""
    pm = dtt.Model(dtt.models.transformer_lm(
        VOCAB, num_layers=1, d_model=16, num_heads=2, max_len=16,
        causal=False), device="cpu").build((16,))
    with pytest.raises(NotImplementedError, match="causal"):
        pm.generate(np.zeros((1, 2), np.int32), 2)
    flat = dtt.nn.Flatten()
    with pytest.raises(NotImplementedError, match="decode"):
        flat.decode({}, torch.zeros(1, 1, 4), pos=0)


def test_generate_follows_the_live_weights():
    """generate reads the model's parameters as they are: after a fit
    step they give other tokens than before, and JAX's after the same
    step agree."""
    jm, pm = lm_pair(vocab=VOCAB, num_layers=1, d_model=16, num_heads=2,
                     max_len=64, seed=4)
    prompt = np.random.default_rng(0).integers(0, VOCAB, (2, 4)).astype(
        np.int32)
    before = pm.generate(prompt, 12, temperature=0.0)
    tok = np.random.default_rng(1).integers(0, VOCAB, (4, 17))
    x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
    for m in (jm, pm):
        m.compile(optimizer="sgd", learning_rate=0.5,
                  loss="sparse_categorical_crossentropy")
        m.fit(x, y, batch_size=4, epochs=1, shuffle=False, verbose=0)
    after = pm.generate(prompt, 12, temperature=0.0)
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(
        after, np.asarray(jm.generate(prompt, 12, temperature=0.0)))
