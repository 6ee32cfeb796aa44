"""Port serving Engine against the JAX Engine, token for token.

Both engines serve the same requests from the same f32 weights (carried
over with ``interop.params_from_jax``), greedy, and must return identical
tokens: under batch churn (more requests than slots), chunked prefill,
preemption under a reduced pool, prefix caching and int8 KV, for each of
the port's decode read paths against each of the JAX engine's.
"""

import numpy as np
import pytest
import torch

from distributed_tpu.serving import Engine as JaxEngine
from distributed_tpu.serving import Request as JaxRequest
from distributed_tpu.serving import engine as jax_engine
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.serving import engine as port_engine
from torch_parity import lm_pair

torch.set_num_threads(1)

VOCAB = 64
KINDS = ("reference", "fused")


@pytest.fixture(scope="module")
def pair():
    return lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                   max_len=64)


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX Engine outputs per (config, kind), memoized across tests."""
    return {}


def _requests(seed, n, p_range=(1, 12), m_range=(3, 10), common=None):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, (int(t),)).astype(np.int32)
               for t in rng.integers(*p_range, n)]
    if common is not None:
        prompts = [np.concatenate([common, p]) for p in prompts]
    news = [int(m) for m in rng.integers(*m_range, n)]
    return prompts, news


CONFIGS = {
    # name: (request kwargs, engine kwargs, telemetry key that must be > 0)
    "churn": (dict(seed=0, n=6), {}, None),
    "chunked_prefill": (dict(seed=1, n=4, p_range=(10, 24)),
                        dict(prefill_chunk=5), None),
    "preemption": (dict(seed=2, n=4, m_range=(6, 10)), dict(num_blocks=5),
                   "preemptions"),
    "prefix_cache": (dict(seed=4, n=4, p_range=(1, 5),
                          common=np.arange(8, dtype=np.int32) * 3 % VOCAB),
                     dict(prefix_cache=True), None),
    "int8_kv": (dict(seed=5, n=5), dict(kv_dtype="int8"), None),
}


def _jax_run(pair, jax_outputs, config, kind):
    key = (config, kind)
    if key not in jax_outputs:
        req_kw, eng_kw, _ = CONFIGS[config]
        prompts, news = _requests(**req_kw)
        eng = JaxEngine(pair[0], max_slots=2, block_size=4, max_len=64,
                        decode_kernel=kind, **eng_kw)
        jax_outputs[key] = eng.run(
            [JaxRequest(p, m) for p, m in zip(prompts, news)])
    return jax_outputs[key]


@pytest.mark.parametrize("port_kind", KINDS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_token_exact_vs_jax(pair, jax_outputs, config, port_kind):
    req_kw, eng_kw, must_fire = CONFIGS[config]
    prompts, news = _requests(**req_kw)
    eng = Engine(pair[1], max_slots=2, block_size=4, max_len=64,
                 decode_kernel=port_kind, **eng_kw)
    got = eng.run([Request(p, m) for p, m in zip(prompts, news)])
    tel = eng.last_run_telemetry
    assert tel["generated_tokens"] == sum(news)
    if must_fire:
        assert tel[must_fire] > 0, f"{config}: {must_fire} never happened"
    if config == "prefix_cache":
        assert tel["prefix_cache"]["hit_blocks"] > 0
    for jax_kind in KINDS:
        want = _jax_run(pair, jax_outputs, config, jax_kind)
        for i, (w, g) in enumerate(zip(want, got)):
            assert np.array_equal(np.asarray(w), g), (
                f"{config} request {i}: port[{port_kind}] {list(g)} != "
                f"jax[{jax_kind}] {list(np.asarray(w))}")


def test_token_key_and_seed_mix_bit_equal_to_jax():
    for engine_seed, request_seed in [(0, 0), (7, 123456789), (2**40, 3)]:
        a = port_engine._mix_seed(engine_seed, request_seed)
        assert a == jax_engine._mix_seed(engine_seed, request_seed)
        for index in (0, 1, 17, 10**6):
            np.testing.assert_array_equal(
                port_engine._token_key(a, index),
                jax_engine._token_key(a, index))


def test_sampled_decode_deterministic_per_request_across_slots(pair):
    """temperature > 0: a request's tokens depend only on (engine seed,
    request seed, token index) — not on max_slots or batch mates."""
    prompts, news = _requests(seed=6, n=5)

    def serve(max_slots):
        eng = Engine(pair[1], max_slots=max_slots, block_size=4, max_len=64,
                     temperature=0.8, top_k=20, seed=3)
        return eng.run([Request(p, m, seed=100 + i)
                        for i, (p, m) in enumerate(zip(prompts, news))])

    one, three = serve(1), serve(3)
    for a, b in zip(one, three):
        np.testing.assert_array_equal(a, b)
    again = serve(3)
    for a, b in zip(three, again):
        np.testing.assert_array_equal(a, b)


def test_engine_logprobs_and_validation(pair):
    prompts, news = _requests(seed=8, n=3)
    eng = Engine(pair[1], max_slots=2, block_size=4, max_len=64)
    eng.run([Request(p, m) for p, m in zip(prompts, news)],
            return_logprobs=True)
    for row, m in zip(eng.last_run_telemetry["requests"], news):
        assert len(row["logprobs"]) == m
        assert all(lp <= 0.0 for lp in row["logprobs"])
    with pytest.raises(ValueError, match="decode_kernel"):
        Engine(pair[1], max_slots=2, block_size=4, max_len=64,
               decode_kernel="bogus")
    with pytest.raises(ValueError, match="max_len"):
        eng.run([Request(np.zeros(60, np.int32), 10)])
    with pytest.raises(ValueError, match="positional"):
        Engine(pair[1], max_slots=2, block_size=4, max_len=128)
