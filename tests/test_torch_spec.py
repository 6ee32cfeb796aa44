"""Port speculative decoding against the JAX engine's, token for token.

Both engines serve the same requests from the same f32 weights (carried
over with ``interop.params_from_jax``) with a draft model and ``spec_k``:
the tokens must be identical and the logprobs agree to atol 1e-5 (both
sides compute them in f32; the port's verify and the JAX verify sum in
different orders), for each of the port's decode read paths against each
of the JAX engine's. The ``speculative`` telemetry block must equal the
JAX engine's key for key and count for count; the port's speculative
tokens must equal its own plain engine's (speculation is a throughput
lever, never a correctness one). The JAX side's fused path runs its
Pallas kernel in interpret mode, as its own tests run it. The JAX engines
come from ``torch_parity.jax_engine``, which hands their prefill
dispatches a copy of the block-table row (a host race of the JAX engine
otherwise makes its acceptance counts vary from run to run).
"""

import numpy as np
import pytest
import torch

from distributed_tpu.serving import Engine as JaxEngine
from distributed_tpu.serving import Request as JaxRequest
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.serving.engine import SPEC_K_LADDER
from torch_parity import jax_engine, lm_pair

torch.set_num_threads(1)

VOCAB = 64
KINDS = ("reference", "fused")
ENGINE = dict(max_slots=2, block_size=4, max_len=64)


@pytest.fixture(scope="module")
def pair():
    return lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                   max_len=64)


@pytest.fixture(scope="module")
def cold():
    """A 1-layer draft on its own random weights: it rarely agrees."""
    return lm_pair(vocab=VOCAB, num_layers=1, d_model=32, num_heads=2,
                   max_len=64, seed=5)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX engine results per (config, kind), memoized across tests."""
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
    # name: (request kwargs, draft ("self" | "cold"), engine kwargs,
    #        request seeds pinned, telemetry key that must be > 0)
    "self_k3": (dict(seed=20, n=4), "self", dict(spec_k=3), False, None),
    "cold_k3": (dict(seed=21, n=4), "cold", dict(spec_k=3), False, None),
    "self_k12": (dict(seed=22, n=4, m_range=(10, 16)), "self",
                 dict(spec_k=12), False, None),
    "sampled": (dict(seed=23, n=4), "cold",
                dict(spec_k=3, temperature=1.0, top_k=8), True, None),
    "preemption": (dict(seed=24, n=4, p_range=(16, 30), m_range=(6, 10)),
                   "self", dict(spec_k=3, num_blocks=14), False,
                   "preemptions"),
    "int8_kv": (dict(seed=25, n=4), "self",
                dict(spec_k=3, kv_dtype="int8"), False, None),
    "prefix_cache": (dict(seed=26, n=4, p_range=(1, 5),
                          common=np.arange(8, dtype=np.int32) * 5 % VOCAB),
                     "self", dict(spec_k=3, prefix_cache=True), False, None),
}


def _reqs(cls, config):
    req_kw, _, _, pinned, _ = CONFIGS[config]
    prompts, news = _requests(**req_kw)
    return [cls(p, m, seed=100 + i) if pinned else cls(p, m)
            for i, (p, m) in enumerate(zip(prompts, news))]


def _draft(config, pair, cold, side):
    which = CONFIGS[config][1]
    return (pair if which == "self" else cold)[side]


def _jax_run(pair, cold, jax_runs, config, kind):
    key = (config, kind)
    if key not in jax_runs:
        eng = jax_engine(pair[0], decode_kernel=kind,
                         draft_model=_draft(config, pair, cold, 0),
                         **ENGINE, **CONFIGS[config][2])
        outs = eng.run(_reqs(JaxRequest, config), return_logprobs=True)
        jax_runs[key] = ([np.asarray(o) for o in outs],
                         eng.last_run_telemetry)
    return jax_runs[key]


def _port_run(pair, cold, config, kind, draft=True):
    kw = dict(CONFIGS[config][2])
    if not draft:
        kw.pop("spec_k")
    eng = Engine(pair[1], decode_kernel=kind,
                 draft_model=_draft(config, pair, cold, 1) if draft else None,
                 **ENGINE, **kw)
    outs = eng.run(_reqs(Request, config), return_logprobs=True)
    return outs, eng.last_run_telemetry


@pytest.mark.parametrize("port_kind", KINDS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_spec_engine_token_exact_vs_jax(pair, cold, jax_runs, config,
                                        port_kind):
    got, tel = _port_run(pair, cold, config, port_kind)
    must_fire = CONFIGS[config][4]
    if must_fire:
        assert tel[must_fire] > 0, f"{config}: {must_fire} never happened"
    if config == "prefix_cache":
        assert tel["prefix_cache"]["hit_blocks"] > 0
    spec = tel["speculative"]
    assert spec["rounds"] > 0
    for jax_kind in KINDS:
        want, jtel = _jax_run(pair, cold, jax_runs, config, jax_kind)
        for i, (w, g) in enumerate(zip(want, got)):
            assert np.array_equal(w, g), (
                f"{config} request {i}: port[{port_kind}] {list(g)} != "
                f"jax[{jax_kind}] {list(w)}")
        for i, (wr, gr) in enumerate(zip(jtel["requests"], tel["requests"])):
            np.testing.assert_allclose(
                gr["logprobs"], wr["logprobs"], rtol=0, atol=1e-5,
                err_msg=f"{config} request {i} logprobs")
            assert gr["weights_versions"] == wr["weights_versions"]
            for key in ("spec_tokens", "spec_proposed", "accept_rate"):
                assert gr[key] == wr[key], (config, i, key)
        assert spec == jtel["speculative"], (config, jax_kind)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_port_spec_tokens_equal_port_plain_decode(pair, cold, config):
    """Speculation never changes a token: the port's speculative engine
    against its own engine without a draft (fused reads)."""
    spec, tel = _port_run(pair, cold, config, "fused")
    plain, _ = _port_run(pair, cold, config, "fused", draft=False)
    for i, (a, b) in enumerate(zip(spec, plain)):
        assert np.array_equal(a, b), f"{config} request {i}"
    for ra, rb in zip(tel["requests"], _port_run(
            pair, cold, config, "reference", draft=False)[1]["requests"]):
        np.testing.assert_allclose(ra["logprobs"], rb["logprobs"], rtol=0,
                                   atol=1e-5)


def test_self_draft_pays_and_cold_draft_does_not(pair, cold):
    _, self_tel = _port_run(pair, cold, "self_k3", "fused")
    _, cold_tel = _port_run(pair, cold, "cold_k3", "fused")
    assert self_tel["speculative"]["tokens_per_dispatch"] > 1.5
    assert (cold_tel["speculative"]["accept_rate"]
            < self_tel["speculative"]["accept_rate"])


def _adaptive(make_engine, req_cls, target, draft):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, (int(t),)).astype(np.int32)
               for t in rng.integers(2, 10, 4)]
    eng = make_engine(target, draft_model=draft, spec_k="adaptive", **ENGINE)
    outs = eng.run([req_cls(p, 24, seed=11 + i)
                    for i, p in enumerate(prompts)],
                   tenants=["a", "a", "b", "b"])
    return [np.asarray(o) for o in outs], eng.last_run_telemetry, prompts


def test_adaptive_k_matches_jax_and_shuts_off_a_hopeless_draft(pair, cold):
    """A cold draft earns accept ~0: each tenant's EMA walks its rung
    down to k=0 (plain decode), with the same tenant_k, adjustments and
    counts as the JAX engine, and the stream stays plain decode's."""
    want, jtel, prompts = _adaptive(jax_engine, JaxRequest, pair[0], cold[0])
    got, tel, _ = _adaptive(Engine, Request, pair[1], cold[1])
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    spec = tel["speculative"]
    assert spec == jtel["speculative"]
    assert spec["k"] == "adaptive" and spec["max_k"] == SPEC_K_LADDER[-1]
    assert spec["tenant_k"] == {"a": 0, "b": 0}
    assert spec["k_adjustments"] >= 2
    plain = Engine(pair[1], **ENGINE).run(
        [Request(p, 24, seed=11 + i) for i, p in enumerate(prompts)])
    for a, b in zip(got, plain):
        assert np.array_equal(a, b)


def test_adaptive_k_with_a_self_draft_matches_jax(pair):
    want, jtel, _ = _adaptive(jax_engine, JaxRequest, pair[0], pair[0])
    got, tel, _ = _adaptive(Engine, Request, pair[1], pair[1])
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert tel["speculative"] == jtel["speculative"]
    assert tel["speculative"]["tenant_k"]["a"] > 0


@pytest.mark.parametrize("case", ["spec_k_1", "spec_k_str", "headroom",
                                  "tenants"])
def test_spec_checks_raise_as_jax(pair, cold, case):
    """The constructor's spec_k checks and run's headroom and tenants
    checks raise the same error class with the same words as JAX's."""
    def attempt(engine_cls, req_cls, target, draft):
        if case == "spec_k_1":
            engine_cls(target, draft_model=draft, spec_k=1, **ENGINE)
        elif case == "spec_k_str":
            engine_cls(target, draft_model=draft, spec_k="bogus", **ENGINE)
        else:
            eng = engine_cls(target, draft_model=draft, spec_k=4, **ENGINE)
            if case == "headroom":
                # 50 + 12 fits max_len 64 but not its 3 rows of headroom.
                eng.run([req_cls(np.zeros(50, np.int32), 12)])
            else:
                eng.run([req_cls(np.zeros(4, np.int32), 2)], tenants=["a", "b"])

    match = {"spec_k_1": "spec_k must be >= 2", "spec_k_str": "spec_k must be",
             "headroom": "speculative headroom spec_k-1=3",
             "tenants": "tenants covers"}[case]
    with pytest.raises(ValueError, match=match):
        attempt(JaxEngine, JaxRequest, pair[0], cold[0])
    with pytest.raises(ValueError, match=match):
        attempt(Engine, Request, pair[1], cold[1])


def test_spec_verify_launches_the_paged_read_once_per_layer(pair, cold,
                                                            monkeypatch):
    """Under "fused" every draft decode and every verify reads the pools
    through ops.paged_attention, the verify with spec_k query rows a slot
    (on the CPU the plain version stands in and no launch is counted)."""
    from distributed_tpu_torch.ops import paged_attention as paged_ops

    widths = []
    real = paged_ops.paged_attention

    def spy(q, *args):
        widths.append(q.shape[1])
        return real(q, *args)

    monkeypatch.setattr(paged_ops, "paged_attention", spy)
    _, tel = _port_run(pair, cold, "self_k12", "fused")
    rounds = tel["speculative"]["rounds"]
    assert rounds == tel["decode_steps"] > 0
    # Each round: the 2-layer self-draft's 11 decodes at kw 1, then the
    # 2-layer target's verify at kw 12.
    assert widths.count(12) == 2 * rounds
    assert widths.count(1) == 2 * 11 * rounds
    assert len(widths) == 2 * 12 * rounds
