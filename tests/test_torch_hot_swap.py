"""Port weight hot-swap against the JAX engine's.

The engine serves a snapshot of the model's weights taken when it was
built, and only ``update_weights`` changes it: loading new weights into
the model, or stepping its parameters in place, after the engine was
built must leave the served tokens alone, as in the JAX engine (whose
``_params`` snapshot is immutable). A swap mid-run through
``on_decode_step`` records the version boundary per token, exactly as the
JAX engine's ``weights_versions`` spans do; mismatched trees raise
``ValueError``; the draft arm tracks staleness and emits ``draft_sync``;
a swap flushes the prefix store and stays token-exact. Both engines swap
to the same weights (the port's tree from ``interop.params_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu_torch as dtt
from distributed_tpu.serving import Engine as JaxEngine
from distributed_tpu.serving import Request as JaxRequest
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.utils import event_schema as evs
from distributed_tpu_torch.utils.events import read_events
from torch_parity import lm_pair

torch.set_num_threads(1)

VOCAB = 64
ENGINE = dict(block_size=4, max_len=64)


@pytest.fixture(scope="module")
def pair():
    return lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                   max_len=64)


def _requests(seed, n, p_range=(2, 10), m_range=(6, 12)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, (int(t),)).astype(np.int32)
               for t in rng.integers(*p_range, n)]
    return prompts, [int(m) for m in rng.integers(*m_range, n)]


def _bumped(jax_params, by):
    """The same tree moved by ``by`` in both packages' forms."""
    new = jax.tree_util.tree_map(lambda a: a + by * jnp.ones_like(a),
                                 jax_params)
    return new, dtt.interop.params_from_jax(jax.device_get(new))


def _serve(engine, req_cls, prompts, news, **kw):
    return [np.asarray(o) for o in engine.run(
        [req_cls(p, m) for p, m in zip(prompts, news)], **kw)]


@pytest.mark.parametrize("change", ["load_params", "in_place_step"])
def test_engine_serves_its_snapshot_not_the_live_model(pair, change):
    """Build both engines, then change both models' weights: both engines
    go on serving the weights they were built with (the JAX engine's
    snapshot contract, which the port broke by serving the live module)."""
    jm, _ = pair
    pm = dtt.Model(dtt.models.transformer_lm(
        VOCAB, num_layers=2, d_model=32, num_heads=2, max_len=64),
        device="cpu").build((16,))
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    prompts, news = _requests(seed=1, n=3)
    jeng = JaxEngine(jm, max_slots=2, **ENGINE)
    peng = Engine(pm, max_slots=2, **ENGINE)
    before = _serve(peng, Request, prompts, news)
    old = jm.params
    new_jax, new_port = _bumped(jm.params, 0.05)
    try:
        jm.params = new_jax
        if change == "load_params":
            pm.load_params(new_port)
        else:  # what an optimizer step does: the parameters move in place
            with torch.no_grad():
                for path, p in pm.params.items():
                    p.copy_(new_port[path])
        want = _serve(jeng, JaxRequest, prompts, news)
        got = _serve(peng, Request, prompts, news)
        fresh = _serve(Engine(pm, max_slots=2, **ENGINE), Request, prompts,
                       news)
    finally:
        jm.params = old
    for i, (w, g, b) in enumerate(zip(want, got, before)):
        assert np.array_equal(g, b), f"request {i}: the engine served the " \
                                     "model's new weights"
        assert np.array_equal(w, g), f"request {i}: port != JAX"
    assert any(not np.array_equal(f, b) for f, b in zip(fresh, before)), \
        "the new weights serve the same tokens: the test cannot tell"


def test_update_weights_mid_run_records_the_same_version_spans(pair):
    """A swap to value-identical weights at decode step 3 leaves the
    tokens equal to the unswapped run and splits the request's
    weights_versions at the same token as JAX's; a swap to new weights at
    step 2 gives JAX's tokens and spans, and the new weights stick."""
    jm, pm = pair
    prompts, news = _requests(seed=4, n=1, p_range=(4, 5), m_range=(8, 9))
    jeng = JaxEngine(jm, max_slots=1, **ENGINE)
    peng = Engine(pm, max_slots=1, **ENGINE)
    base = _serve(peng, Request, prompts, news)[0]
    same_jax = jax.tree_util.tree_map(lambda a: a, jm.params)
    same_port = {k: v.clone() for k, v in pm.params.items()}

    def swap_at(step, jax_tree, port_tree):
        def hook(eng, decode_step):
            if decode_step == step:
                eng.update_weights(jax_tree if isinstance(eng, JaxEngine)
                                   else port_tree)
        return hook

    hook = swap_at(3, same_jax, same_port)
    want = _serve(jeng, JaxRequest, prompts, news, on_decode_step=hook)[0]
    got = _serve(peng, Request, prompts, news, on_decode_step=hook)[0]
    assert np.array_equal(got, base) and np.array_equal(got, want)
    row = peng.last_run_telemetry["requests"][0]
    assert row["weights_versions"] == [
        {"version": 0, "tokens": 4}, {"version": 1, "tokens": news[0] - 4}]
    assert row["weights_versions"] == \
        jeng.last_run_telemetry["requests"][0]["weights_versions"]
    assert peng.last_run_telemetry["weight_swaps"] == 1
    assert peng.weights_version == jeng.weights_version == 1
    assert peng.kv.live_blocks == 0

    new_jax, new_port = _bumped(jm.params, 0.05)
    hook = swap_at(2, new_jax, new_port)
    want = _serve(jeng, JaxRequest, prompts, news, on_decode_step=hook)[0]
    got = _serve(peng, Request, prompts, news, on_decode_step=hook)[0]
    assert np.array_equal(got, want)
    assert peng.last_run_telemetry["requests"][0]["weights_versions"] == \
        jeng.last_run_telemetry["requests"][0]["weights_versions"]
    assert peng.weights_version == 2
    after = _serve(peng, Request, prompts, news)[0]
    assert np.array_equal(after, _serve(jeng, JaxRequest, prompts, news)[0])
    assert peng.last_run_telemetry["requests"][0]["weights_versions"] == [
        {"version": 2, "tokens": news[0]}]
    assert not np.array_equal(after, base)  # the new weights really serve


@pytest.mark.parametrize("case", ["path", "shape", "dtype"])
def test_update_weights_rejects_a_mismatched_tree(pair, case):
    _, pm = pair
    engine = Engine(pm, max_slots=1, **ENGINE)
    tree = {k: v.clone() for k, v in pm.params.items()}
    name = sorted(tree)[3]
    if case == "path":
        tree["bogus/kernel"] = tree.pop(name)
        match = "structure.*bogus/kernel"
    elif case == "shape":
        tree[name] = torch.zeros(tree[name].shape + (1,))
        match = f"shape mismatch at {name}"
    else:
        tree[name] = tree[name].to(torch.float16)
        match = f"dtype mismatch at {name}"
    with pytest.raises(ValueError, match=match):
        engine.update_weights(tree)
    assert engine.weights_version == 0  # a failed swap changes nothing
    with pytest.raises(ValueError, match="pass params"):
        engine.update_weights()


def test_update_weights_draft_arm_staleness_and_event(pair, tmp_path,
                                                      monkeypatch):
    """Target-only swaps age the draft; a draft sync resets the staleness
    and emits ``draft_sync`` with how stale the draft had grown, a record
    the port's event schema accepts. Both engines count alike."""
    jm, pm = pair
    monkeypatch.setenv("DTPU_EVENT_LOG", str(tmp_path / "ev.jsonl"))
    draft = lm_pair(vocab=VOCAB, num_layers=1, d_model=32, num_heads=2,
                    max_len=64, seed=5)
    jeng = JaxEngine(jm, max_slots=2, draft_model=draft[0], spec_k=2,
                     **ENGINE)
    peng = Engine(pm, max_slots=2, draft_model=draft[1], spec_k=2, **ENGINE)
    same = {k: v.clone() for k, v in pm.params.items()}
    for eng, tree, dtree in ((jeng, jm.params, draft[0].params),
                             (peng, same, draft[1].params)):
        assert eng.update_weights(tree) == 1 and eng._draft_staleness == 1
        assert eng.update_weights(tree) == 2 and eng._draft_staleness == 2
        assert eng.update_weights(draft_params=dtree) == 2
        assert eng._draft_staleness == 0 and eng._draft_version == 2
    events = [e for e in read_events(tmp_path / "ev.jsonl")
              if e["event"] == evs.DRAFT_SYNC]
    assert len(events) == 2  # one from each engine
    for e in events:
        assert e["staleness"] == 2 and e["weights_version"] == 2
        assert evs.check(e) == []
    prompts, news = _requests(seed=6, n=2)
    _serve(peng, Request, prompts, news)
    _serve(jeng, JaxRequest, prompts, news)
    assert (peng.last_run_telemetry["speculative"]["draft_version"]
            == jeng.last_run_telemetry["speculative"]["draft_version"] == 2)
    with pytest.raises(ValueError, match="no draft"):
        Engine(pm, max_slots=2, **ENGINE).update_weights(
            draft_params=draft[1].params)


def test_spec_swap_flushes_the_prefix_store_and_stays_exact(pair):
    """A swap between runs flushes the prefix store (blocks cached under
    old weights must not seed new requests), and the speculating engine's
    output after it equals a fresh engine's on the new weights, and the
    JAX engine's after the same swap, though the draft still runs the old
    weights."""
    jm, pm = pair
    rng = np.random.default_rng(9)
    shared = rng.integers(0, VOCAB, (8,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, (int(t),))
                               .astype(np.int32)])
               for t in rng.integers(1, 5, 3)]
    news = [int(m) for m in rng.integers(4, 9, 3)]
    jeng = JaxEngine(jm, max_slots=2, prefix_cache=True, draft_model=jm,
                     spec_k=3, **ENGINE)
    peng = Engine(pm, max_slots=2, prefix_cache=True, draft_model=pm,
                  spec_k=3, **ENGINE)
    for eng, cls in ((jeng, JaxRequest), (peng, Request)):
        _serve(eng, cls, prompts, news)
        assert len(eng.kv.prefix) > 0
    new_jax = jax.tree_util.tree_map(lambda x: x * 1.05, jm.params)
    new_port = dtt.interop.params_from_jax(jax.device_get(new_jax))
    jeng.update_weights(new_jax)
    peng.update_weights(new_port)
    assert len(peng.kv.prefix) == len(jeng.kv.prefix) == 0
    got = _serve(peng, Request, prompts, news)
    want = _serve(jeng, JaxRequest, prompts, news)
    fresh_model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, num_layers=2, d_model=32, num_heads=2, max_len=64),
        device="cpu").build((16,))
    fresh_model.load_params(new_port)
    fresh = _serve(Engine(fresh_model, max_slots=2, **ENGINE), Request,
                   prompts, news)
    for i, (g, w, f) in enumerate(zip(got, want, fresh)):
        assert np.array_equal(g, w), f"request {i}: port != JAX"
        assert np.array_equal(g, f), f"request {i}: != a fresh engine"
    assert peng.last_run_telemetry["speculative"]["draft_staleness"] == 1
