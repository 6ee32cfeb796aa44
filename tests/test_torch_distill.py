"""Draft distillation in the port (``rl.DraftDistiller``) against JAX's.

The target (2 layers, d 16, vocab 32) is trained in JAX first, so its
greedy argmax is decisive (an untrained tiny LM's logits near-tie), and
carried into the port; the 1-layer draft starts from the same JAX-built
parameters in both packages. Then, in both packages from the same state:

- ``pack_distill``: the JAX arrays byte for byte; ``distill_loss``
  returns ``(sum, count)`` whose ratio and gradient are JAX's (rtol 1e-5).
- ``DraftDistiller.fit(rounds=2)`` on a greedy speculative engine: the
  teacher rollouts of both rounds token-exact, the loss rows within 1e-5
  (the teacher logprobs agree to a few f32 ulps), every round synced.
- After distillation, the speculative engines' tokens equal JAX's (and
  plain greedy decode's) and their acceptance counts equal JAX's.
- The draft arm's staleness and the ``draft_sync`` event: the JAX
  engine's sequence for the same calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu import rl as jrl
from distributed_tpu_torch import rl
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.utils import event_schema as evs
from distributed_tpu_torch.utils.events import read_events
from torch_parity import jax_engine, port_model

torch.set_num_threads(1)

VOCAB = 32
ENGINE = dict(max_slots=4, block_size=16, max_len=64)
LM = dict(d_model=16, num_heads=2, max_len=64)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jm = dtpu.Model(dtpu.models.transformer_lm(VOCAB, num_layers=2, **LM))
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jm.build((16,))
    xs = rng.integers(0, VOCAB, size=(32, 16)).astype(np.int32)
    jm.fit(xs, np.roll(xs, -1, axis=1), batch_size=32, epochs=25, verbose=0)
    pm = port_model(dtt.models.transformer_lm(VOCAB, num_layers=2, **LM),
                    (16,), jm.params)
    return jm, pm


def _drafts():
    jd = dtpu.Model(dtpu.models.transformer_lm(VOCAB, num_layers=1, **LM))
    jd.build((16,))
    pd = port_model(dtt.models.transformer_lm(VOCAB, num_layers=1, **LM),
                    (16,), jd.params)
    return jd, pd


def _prompts(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (int(rng.integers(4, 12)),))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_distill_and_loss_equal_jax(seed):
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(4):
        plen = int(rng.integers(1, 6))
        gen = int(rng.integers(0, 10))
        specs.append((rng.integers(0, VOCAB, plen + gen), plen,
                      rng.normal(-1.0, 0.5, gen)))
    jx, jy = jrl.pack_distill(
        [jrl.Rollout(t, p, lp) for t, p, lp in specs], 16)
    px, py = rl.pack_distill([rl.Rollout(t, p, lp) for t, p, lp in specs],
                             16)
    assert px.tobytes() == jx.tobytes() and py.tobytes() == jy.tobytes()
    logits = rng.standard_normal(jy.shape[:2] + (VOCAB,)).astype(np.float32)
    want, wgrad = jax.value_and_grad(jrl.distill_loss())(
        jnp.asarray(logits), jnp.asarray(jy))
    t = torch.from_numpy(logits).requires_grad_(True)
    total, count = rl.distill_loss()(t, torch.from_numpy(py))
    got = total / torch.clamp_min(count, 1.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-9)


def _recording(engine, outs):
    run = engine.run

    def wrapped(reqs, **kw):
        got = run(reqs, **kw)
        outs.append([np.asarray(o) for o in got])
        return got

    engine.run = wrapped
    return engine


@pytest.fixture(scope="module")
def distilled(models):
    jm, pm = models
    jd, pd = _drafts()
    jouts, pouts = [], []
    jeng = _recording(jax_engine(jm, draft_model=jd, spec_k=4, **ENGINE),
                      jouts)
    peng = _recording(Engine(pm, draft_model=pd, spec_k=4, **ENGINE), pouts)
    jdist = jrl.DraftDistiller(jeng, jd, learning_rate=5e-2)
    pdist = rl.DraftDistiller(peng, pd, learning_rate=5e-2)
    kw = dict(max_new_tokens=20, epochs=8, rounds=2, num_samples=3)
    jrows = jdist.fit(_prompts(), **kw)
    prows = pdist.fit(_prompts(), **kw)
    return dict(jrows=jrows, prows=prows, jouts=jouts, pouts=pouts,
                jeng=jeng, peng=peng, jd=jd, pd=pd)


def test_distiller_teacher_rollouts_token_exact(distilled):
    assert len(distilled["pouts"]) == 2
    for jr, pr in zip(distilled["jouts"], distilled["pouts"]):
        assert len(jr) == len(pr) == 6  # greedy engine: num_samples -> 1
        for a, b in zip(jr, pr):
            np.testing.assert_array_equal(b, a)


def test_distiller_loss_rows(distilled):
    for j, p in zip(distilled["jrows"], distilled["prows"]):
        assert set(p) == set(j)
        for key in ("round", "num_rollouts", "epochs"):
            assert p[key] == j[key]
        np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5,
                                   atol=1e-6)
        assert p["loss_last"] < p["loss_first"]


def test_distilled_engine_tokens_and_acceptance_equal_jax(distilled, models):
    jm, pm = models
    prompts = _prompts(seed=2, n=8)

    def run(engine, req_cls):
        reqs = [req_cls(p, 16, seed=7 + i) for i, p in enumerate(prompts)]
        outs = [np.asarray(o) for o in engine.run(reqs)]
        return outs, engine.last_run_telemetry

    from distributed_tpu.serving import Request as JaxRequest

    jout, jtel = run(distilled["jeng"], JaxRequest)
    pout, ptel = run(distilled["peng"], Request)
    plain, _ = run(Engine(pm, **ENGINE), Request)
    for a, b, c in zip(jout, pout, plain):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
    for key in ("accepted", "proposed", "rounds"):
        assert ptel["speculative"][key] == jtel["speculative"][key], key
    assert (ptel["speculative"]["draft_staleness"]
            == jtel["speculative"]["draft_staleness"] == 0)


def test_draft_staleness_and_sync_event_match_jax(models, tmp_path,
                                                  monkeypatch):
    jm, pm = models
    jd, pd = _drafts()
    logs = {}
    for pkg in ("jax", "port"):
        logs[pkg] = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("DTPU_EVENT_LOG", str(logs[pkg]))
        if pkg == "jax":
            eng = jax_engine(jm, draft_model=jd, spec_k=2, max_slots=2,
                             block_size=16, max_len=64)
            same = jax.tree_util.tree_map(lambda x: x, jm.params)
            draft = jd.params
        else:
            eng = Engine(pm, draft_model=pd, spec_k=2, max_slots=2,
                         block_size=16, max_len=64)
            same = {k: v.clone() for k, v in pm.params.items()}
            draft = pd.params
        seen = [eng.update_weights(same), eng._draft_staleness,
                eng.update_weights(same), eng._draft_staleness,
                eng.update_weights(draft_params=draft),
                eng._draft_staleness, eng._draft_version]
        logs[pkg] = (seen, [
            {k: e[k] for k in ("weights_version", "staleness", "source")}
            for e in read_events(logs[pkg]) if e["event"] == evs.DRAFT_SYNC])
        with pytest.raises(ValueError, match="params"):
            eng.update_weights()
    assert logs["port"] == logs["jax"]
    assert logs["port"][0] == [1, 1, 2, 2, 2, 0, 2]


def test_distiller_without_a_draft_engine_does_not_sync(models):
    _, pm = models
    _, pd = _drafts()
    eng = Engine(pm, **ENGINE)
    dist = rl.DraftDistiller(eng, pd, learning_rate=5e-2)
    rows = dist.fit(_prompts(n=2), max_new_tokens=4, epochs=1, rounds=1)
    assert rows[0]["round"] == 1 and eng.weights_version == 0
    with pytest.raises(ValueError, match="no draft model"):
        dist.sync()
    unbuilt = dtt.Model(dtt.models.transformer_lm(VOCAB, num_layers=1, **LM),
                        device="cpu")
    with pytest.raises(RuntimeError, match="Build the draft model"):
        rl.DraftDistiller(eng, unbuilt)
