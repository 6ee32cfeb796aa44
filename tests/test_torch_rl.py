"""Online post-training in the port (``rl``) against the JAX package's.

- ``pack_rollouts``: the JAX arrays byte for byte, and the same errors.
- ``rl_loss`` (REINFORCE and PPO-clip) returns ``(sum, count)``; the
  ratio and its gradient with respect to the logits are JAX's within
  rtol 1e-5, with pad positions carrying +-1e30 rollout logprobs (masked
  inside the exponentials, so no NaN).
- ``rewards``, ``optim.EmaBaseline`` and ``optim.AdaptiveKLCoef``: the
  same values and sequences.
- ``PostTrainer`` on a 2-layer f32 LM (vocab 64, d 32), 2 iterations
  against the JAX loop from the same parameters and seeds: iteration 1's
  rollouts token-exact, the rewards equal, the losses and the measured
  KL within 1e-5. Parameters: atol 1e-5 on every entry whose gradient
  was at least 1e-7 (ten times Adam's eps) in every step, as in
  ``test_torch_training.py``; the rest are held to Adam's own bound,
  ``2 * lr`` a step (Adam turns a rounding-level gradient into a step of
  up to ``lr`` on each side).
- ``PostTrainer`` on 2 gloo ranks under ``DataParallel`` with
  ``grad_accum=2`` against JAX's ``DataParallel`` over 2 devices, its
  parameters held the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu import rl as jrl
from distributed_tpu.serving import Engine as JaxEngine
from distributed_tpu_torch import rl
from distributed_tpu_torch.serving import Engine
from torch_parity import WORKER_PRELUDE, jax_engine, lm_pair, run_pair

torch.set_num_threads(1)

VOCAB = 64
LR = 1e-3
ENGINE = dict(max_slots=4, block_size=8, max_len=64, temperature=1.0,
              seed=3)


def _rollouts(seed=0, n=5, L=24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(1, 8))
        gen = int(rng.integers(0, L - plen + 1))
        toks = rng.integers(0, VOCAB, plen + gen)
        out.append((toks, plen, rng.normal(-2.0, 1.0, gen),
                    float(rng.normal())))
    return out


def _both(specs, cls_j=jrl.Rollout, cls_p=rl.Rollout):
    js = [cls_j(tokens=t, prompt_len=p, logprobs=lp, advantage=a)
          for t, p, lp, a in specs]
    ps = [cls_p(tokens=t, prompt_len=p, logprobs=lp, advantage=a)
          for t, p, lp, a in specs]
    return js, ps


@pytest.mark.parametrize("seed,kl", [(0, 0.0), (1, 0.25), (2, 1.5)])
def test_pack_rollouts_equals_jax(seed, kl):
    js, ps = _both(_rollouts(seed))
    jx, jy = jrl.pack_rollouts(js, 24, kl)
    px, py = rl.pack_rollouts(ps, 24, kl)
    assert px.dtype == jx.dtype and py.dtype == jy.dtype
    assert px.tobytes() == jx.tobytes() and py.tobytes() == jy.tobytes()


@pytest.mark.parametrize("case", ["short_len", "too_long", "no_logprobs",
                                  "empty"])
def test_pack_rollouts_errors_match_jax(case):
    specs = _rollouts(3, n=2)
    train_len = {"short_len": 1, "too_long": 4}.get(case, 24)
    if case == "no_logprobs":
        specs = [(t, p, lp[:0], a) for t, p, lp, a in specs]
        specs[0] = (np.arange(6), 2, np.zeros(0), 1.0)
    if case == "empty":
        specs = []
    js, ps = _both(specs)
    with pytest.raises(ValueError) as je:
        jrl.pack_rollouts(js, train_len)
    with pytest.raises(ValueError) as pe:
        rl.pack_rollouts(ps, train_len)
    assert str(pe.value) == str(je.value)


def _loss_inputs(seed, pad_lp):
    js, _ = _both(_rollouts(seed, n=4, L=16))
    _, y = jrl.pack_rollouts(js, 16, 0.3)
    y = y.copy()
    pad = y[..., 3] == 0
    y[..., 2][pad] = pad_lp  # arbitrary logprobs where the mask is 0
    logits = np.random.default_rng(seed + 10).standard_normal(
        y.shape[:2] + (VOCAB,)).astype(np.float32) * 3
    return logits, y


@pytest.mark.parametrize("pad_lp", [0.0, 1e30, -1e30])
@pytest.mark.parametrize("clip", [None, 0.2])
def test_rl_loss_value_and_gradient(clip, pad_lp):
    logits, y = _loss_inputs(4, pad_lp)
    jloss = jrl.rl_loss(clip)
    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits),
                                            jnp.asarray(y))
    t = torch.from_numpy(logits).requires_grad_(True)
    total, count = rl.rl_loss(clip)(t, torch.from_numpy(y))
    assert float(count) == float(y[..., 3].sum())
    got = total / torch.clamp_min(count, 1.0)
    got.backward()
    got = got.detach()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-9)


def test_rewards_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        prompt = rng.integers(0, VOCAB, 4)
        comp = rng.integers(0, VOCAB, int(rng.integers(0, 9)))
        lps = rng.normal(-1, 1, comp.size)
        for kw in ({}, {"length_coef": 0.1, "target_len": 5}):
            assert (rl.length_penalized_logprob(**kw)(prompt, comp, lps)
                    == jrl.length_penalized_logprob(**kw)(prompt, comp, lps))
        for seed in (0, 7):
            kw = dict(vocab_size=VOCAB, seed=seed, length_coef=0.01)
            assert (rl.rewards.get("toy_preference", **kw)(prompt, comp, lps)
                    == jrl.rewards.get("toy_preference", **kw)(
                        prompt, comp, lps))
    for mod in (rl.rewards, jrl.rewards):
        with pytest.raises(ValueError, match="Unknown reward"):
            mod.get("bogus")


@pytest.mark.parametrize("kind", ["ema", "kl"])
def test_baseline_and_kl_controller_sequences(kind):
    obs = np.random.default_rng(1).exponential(0.01, 12)
    if kind == "ema":
        p, j = dtt.optim.EmaBaseline(0.8), dtpu.optim.EmaBaseline(0.8)
    else:
        p = dtt.optim.AdaptiveKLCoef(0.05, target=0.01, factor=2.0)
        j = dtpu.optim.AdaptiveKLCoef(0.05, target=0.01, factor=2.0)
    assert [p.update(v) for v in obs] == [j.update(v) for v in obs]
    assert p.state_dict() == j.state_dict()
    fresh = type(p)() if kind == "kl" else dtt.optim.EmaBaseline()
    fresh.load_state(j.state_dict())
    assert fresh.state_dict() == p.state_dict()


@pytest.mark.parametrize("args", [dict(init_coef=-1), dict(target=0),
                                  dict(factor=1.0), dict(tolerance=0.5)])
def test_adaptive_kl_coef_validation_text(args):
    with pytest.raises(ValueError) as je:
        dtpu.optim.AdaptiveKLCoef(**args)
    with pytest.raises(ValueError) as pe:
        dtt.optim.AdaptiveKLCoef(**args)
    assert str(pe.value) == str(je.value)


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (int(rng.integers(3, 7)),))
            .astype(np.int32) for _ in range(n)]


def _record_grads(model):
    """Wrap ``model``'s optimizer so each step's |gradient| is kept."""
    seen, update = [], model.tx.update

    def rec(params, grads, state):
        seen.append([g.detach().abs().clone() for g in grads])
        return update(params, grads, state)

    model.tx.update = rec
    return seen


def _strict_entries(seen):
    """{parameter index: mask of the entries whose |gradient| was at
    least 1e-7 in every recorded step}."""
    return {i: torch.stack([step[i] for step in seen]).amin(0).numpy() >= 1e-7
            for i in range(len(seen[0]))}


def _check_params(got, want, strict, steps, lr):
    """``got`` ({path: array}, the port's) against ``want`` (JAX's):
    atol 1e-5 where ``strict`` ({path: mask}), Adam's bound everywhere
    (each side moves an entry by up to ``lr`` a step, so the two by up to
    ``2 * steps * lr``); returns the number of strict entries."""
    assert set(got) == set(want)
    n = 0
    for path, mask in strict.items():
        diff = np.abs(got[path] - want[path])
        assert diff[mask].max(initial=0.0) <= 1e-5, path
        assert diff.max() <= 2 * steps * lr, path
        n += int(mask.sum())
    return n


def _recording(engine, outs):
    run = engine.run

    def wrapped(reqs, **kw):
        got = run(reqs, **kw)
        outs.append([np.asarray(o) for o in got])
        return got

    engine.run = wrapped
    return engine


@pytest.fixture(scope="module")
def loops():
    jm, pm = lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                     max_len=64)
    jouts, pouts = [], []
    jeng = _recording(jax_engine(jm, **ENGINE), jouts)
    peng = _recording(Engine(pm, **ENGINE), pouts)
    kw = dict(learning_rate=LR, seed=5, reward_fn=jrl.ToyPreferenceModel(
        VOCAB, seed=1, length_coef=0.01))
    jpt = jrl.PostTrainer(jm, jeng, kl_coef=dtpu.optim.AdaptiveKLCoef(
        0.05, target=1e-4), **kw)
    kw["reward_fn"] = rl.ToyPreferenceModel(VOCAB, seed=1, length_coef=0.01)
    ppt = rl.PostTrainer(pm, peng, kl_coef=dtt.optim.AdaptiveKLCoef(
        0.05, target=1e-4), **kw)
    seen = _record_grads(pm)
    args = dict(iterations=2, num_samples=3, max_new_tokens=12,
                train_epochs=2)
    jrows = jpt.train(_prompts(), **args)
    prows = ppt.train(_prompts(), **args)
    jparams = dtt.interop.flatten_tree(jax.device_get(jm.params))
    return dict(jrows=jrows, prows=prows, jouts=jouts, pouts=pouts,
                jparams=jparams, pm=pm, peng=peng, jm=jm, seen=seen)


def test_post_trainer_first_rollouts_token_exact(loops):
    for j, p in zip(loops["jouts"][0], loops["pouts"][0]):
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("key", ["reward_mean", "reward_std", "baseline",
                                 "mean_completion_tokens", "num_rollouts",
                                 "weights_version", "iteration",
                                 "train_steps"])
def test_post_trainer_first_row_equal(loops, key):
    assert loops["prows"][0][key] == loops["jrows"][0][key]


@pytest.mark.parametrize("key", ["loss", "kl", "kl_coef"])
def test_post_trainer_losses_and_kl(loops, key):
    """Both iterations' values within 1e-5, given the same rollouts (the
    second iteration samples from parameters that differ by ~1e-7; a
    flipped sample there would show in its tokens first)."""
    for i, (j, p) in enumerate(zip(loops["jrows"], loops["prows"])):
        same = all(np.array_equal(a, b) for a, b in
                   zip(loops["jouts"][i], loops["pouts"][i]))
        if not same:
            assert i > 0, "iteration 1's rollouts differ"
            continue
        np.testing.assert_allclose(p[key], j[key], rtol=1e-5, atol=1e-7)


def test_post_trainer_parameters_within_adams_bound(loops):
    """Both iterations' rollouts are JAX's, so every step saw the same
    batch: entries with a gradient of at least 1e-7 in every step match
    within 1e-5, the rest within Adam's bound."""
    for j, p in zip(loops["jouts"], loops["pouts"]):
        for a, b in zip(j, p):
            np.testing.assert_array_equal(b, a)
    got = {k: v.detach().numpy() for k, v in loops["pm"].params.items()}
    steps = 2 * 2  # iterations x train_epochs
    assert len(loops["seen"]) == steps
    names = list(loops["pm"].params)
    strict = {names[i]: m for i, m in _strict_entries(loops["seen"]).items()}
    n = _check_params(got, loops["jparams"], strict, steps, LR)
    # 93 % of the entries are held strictly: all but the embedding rows
    # of tokens absent from the rollouts, the key biases and a few
    # entries near zero.
    assert n > 0.8 * sum(v.size for v in got.values()), n
    # The engine serves the trained masters after the last sync.
    served = loops["peng"]._target.params
    for k, v in loops["pm"].params.items():
        assert torch.equal(served[k], v)


def test_post_trainer_rows_keys_and_registry(loops):
    assert set(loops["prows"][0]) == set(loops["jrows"][0])
    assert [r["weights_version"] for r in loops["prows"]] == [1, 2]
    reg = dtt.obs.registry.default_registry()
    assert reg.counter_value("rl/iterations") >= 2
    assert reg.gauge_value("rl/reward_mean") == loops["prows"][-1][
        "reward_mean"]


def test_post_trainer_rejects_greedy_engine_and_unbuilt_model(loops):
    pm = loops["pm"]
    with pytest.raises(ValueError, match="temperature > 0"):
        rl.PostTrainer(pm, Engine(pm, max_slots=1, block_size=8,
                                  max_len=64))
    unbuilt = dtt.Model(dtt.models.transformer_lm(
        VOCAB, num_layers=1, d_model=16, num_heads=2, max_len=64),
        device="cpu")
    with pytest.raises(RuntimeError, match="Build the trainer model"):
        rl.PostTrainer(unbuilt, loops["peng"])


def test_measured_kl_is_the_k3_formula(loops):
    """``_measured_kl`` (logits kept on the device, a few rows at a time)
    against the k3 estimator over ``predict``'s whole logits."""
    pm = loops["pm"]
    js, _ = _both(_rollouts(6, n=6, L=64))
    x, y = rl.pack_rollouts(js, 64, 0.1)
    pt = rl.PostTrainer.__new__(rl.PostTrainer)
    pt.model = pm
    logits = torch.from_numpy(pm.predict(x, batch_size=len(x)))
    lp = torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(y[..., 0].astype(np.int64))[..., None])[..., 0]
    w = y[..., 3]
    d = (y[..., 2] - lp.numpy()) * w
    want = float(np.sum(w * (np.exp(d) - 1 - d)) / max(w.sum(), 1.0))
    np.testing.assert_allclose(pt._measured_kl(x, y), want, rtol=1e-6)


WORKER = WORKER_PRELUDE + '''
from distributed_tpu_torch import rl

VOCAB = 64
with dtt.DataParallel(device="cpu").scope():
    m = dtt.Model(dtt.models.transformer_lm(VOCAB, num_layers=1, d_model=16,
                                            num_heads=2, max_len=64))
    m.compile(optimizer="adam", loss=LOSS)
m.build((32,))
dtt.interop.place(m, params={k[2:]: data[k] for k in data.files
                             if k[:2] == "p:"})
prompts = [data["prompts"][i] for i in range(4)]
eng = dtt.serving.Engine(m, max_slots=2, block_size=8, max_len=64,
                         temperature=1.0, seed=3)
pt = rl.PostTrainer(m, eng, rl.ToyPreferenceModel(VOCAB, seed=1),
                    learning_rate=1e-3, kl_coef=0.01, grad_accum=2, seed=0)
seen, update = [], m.tx.update


def rec(params, grads, state):  # each step's reduced |gradient|
    seen.append([g.detach().abs().clone() for g in grads])
    return update(params, grads, state)


m.tx.update = rec
rows = pt.train(prompts, iterations=2, num_samples=2, max_new_tokens=8)
if spec.is_chief:
    gmin = {f"g:{k}": torch.stack([s[i] for s in seen]).amin(0).numpy()
            for i, k in enumerate(m.params)}
    np.savez(sys.argv[2], **{k: v.detach().numpy()
                             for k, v in m.params.items()}, **gmin)
dtt.launch.report_result([{k: r[k] for k in ("loss", "kl", "reward_mean",
                                             "weights_version")}
                          for r in rows])
dtt.cluster.shutdown()
'''


def test_post_trainer_on_two_ranks_with_grad_accum(tmp_path):
    devs = jax.devices()[:2]
    with dtpu.DataParallel(devs).scope():
        jm = dtpu.Model(dtpu.models.transformer_lm(
            VOCAB, num_layers=1, d_model=16, num_heads=2, max_len=64))
        jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jm.build((32,))
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    prompts = np.stack([p[:3] for p in _prompts(4, seed=2)])
    np.savez(tmp_path / "in.npz", prompts=prompts,
             x=np.zeros(1), y=np.zeros(1), tx=np.zeros(1), ty=np.zeros(1),
             **{f"p:{k}": v for k, v in start.items()})
    eng = JaxEngine(jm, max_slots=2, block_size=8, max_len=64,
                    temperature=1.0, seed=3)
    pt = jrl.PostTrainer(jm, eng, jrl.ToyPreferenceModel(VOCAB, seed=1),
                         learning_rate=1e-3, kl_coef=0.01, grad_accum=2,
                         seed=0)
    jrows = pt.train(list(prompts), iterations=2, num_samples=2,
                     max_new_tokens=8)
    port = run_pair(tmp_path, WORKER, tmp_path / "in.npz",
                    tmp_path / "out.npz", timeout=200)
    for rows in port.values():
        assert rows[0]["reward_mean"] == jrows[0]["reward_mean"]
        assert [r["weights_version"] for r in rows] == [1, 2]
        for p, j in zip(rows, jrows):
            np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(p["kl"], j["kl"], rtol=1e-5,
                                       atol=1e-8)
    out = np.load(tmp_path / "out.npz")
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = {k: out[k] for k in want}
    strict = {k: out[f"g:{k}"] >= 1e-7 for k in want}
    steps = 2  # iterations x train_epochs
    n = _check_params(got, want, strict, steps, 1e-3)
    # 77 % of the entries are held strictly: 4 prompts of 3 tokens and 8
    # sampled ones leave many of the 64 embedding rows without a gradient.
    assert n > 0.7 * sum(v.size for v in got.values()), n
