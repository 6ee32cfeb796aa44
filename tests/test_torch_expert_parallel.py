"""``nn.MoE`` under ``DataParallel`` and ``DataExpertParallel`` on gloo ranks, against JAX.

The JAX step routes the GLOBAL batch; the port's ranks each hold their
rows, so a routing group may span ranks (its capacity, each token's slot
and the load-balance statistics are then global: one all-gather of the
per-group counts, one all-reduce). The JAX side runs here on
``jax.devices()[:n]``, from the same JAX-built parameters and batches.

- 2 ranks, a one-MoE-layer LM whose routing groups (48 tokens) span the
  two ranks' 64 tokens each, at capacity factor 0.5 (tokens dropped):
  3 ``fit`` steps of ``SGD(0.1)`` under ``DataParallel(2)`` against JAX
  ``DataParallel`` and under ``DataExpertParallel(expert_parallel=2)``
  (data 1 x expert 2) against JAX's: losses rtol 1e-5, parameters and
  the aux loss (the state) atol 1e-5. ``expert_parallel=1`` on 2 ranks
  is bit for bit ``DataParallel`` and runs the f/g pair over its
  one-rank line (the calls are counted).
- 4 ranks, ``transformer_lm(moe_experts=4, moe_every=2)``: 3 steps under
  ``DataExpertParallel(expert_parallel=2)`` (data 2 x expert 2) and
  ``expert_parallel=4`` (data 1 x expert 4) against JAX's; each rank's
  shape of every parameter and optimizer leaf is JAX's addressable
  shard's; greedy ``generate`` and ``predict`` equal the single-device
  port's; the
  ``Engine`` serves the EP-built model (a gathered snapshot) with the
  tokens of a DP-built one; a sharded checkpoint of the EP ranks restores
  under ``DataParallel`` and in JAX's ``DataExpertParallel`` bit for bit;
  ``evaluate`` equals JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import (WORKER_PRELUDE, lm_tokens, run_pair, run_ranks,
                          shard_shapes)

torch.set_num_threads(1)

COMMON = WORKER_PRELUDE + '''
from distributed_tpu_torch.parallel import collectives

SPAN = {k[2:]: data[k] for k in data.files if k[:2] == "e:"}
MOE = {k[2:]: data[k] for k in data.files if k[:2] == "q:"}


def span_lm():
    n = dtt.nn
    return n.Sequential([
        n.Embedding(32, 32), n.PositionalEmbedding(16),
        n.Residual(n.Sequential([n.LayerNorm(), n.MoE(
            4, 32, capacity_factor=0.5, group_size=48)], name="main")),
        n.LayerNorm(), n.Dense(32)])


def moe_lm():
    return lm(moe_experts=4, moe_every=2)


def make(strategy, module, params):
    m = build(strategy, "lm", dtt.optim.SGD(0.1), module=module)
    dtt.interop.place(m, params=params)
    return m


def save(m, name):
    flat = {"params/" + k: v.detach().numpy() for k, v in m.params.items()}
    flat.update({"state/" + k: v.detach().numpy()
                 for k, v in m.state.items()})
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)
'''

PAIR = COMMON + '''
out = {}
dp = dtt.DataParallel(device="cpu")
m = make(dp, span_lm(), SPAN)
out["span_dp"] = fit(m, "lm")
save(m, "span_dp")
ref = (out["span_dp"], full(m))
ep = dtt.DataExpertParallel(expert_parallel=2, device="cpu")
m = make(ep, span_lm(), SPAN)
out["span_ep"] = fit(m, "lm")
save(m, "span_ep")
# Count Megatron's pair (the layer reaches it through the module):
# expert_parallel=1 must run it, over a line of one rank.
CALLS = {"copy_to_group": 0, "reduce_from_group": 0}


def counted(name, fn):
    def call(*a, **kw):
        CALLS[name] += 1
        return fn(*a, **kw)
    return call


for _name in CALLS:
    setattr(collectives, _name, counted(_name, getattr(collectives, _name)))
ep1 = dtt.DataExpertParallel(expert_parallel=1, device="cpu")
m = make(ep1, span_lm(), SPAN)
losses = fit(m, "lm")
out["ep1_calls"] = dict(CALLS)
out["ep1_same"] = [losses == ref[0], same(full(m), ref[1])]
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''

QUAD = COMMON + '''
out = {}
dp = dtt.DataParallel(device="cpu")
prompt = TX[:2, :5]
for name, n in (("ep2", 2), ("ep4", 4)):
    st = dtt.DataExpertParallel(expert_parallel=n, device="cpu")
    m = make(st, moe_lm(), MOE)
    out["shapes_" + name] = local_shapes(m)
    out[name] = fit(m, "lm")
    save(m, name)
    out["eval_" + name] = m.evaluate(TX[:12], TY[:12], batch_size=8,
                                     verbose=0)["loss"]
    out["gen_" + name] = m.generate(prompt, 6, temperature=0.0).tolist()
    single = dtt.Model(moe_lm(), device="cpu").build((16,))
    single.load_params(full(m))
    out["single_" + name] = single.generate(prompt, 6,
                                            temperature=0.0).tolist()
    out["predict_" + name] = float(np.abs(
        m.predict(TX[:4], batch_size=4)
        - single.predict(TX[:4], batch_size=4)).max())
prompts = [(TX[i, :6], 4) for i in range(3)]
out["engine_ep"] = [t.tolist() for t in dtt.serving.Engine(
    m, max_slots=2, block_size=4, max_len=16).run(prompts)]
d = make(dp, moe_lm(), {k: v.detach().numpy() for k, v in full(m).items()})
out["engine_dp"] = [t.tolist() for t in dtt.serving.Engine(
    d, max_slots=2, block_size=4, max_len=16).run(prompts)]
dtt.ShardedCheckpointer(sys.argv[2] + "_ck").save(m)
d2 = make(dp, moe_lm(), MOE)
dtt.ShardedCheckpointer(sys.argv[2] + "_ck").restore_into(d2)
out["restore_same"] = same(full(m), full(d2))
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _span_lm(pkg):
    n = pkg.nn
    return n.Sequential([
        n.Embedding(32, 32), n.PositionalEmbedding(16),
        n.Residual(n.Sequential([n.LayerNorm(), n.MoE(
            4, 32, capacity_factor=0.5, group_size=48)], name="main")),
        n.LayerNorm(), n.Dense(32)])


def _moe_lm():
    return dtpu.models.transformer_lm(32, num_layers=2, d_model=32,
                                      num_heads=2, max_len=16,
                                      moe_experts=4, moe_every=2)


def _jax_fit(strategy, module, tx, ty):
    with strategy.scope():
        m = dtpu.Model(module)
        m.compile(optimizer=dtpu.optim.SGD(0.1),
                  loss="sparse_categorical_crossentropy", metrics=[])
    m.build((16,), seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(m.params))
    shapes = dict(shard_shapes(m.params, "params"),
                  **shard_shapes(m.opt_state, "opt_state"))
    hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0)
    flat = dtt.interop.flatten_tree(jax.device_get(
        {"params": m.params, "state": m.state}))
    return m, start, shapes, hist.history["loss"], flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    tx, ty = lm_tokens()
    d2, d4 = jax.devices()[:2], jax.devices()[:4]
    jax_runs = {
        "span_dp": _jax_fit(dtpu.DataParallel(d2), _span_lm(dtpu), tx, ty),
        "span_ep": _jax_fit(dtpu.DataExpertParallel(d2, expert_parallel=2),
                            _span_lm(dtpu), tx, ty),
        "ep2": _jax_fit(dtpu.DataExpertParallel(d4, expert_parallel=2),
                        _moe_lm(), tx, ty),
        "ep4": _jax_fit(dtpu.DataExpertParallel(d4, expert_parallel=4),
                        _moe_lm(), tx, ty),
    }
    evals = {k: jax_runs[k][0].evaluate(tx[:12], ty[:12], batch_size=8,
                                        verbose=0)["loss"]
             for k in ("ep2", "ep4")}
    np.savez(tmp / "in.npz", x=np.zeros((1, 28, 28, 1), np.float32),
             y=np.zeros(1, np.int32), tx=tx, ty=ty,
             **{f"e:{k}": v for k, v in jax_runs["span_dp"][1].items()},
             **{f"q:{k}": v for k, v in jax_runs["ep2"][1].items()})
    pair = run_pair(tmp, PAIR, tmp / "in.npz", tmp / "pair", timeout=200)
    quad = run_ranks(4, tmp, QUAD, tmp / "in.npz", tmp / "quad",
                     timeout=300)
    got = {}
    for name, prefix in (("span_dp", "pair"), ("span_ep", "pair"),
                         ("ep2", "quad"), ("ep4", "quad")):
        with np.load(tmp / f"{prefix}_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    with dtpu.DataExpertParallel(d4, expert_parallel=4).scope():
        back = dtpu.Model(_moe_lm())
        back.compile(optimizer=dtpu.optim.SGD(0.1),
                     loss="sparse_categorical_crossentropy", metrics=[])
    back.build((16,), seed=1)
    dtpu.ShardedCheckpointer(tmp / "quad_ck").restore_into(back)
    restored = dtt.interop.flatten_tree(jax.device_get(back.params))
    return dict(pair=pair, quad=quad, got=got, evals=evals,
                restored=restored,
                jax={k: v[2:] for k, v in jax_runs.items()})


@pytest.mark.parametrize("run", ["span_dp", "span_ep", "ep2", "ep4"])
def test_moe_matches_jax(runs, run):
    shapes, want_losses, want = runs["jax"][run]
    rows = runs["pair" if run.startswith("span") else "quad"]
    for row in rows.values():
        np.testing.assert_allclose(row[run], want_losses, rtol=1e-5)
    got = runs["got"][run]
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)


def test_span_groups_drop_tokens(runs):
    """The span case's routing does drop: its aux loss differs from a
    balanced router's and its capacity (12 a group of 48) is below the
    mean load (24)."""
    layer = dtt.nn.MoE(4, 32, capacity_factor=0.5, group_size=48)
    assert layer._capacity(48) == 12
    aux = runs["got"]["span_dp"]["state/residual/main/moe/aux_loss"]
    assert float(aux) > 0.01


@pytest.mark.parametrize("run", ["ep2", "ep4"])
def test_ep_shard_shapes_equal_jax(runs, run):
    want = runs["jax"][run][0]
    for row in runs["quad"].values():
        assert row["shapes_" + run] == want
    n = int(run[2:])
    assert want["params/residual_3/main/moe/w_in"] == [4 // n, 32, 128]


@pytest.mark.parametrize("run", ["ep2", "ep4"])
def test_ep_evaluate_and_generate(runs, run):
    for row in runs["quad"].values():
        np.testing.assert_allclose(row["eval_" + run], runs["evals"][run],
                                   rtol=1e-5)
        assert row["gen_" + run] == row["single_" + run]
        assert row["predict_" + run] < 1e-5


def test_ep_engine_and_checkpoint(runs):
    for row in runs["quad"].values():
        assert row["engine_ep"] == row["engine_dp"]
        assert row["restore_same"]
    # The EP ranks' sharded checkpoint (expert stacks split 4 ways) is the
    # JAX directory format: JAX's DataExpertParallel restores it.
    got = runs["got"]["ep4"]
    for path, v in runs["restored"].items():
        np.testing.assert_array_equal(v, got["params/" + path], err_msg=path)


def test_expert_parallel_one_runs_the_pair_bitwise_dp(runs):
    for row in runs["pair"].values():
        assert row["ep1_same"] == [True, True]
        assert row["ep1_calls"]["copy_to_group"] > 0
        assert row["ep1_calls"]["reduce_from_group"] > 0
