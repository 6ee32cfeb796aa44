"""``nn.PipelinedBlocks`` and ``DataPipelineParallel`` in the port, against the JAX package.

Off a pipe line (one process) the stack is the sequential scan: the layer
and the pipelined LM's ``fit``, ``generate`` and Engine serving equal the
JAX package's. On gloo ranks (the port's launcher; the JAX side on
``jax.devices()[:n]`` under its ``DataPipelineParallel``, from the same
JAX-built parameters and batches):

- 2 ranks (pipe 2), the 4-layer pipelined LM, 3 ``fit`` steps of
  ``SGD(0.1)`` at batch 8: GPipe at M = 1, 2 and 4 microbatches and the
  interleaved schedule (v = 2, M = 2): losses rtol 1e-5, parameters atol
  1e-5; the embedding and the head (replicated) stay bit-identical on the
  two pipe ranks; the fit's ``pipeline`` telemetry is JAX's record.
- Dropout inside the blocks under PP(2): JAX's masks (``split(rng, S)``
  folded with the tick), so the same losses and parameters.
- ``evaluate`` with a partial last batch (padded, as JAX pads) equals
  JAX's; the ring decode (each rank its blocks' caches) generates the
  single-device tokens and ``predict`` (the stack's slices broadcast from
  their ranks) its logits; a sharded checkpoint of the pipe ranks restores
  under ``DataParallel`` and in JAX's ``DataPipelineParallel`` bit for
  bit; ``comm_bytes_estimate`` (with its per-token stage hops) equals
  JAX's; the paged hooks raise JAX's
  ``NotImplementedError`` on a live pipe line, a cacheless stack's decode
  its ``ValueError``; blocks or batches that do not divide raise JAX's
  errors.
- 4 ranks (data 2 x pipe 2), GPipe M = 2: JAX's losses and parameters,
  for the LM and for the Dropout stack (each rank's masks drawn at its
  microbatch's local shape, as in the JAX schedule's ``shard_map``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import (WORKER_PRELUDE, lm_tokens, port_model, run_pair,
                          run_ranks)

torch.set_num_threads(1)


def _mlp_block(pkg):
    return lambda: pkg.nn.Sequential(
        [pkg.nn.Dense(16, activation="gelu"), pkg.nn.Dense(8)], name="main")


def _drop_block(pkg):
    return lambda: pkg.nn.Sequential(
        [pkg.nn.Dense(16, activation="gelu"), pkg.nn.Dropout(0.1),
         pkg.nn.Dense(8)], name="main")


def _drop_model(pkg):
    return pkg.nn.Sequential([pkg.nn.PipelinedBlocks(_drop_block(pkg), 2),
                              pkg.nn.Dense(4)])


def _plm(pkg, **kw):
    return pkg.models.transformer_lm(32, num_layers=4, d_model=32,
                                     num_heads=2, max_len=16, pipeline=True,
                                     **kw)


# ------------------------------------------------------------ one process
def test_layer_matches_jax_and_validates():
    jl = dtpu.nn.PipelinedBlocks(_mlp_block(dtpu), 3)
    params, state, out = jl.init(jax.random.PRNGKey(0), (8,))
    pl = dtt.nn.PipelinedBlocks(_mlp_block(dtt), 3)
    assert pl.build((8,), torch.Generator().manual_seed(0)) == out
    with torch.no_grad():
        for k, v in dtt.interop.params_from_jax(
                jax.device_get(params)).items():
            pl.get_parameter(k.replace("/", ".")).copy_(v)
    x = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    want, _ = jl.apply(params, state, jnp.asarray(x))
    got = pl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    assert pl.sharding_hints() == jl.sharding_hints() == {"blocks": "pipe"}
    for pkg in (dtpu, dtt):
        with pytest.raises(ValueError, match="schedule"):
            pkg.nn.PipelinedBlocks(_mlp_block(pkg), 4, schedule="zigzag")
        with pytest.raises(ValueError, match="interleave"):
            pkg.nn.PipelinedBlocks(_mlp_block(pkg), 4, interleave=2)
        with pytest.raises(ValueError, match="interleave"):
            pkg.nn.PipelinedBlocks(_mlp_block(pkg), 4,
                                   schedule="interleaved", interleave=1)
    g = torch.Generator()
    with pytest.raises(ValueError, match="preserve shape"):
        dtt.nn.PipelinedBlocks(lambda: dtt.nn.Dense(5), 2).build((8,), g)
    with pytest.raises(ValueError, match="stateless"):
        dtt.nn.PipelinedBlocks(lambda: dtt.nn.BatchNorm(), 2).build((8,), g)
    assert dtt.nn.pipeline.last_pipeline_trace() is None


def test_pipelined_lm_off_the_pipe_line_matches_jax():
    x, y = lm_tokens(16)
    jm = dtpu.Model(_plm(dtpu))
    jm.compile(optimizer=dtpu.optim.SGD(0.1),
               loss="sparse_categorical_crossentropy", metrics=[])
    jm.build((16,), seed=0)
    pm = port_model(_plm(dtt), (16,), jm.params)
    pm.compile(optimizer=dtt.optim.SGD(0.1),
               loss="sparse_categorical_crossentropy", metrics=[])
    fit = dict(batch_size=8, epochs=3, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)
    np.testing.assert_allclose(pm.fit(x, y, **fit).history["loss"],
                               jm.fit(x, y, **fit).history["loss"],
                               rtol=1e-5)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    for path, v in dtt.interop.params_to_numpy(pm.params).items():
        np.testing.assert_allclose(v, want[path], rtol=0, atol=1e-5,
                                   err_msg=path)
    assert "pipeline" not in pm.last_fit_telemetry
    prompt = x[:2, :4]
    gen = pm.generate(prompt, 6, temperature=0.0)
    np.testing.assert_array_equal(
        gen, np.asarray(jm.generate(prompt, 6, temperature=0.0)))
    engine = dtt.serving.Engine(pm, max_slots=2, block_size=4, max_len=16)
    got = engine.run([(prompt[i], 6) for i in range(2)])
    for i in range(2):
        np.testing.assert_array_equal(got[i], gen[i])


# ------------------------------------------------------------ gloo ranks
COMMON = WORKER_PRELUDE + '''
from distributed_tpu_torch.parallel.collectives import layout_of

PLM = {k[2:]: data[k] for k in data.files if k[:2] == "p:"}
DROP = {k[2:]: data[k] for k in data.files if k[:2] == "d:"}
FX, FY = data["fx"], data["fy"]


def plm(**kw):
    return dtt.models.transformer_lm(32, **{
        "num_layers": 4, "d_model": 32, "num_heads": 2, "max_len": 16,
        "pipeline": True, **kw})


def drop_model():
    n = dtt.nn
    return n.Sequential([n.PipelinedBlocks(lambda: n.Sequential(
        [n.Dense(16, activation="gelu"), n.Dropout(0.1), n.Dense(8)],
        name="main"), 2), n.Dense(4)])


def make(strategy, module, params, shape=(16,)):
    with strategy.scope():
        m = dtt.Model(module)
        m.compile(optimizer=dtt.optim.SGD(0.1), loss=LOSS, metrics=[])
    m.build(shape)
    dtt.interop.place(m, params=params)
    return m


def save(m, name):
    flat = {k: v.detach().numpy() for k, v in m.params.items()}
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)


def replicated_same(m):
    rep = {k: v for k, v in m.live_params().items() if layout_of(v) is None}
    dtt.utils.sync_check.assert_replicas_identical(rep)
    return sorted(rep)
'''

PAIR = COMMON + '''
out = {}
for name, mb, kw in (("m1", 1, {}), ("m2", 2, {}), ("m4", 4, {}),
                     ("il", 2, dict(pipeline_schedule="interleaved",
                                    pipeline_interleave=2))):
    st = dtt.DataPipelineParallel(pipeline_parallel=2, num_microbatches=mb,
                                  device="cpu")
    m = make(st, plm(**kw), PLM)
    out[name] = fit(m, "lm")
    save(m, name)
    out["rep_" + name] = replicated_same(m)
    out["trace_" + name] = m.last_fit_telemetry["pipeline"]
    out["blocks_" + name] = list(
        m.live_params()["pipelined_blocks/blocks/residual/main/"
                        "multi_head_attention/wq"].shape)
st = dtt.DataPipelineParallel(pipeline_parallel=2, device="cpu")
d = make(st, drop_model(), DROP, (8,))
out["drop"] = [float(v) for v in d.fit(
    FX, FY, batch_size=16, epochs=2, steps_per_epoch=1, shuffle=False,
    verbose=0).history["loss"]]
save(d, "drop")
out["eval"] = m.evaluate(TX[:12], TY[:12], batch_size=8, verbose=0)["loss"]
prompt = TX[:2, :4]
out["gen"] = m.generate(prompt, 6, temperature=0.0).tolist()
single = dtt.Model(plm(pipeline_schedule="interleaved",
                       pipeline_interleave=2), device="cpu").build((16,))
single.load_params(full(m))
out["gen_single"] = single.generate(prompt, 6, temperature=0.0).tolist()
out["predict"] = float(np.abs(m.predict(TX[:4], batch_size=4)
                              - single.predict(TX[:4], batch_size=4)).max())
dtt.ShardedCheckpointer(sys.argv[2] + "_ck").save(m)
meta = {p: torch.empty(t.shape, device="meta") for p, t in m.params.items()}
out["estimate"] = st.comm_bytes_estimate(
    meta, hints=m.module.sharding_hints())
dp = dtt.DataParallel(device="cpu")
m2 = make(dp, plm(), PLM)
dtt.ShardedCheckpointer(sys.argv[2] + "_ck").restore_into(m2)
out["restore_same"] = same(full(m), full(m2))
errors = {}
with st.scope():
    pb = m.module.layers[2]
    try:
        pb.init_paged_cache(8, 4, torch.float32, torch.device("cpu"))
    except NotImplementedError as e:
        errors["paged"] = str(e)
try:
    stack = d.module.layers[0]
    with torch.no_grad():
        stack.decode(stack.init_cache(1, 4, torch.float32,
                                      torch.device("cpu")),
                     torch.zeros(1, 1, 8), pos=0)
except ValueError as e:
    errors["cacheless"] = str(e)
for key, module, mb in (("blocks", plm(num_layers=3), 2),
                        ("batch", plm(), 3),
                        ("chunks", plm(num_layers=6, pipeline_schedule=
                                       "interleaved",
                                       pipeline_interleave=2), 2),
                        ("micro", plm(pipeline_schedule="interleaved",
                                      pipeline_interleave=2), 1)):
    try:
        s2 = dtt.DataPipelineParallel(pipeline_parallel=2,
                                      num_microbatches=mb, device="cpu")
        with s2.scope():
            e = dtt.Model(module)
            e.compile(optimizer="sgd", loss=LOSS)
        e.fit(TX[:16], TY[:16], batch_size=16, epochs=1, verbose=0)
        errors[key] = None
    except ValueError as exc:
        errors[key] = str(exc)
out["errors"] = errors
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''

QUAD = COMMON + '''
out = {}
st = dtt.DataPipelineParallel(pipeline_parallel=2, device="cpu")
m = make(st, plm(), PLM)
out["dp2pp2"] = fit(m, "lm")
out["rep"] = replicated_same(m)
save(m, "dp2pp2")
d = make(st, drop_model(), DROP, (8,))
out["drop4"] = [float(v) for v in d.fit(
    FX, FY, batch_size=16, epochs=2, steps_per_epoch=1, shuffle=False,
    verbose=0).history["loss"]]
save(d, "drop4")
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _jax_run(strategy, module, x, y, shape=(16,), **fit):
    with strategy.scope():
        m = dtpu.Model(module)
        m.compile(optimizer=dtpu.optim.SGD(0.1),
                  loss="sparse_categorical_crossentropy", metrics=[])
    m.build(shape, seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(m.params))
    hist = m.fit(x, y, **fit)
    return m, start, hist.history["loss"], dtt.interop.flatten_tree(
        jax.device_get(m.params))


LM_FIT = dict(batch_size=8, epochs=3, steps_per_epoch=1, shuffle=True,
              seed=0, verbose=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    tx, ty = lm_tokens()
    rng = np.random.default_rng(0)
    fx = rng.normal(size=(32, 8)).astype(np.float32)
    fy = rng.integers(0, 4, size=32).astype(np.int32)
    d2, d4 = jax.devices()[:2], jax.devices()[:4]
    jax_runs, traces = {}, {}
    for name, mb, kw in (("m1", 1, {}), ("m2", 2, {}), ("m4", 4, {}),
                         ("il", 2, dict(pipeline_schedule="interleaved",
                                        pipeline_interleave=2))):
        st = dtpu.DataPipelineParallel(d2, pipeline_parallel=2,
                                       num_microbatches=mb)
        jax_runs[name] = _jax_run(st, _plm(dtpu, **kw), tx, ty, **LM_FIT)
        traces[name] = jax_runs[name][0].last_fit_telemetry["pipeline"]
    jm = jax_runs["il"][0]
    evaluated = jm.evaluate(tx[:12], ty[:12], batch_size=8,
                            verbose=0)["loss"]
    jax_gen = np.asarray(jm.generate(tx[:2, :4], 6, temperature=0.0))
    jax_runs["drop"] = _jax_run(
        dtpu.DataPipelineParallel(d2, pipeline_parallel=2),
        _drop_model(dtpu), fx, fy, (8,), batch_size=16, epochs=2,
        steps_per_epoch=1, shuffle=False, verbose=0)
    jax_runs["dp2pp2"] = _jax_run(
        dtpu.DataPipelineParallel(d4, pipeline_parallel=2), _plm(dtpu), tx,
        ty, **LM_FIT)
    jax_runs["drop4"] = _jax_run(
        dtpu.DataPipelineParallel(d4, pipeline_parallel=2),
        _drop_model(dtpu), fx, fy, (8,), batch_size=16, epochs=2,
        steps_per_epoch=1, shuffle=False, verbose=0)
    np.savez(tmp / "in.npz", x=np.zeros((1, 28, 28, 1), np.float32),
             y=np.zeros(1, np.int32), tx=tx, ty=ty, fx=fx, fy=fy,
             **{f"p:{k}": v for k, v in jax_runs["m1"][1].items()},
             **{f"d:{k}": v for k, v in jax_runs["drop"][1].items()})
    pair = run_pair(tmp, PAIR, tmp / "in.npz", tmp / "pair", timeout=240)
    quad = run_ranks(4, tmp, QUAD, tmp / "in.npz", tmp / "quad",
                     timeout=240)
    got = {}
    for name in ("m1", "m2", "m4", "il", "drop", "dp2pp2", "drop4"):
        prefix = "quad" if name in ("dp2pp2", "drop4") else "pair"
        with np.load(tmp / f"{prefix}_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    st = dtpu.DataPipelineParallel(d2, pipeline_parallel=2)
    with st.scope():
        back = dtpu.Model(_plm(dtpu, pipeline_schedule="interleaved",
                               pipeline_interleave=2))
        back.compile(optimizer=dtpu.optim.SGD(0.1),
                     loss="sparse_categorical_crossentropy", metrics=[])
    back.build((16,), seed=1)
    dtpu.ShardedCheckpointer(tmp / "pair_ck").restore_into(back)
    restored = dtt.interop.flatten_tree(jax.device_get(back.params))
    hints = jm.module.sharding_hints()
    estimate = st.comm_bytes_estimate(jm.params, hints=hints)
    return dict(pair=pair, quad=quad, got=got, traces=traces,
                eval=evaluated, jax_gen=jax_gen, restored=restored,
                estimate=estimate,
                jax={k: v[2:] for k, v in jax_runs.items()})


@pytest.mark.parametrize("run", ["m1", "m2", "m4", "il", "drop", "dp2pp2",
                                 "drop4"])
def test_pipeline_matches_jax(runs, run):
    want_losses, want = runs["jax"][run]
    rows = runs["quad" if run in ("dp2pp2", "drop4") else "pair"]
    for row in rows.values():
        np.testing.assert_allclose(row[run], want_losses, rtol=1e-5)
    got = runs["got"][run]
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("run", ["m1", "m2", "m4", "il"])
def test_stages_split_replicas_identical_trace(runs, run):
    for row in runs["pair"].values():
        assert row["blocks_" + run] == [2, 32, 32]  # 2 of the 4 blocks
        assert "embedding/table" in row["rep_" + run]
        assert row["trace_" + run] == runs["traces"][run]
    assert "embedding/table" in runs["quad"][0]["rep"]


def test_pipeline_evaluate_generate_checkpoint(runs):
    for row in runs["pair"].values():
        np.testing.assert_allclose(row["eval"], runs["eval"], rtol=1e-5)
        assert row["gen"] == row["gen_single"]
        assert row["predict"] < 1e-5
        np.testing.assert_array_equal(np.array(row["gen"]), runs["jax_gen"])
        assert row["restore_same"]
        assert row["estimate"] == runs["estimate"]
    # The pipe ranks' sharded checkpoint (stage stacks split 2 ways) is
    # the JAX directory format: JAX's DataPipelineParallel restores it.
    for path, v in runs["restored"].items():
        np.testing.assert_array_equal(v, runs["got"]["il"][path],
                                      err_msg=path)


def test_pipeline_errors_are_jax(runs):
    errors = runs["pair"][0]["errors"]
    assert "single-device" in errors["paged"]
    assert "per-block cache" in errors["cacheless"]
    assert errors["blocks"] == ("3 pipelined blocks not divisible by pipe=2 "
                                "stages")
    assert errors["batch"] == ("batch 16 not divisible by data shards (1) x "
                               "microbatches (3)")
    assert errors["chunks"] == ("6 blocks not divisible by pipe=2 stages x "
                                "interleave=2 virtual chunks")
    assert "num_microbatches >= stages" in errors["micro"]
    with pytest.raises(ValueError, match="num_microbatches"):
        dtpu.DataPipelineParallel(jax.devices()[:2], pipeline_parallel=2,
                                  num_microbatches=0)
