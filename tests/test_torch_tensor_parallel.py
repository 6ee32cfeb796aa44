"""``DataTensorParallel`` in the port, on 4 gloo ranks, against the JAX package.

One group of 4 worker processes (the port's launcher, data 2 x model 2)
runs the checks of this file, and one pair of 2 ranks the degenerate
strategies; the JAX side runs here on ``jax.devices()[:4]`` under the JAX
``DataTensorParallel(model_parallel=2)``, from the same JAX-built
parameters and numpy batches. The LM is 2 layers, d 32, 4 heads, vocab
32, T 16.

- 3 ``fit`` steps of ``SGD(0.1)`` with ``flash=True`` (K3-K5's plain
  versions on each rank's 2 heads), of ``Adam(1e-3)`` with
  ``grad_clip=0.05`` (the clip's global norm sums the split leaves'
  partials over the model line), and of the scanned LM (``scan=True``,
  its "row1" stacks): losses within rtol 1e-5 of JAX's, parameters
  within atol 1e-5 (under Adam, the attention key bias ``bk``, whose
  gradient is zero in exact arithmetic, to Adam's own bound ``3 * lr``).
- Each rank's shape of every parameter and optimizer leaf equals JAX's
  addressable shard shape; the scanned stack splits "row1" leaves on
  dim 1.
- ``comm_bytes_estimate(..., hints=)`` equals JAX's, f32 and bf16.
- Replicated leaves stay bit-identical across the ranks (``utils.
  sync_check``), and so does the gathered tree.
- Greedy ``generate`` equals the single-device port's on the same
  weights and JAX's TP ``generate``; the ``Engine`` serves a TP-built
  model with the same tokens as a DP-built one, and after
  ``quant.quantize_model`` (int8 weights split as their layers are)
  ``predict`` gives DP's logits.
- Checkpoints: a JAX TP ``ShardedCheckpointer`` save restores into the
  port's TP ranks; the port's TP save restores under ``DataParallel``
  and in JAX (each Megatron block written once); ``save_weights`` gathers.
- A "col" Dense whose output another layer than a "row" one reads
  (gathered) and a "row" Dense given the whole input (its block taken)
  train as ``DataParallel`` does (losses rtol 1e-5, parameters atol
  1e-6).
- ``model_parallel=3`` on 4 ranks raises JAX's "not divisible" error, and
  K > 1 ``steps_per_execution`` on the card raises naming ROADMAP 1.3a.
- On 2 ranks, ``DataTensorParallel(model_parallel=1)`` and
  ``DataSeqParallel(seq_parallel=1)`` are bit for bit ``DataParallel``;
  the former stores its hinted leaves as blocks of a one-rank model line
  and runs the Megatron pair over it.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import (WORKER_PRELUDE, lm_tokens, mnist_data, run_pair,
                          run_ranks, shard_shapes)

torch.set_num_threads(1)

COMMON = WORKER_PRELUDE + '''
from distributed_tpu_torch.parallel.collectives import layout_of

SCAN = {k[2:]: data[k] for k in data.files if k[:2] == "s:"}


def lm4(**kw):
    return dtt.models.transformer_lm(32, num_layers=2, d_model=32,
                                     num_heads=4, max_len=16, **kw)


def make(strategy, opt, params, module_kw=None, **compile_kw):
    m = build(strategy, "lm", opt, module=lm4(**(module_kw or {})),
              **compile_kw)
    dtt.interop.place(m, params=params)
    return m


def save(m, name):
    flat = dtt.interop.flatten_tree({
        "params": {k: v.detach() for k, v in m.params.items()},
        "opt_state": m._opt_tree()})
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)
'''

WORKER = COMMON + '''
out = {"rank": spec.index}
tp = dtt.DataTensorParallel(model_parallel=2, device="cpu")
dp = dtt.DataParallel(device="cpu")
out["coords"] = [tp._rank(), tp.tp_rank]

# SGD, flash attention on the head shards.
m = make(tp, dtt.optim.SGD(0.1), PARAMS["lm"], dict(flash=True))
out["shapes_sgd"] = local_shapes(m)
out["losses_sgd"] = fit(m, "lm")
save(m, "sgd")
rep = {k: v for k, v in m.live_params().items() if layout_of(v) is None}
dtt.utils.sync_check.assert_replicas_identical(rep)
dtt.utils.sync_check.assert_model_replicas_identical(m)
out["replicated"] = sorted(rep)
out["estimate"] = m.last_fit_telemetry["comm_bytes_estimate"]
meta = {p: torch.empty(t.shape, device="meta")
        for p, t in m.params.items()}
out["estimate_bf16"] = tp.comm_bytes_estimate(
    meta, compute_dtype=torch.bfloat16, hints=m.module.sharding_hints())
prompt = TX[:2, :5]
out["gen_tp"] = m.generate(prompt, 6, temperature=0.0).tolist()
single = dtt.Model(lm4(flash=True), device="cpu").build((16,))
single.load_params(full(m))
out["gen_single"] = single.generate(prompt, 6, temperature=0.0).tolist()
prompts = [(TX[i, :6], 4) for i in range(3)]
out["engine_tp"] = [t.tolist() for t in dtt.serving.Engine(
    m, max_slots=2, block_size=4, max_len=16).run(prompts)]
d = make(dp, dtt.optim.SGD(0.1),
         {k: v.detach().numpy() for k, v in full(m).items()},
         dict(flash=True))
out["engine_dp"] = [t.tolist() for t in dtt.serving.Engine(
    d, max_slots=2, block_size=4, max_len=16).run(prompts)]

# int8 weights (quant.quantize_model) take their layers' Megatron split.
preds = []
for st in (tp, dp):
    q = make(st, dtt.optim.SGD(0.1), PARAMS["lm"], dict(flash=True))
    dtt.quant.quantize_model(q)
    preds.append(q.predict(TX[:4], batch_size=4).tolist())
out["int8_same"] = preds[0] == preds[1]

# Checkpoints: the port's TP save, restored under DataParallel; the JAX
# TP save restored into TP ranks; save_weights gathers.
ck = dtt.ShardedCheckpointer(sys.argv[2] + "_port")
ck.save(m)
out["saved_step"] = m.step
m2 = make(dp, dtt.optim.SGD(0.1), PARAMS["lm"], dict(flash=True))
out["dp_restore"] = [dtt.ShardedCheckpointer(
    sys.argv[2] + "_port").restore_into(m2), same(full(m), full(m2))]
m3 = make(tp, dtt.optim.SGD(0.1), PARAMS["lm"], dict(flash=True))
out["jax_step"] = dtt.ShardedCheckpointer(sys.argv[3]).restore_into(m3)
save(m3, "from_jax")
m.save_weights(sys.argv[2] + "_w.npz")
torch.distributed.barrier()
m4 = make(tp, dtt.optim.SGD(0.1), PARAMS["lm"], dict(flash=True))
m4.load_weights(sys.argv[2] + "_w.npz")
out["weights_same"] = same(full(m), full(m4))

# Adam with the clip.
m = make(tp, dtt.optim.Adam(1e-3), PARAMS["lm"], dict(flash=True),
         grad_clip=0.05)
out["shapes_adam"] = local_shapes(m)
out["losses_adam"] = fit(m, "lm")
save(m, "adam")

# The scanned stack: "row1" leaves split on dim 1.
m = make(tp, dtt.optim.SGD(0.1), SCAN, dict(scan=True))
out["shapes_scan"] = local_shapes(m)
out["losses_scan"] = fit(m, "lm")
save(m, "scan")

# Hints outside the Megatron pair: a "col" output gathered (LayerNorm
# reads all features), a "row" layer given the whole input (its block
# taken), against DataParallel from the same seed.
def mlp():
    n = dtt.nn
    return n.Sequential([
        n.Flatten(), n.Dense(16, shard="col", activation="relu"),
        n.LayerNorm(), n.Dense(32, shard="col"),
        n.Dense(16, shard="row", activation="relu"), n.Dense(16, shard="row"),
        n.Dense(10)])


mlps = []
for st in (tp, dp):
    q = build(st, "mnist", dtt.optim.SGD(0.05), module=mlp())
    mlps.append((fit(q, "mnist"), {k: v.detach() for k, v in
                                   full(q).items()}))
out["mlp"] = [max(abs(a - b) / abs(b) for a, b in zip(mlps[0][0],
                                                     mlps[1][0])),
              max_excess(mlps[0][1], mlps[1][1], 0.0)]

try:
    dtt.DataTensorParallel(model_parallel=3, device="cpu")
    out["mp3"] = None
except ValueError as e:
    out["mp3"] = str(e)
try:
    m._check_capturable()
    out["capturable"] = None
except NotImplementedError as e:
    out["capturable"] = str(e)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''

DEGENERATE = COMMON + '''
from distributed_tpu_torch.parallel import collectives

# Count the Megatron pair's calls (the layers reach them through the
# module): model_parallel=1 must run them, over a line of one rank.
CALLS = {"copy_to_group": 0, "reduce_from_group": 0}


def counted(name, fn):
    def call(*a, **kw):
        CALLS[name] += 1
        return fn(*a, **kw)
    return call


for _name in CALLS:
    setattr(collectives, _name, counted(_name, getattr(collectives, _name)))

out = {}
dp = dtt.DataParallel(device="cpu")
runs = {}
for name, st in (("dp", dp),
                 ("tp1", dtt.DataTensorParallel(model_parallel=1,
                                                device="cpu")),
                 ("sp1", dtt.DataSeqParallel(seq_parallel=1, device="cpu"))):
    before = dict(CALLS)
    m = make(st, dtt.optim.Adam(1e-3), PARAMS["lm"], dict(flash=True))
    runs[name] = (fit(m, "lm"), full(m))
    if name == "tp1":
        lays = [layout_of(v) for v in m.live_params().values()]
        out["tp1_blocks"] = sorted({(lay.axis, lay.n) for lay in lays
                                    if lay is not None})
        out["tp1_hinted"] = sum(lay is not None for lay in lays)
        out["tp1_calls"] = {k: v - before[k] for k, v in CALLS.items()}
for name in ("tp1", "sp1"):
    out[name] = [runs[name][0] == runs["dp"][0],
                 same(runs[name][1], runs["dp"][1])]
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _jax_lm(**kw):
    return dtpu.models.transformer_lm(32, num_layers=2, d_model=32,
                                      num_heads=4, max_len=16, **kw)


def _jax_fit(strategy, module, opt, tx, ty, **compile_kw):
    with strategy.scope():
        m = dtpu.Model(module)
        m.compile(optimizer=opt, loss="sparse_categorical_crossentropy",
                  metrics=[], **compile_kw)
    m.build((16,), seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(m.params))
    shapes = dict(shard_shapes(m.params, "params"),
                  **shard_shapes(m.opt_state, "opt_state"))
    hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0)
    return m, start, shapes, hist.history["loss"]


def _flat(m):
    return dtt.interop.flatten_tree(jax.device_get(
        {"params": m.params, "opt_state": m.opt_state}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    tx, ty = lm_tokens()
    devs = jax.devices()[:4]

    def strategy():
        return dtpu.DataTensorParallel(devices=devs, model_parallel=2)

    jax_runs = {}
    jax_runs["sgd"] = _jax_fit(strategy(), _jax_lm(flash=True),
                               dtpu.optim.SGD(0.1), tx, ty)
    jax_runs["adam"] = _jax_fit(strategy(), _jax_lm(flash=True),
                                dtpu.optim.Adam(1e-3), tx, ty,
                                grad_clip=0.05)
    jax_runs["scan"] = _jax_fit(strategy(), _jax_lm(scan=True),
                                dtpu.optim.SGD(0.1), tx, ty)
    jm = jax_runs["sgd"][0]
    hints = jm.module.sharding_hints()
    estimates = {
        "f32": strategy().comm_bytes_estimate(jm.params, hints=hints),
        "bf16": strategy().comm_bytes_estimate(
            jm.params, compute_dtype=jax.numpy.bfloat16, hints=hints)}
    jax_gen = np.asarray(jm.generate(tx[:2, :5], 6, temperature=0.0))
    dtpu.ShardedCheckpointer(tmp / "jax").save(jm)
    jax_saved = _flat(jm)
    x, y = mnist_data(128)
    np.savez(tmp / "in.npz", x=x, y=y, tx=tx, ty=ty,
             **{f"l:{k}": v for k, v in jax_runs["sgd"][1].items()},
             **{f"s:{k}": v for k, v in jax_runs["scan"][1].items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     tmp / "jax", timeout=200)
    degenerate = run_pair(tmp, DEGENERATE, tmp / "in.npz", tmp / "deg")
    got = {}
    for name in ("sgd", "adam", "scan", "from_jax"):
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    with strategy().scope():
        back = dtpu.Model(_jax_lm(flash=True))
        back.compile(optimizer=dtpu.optim.SGD(0.1),
                     loss="sparse_categorical_crossentropy", metrics=[])
    back.build((16,), seed=1)
    back_step = dtpu.ShardedCheckpointer(tmp / "out_port").restore_into(back)
    return dict(port=port, degenerate=degenerate, got=got, tmp=tmp,
                jax={k: (_flat(v[0]), v[2], v[3])
                     for k, v in jax_runs.items()},
                estimates=estimates, jax_gen=jax_gen, jax_saved=jax_saved,
                back=(back_step, _flat(back)))


@pytest.mark.parametrize("run", ["sgd", "adam", "scan"])
def test_tp_matches_jax_tp(runs, run):
    want_flat, _, want_losses = runs["jax"][run]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[f"losses_{run}"], want_losses,
                                   rtol=1e-5)
    got = runs["got"][run]
    for path, v in want_flat.items():
        if not path.startswith("params/"):
            continue
        # Adam turns the rounding noise of bk's zero gradient into steps
        # of up to lr: held to its bound, 3 * lr after 3 steps.
        atol = 3e-3 if run == "adam" and path.endswith("/bk") else 1e-5
        np.testing.assert_allclose(got[path], v, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("run", ["sgd", "adam", "scan"])
def test_tp_shard_shapes_equal_jax(runs, run):
    want = runs["jax"][run][1]
    for row in runs["port"].values():
        assert row[f"shapes_{run}"] == want
    if run == "adam":
        mha = "residual/main/multi_head_attention"
        assert want[f"params/{mha}/wq"] == [32, 16]
        assert want[f"params/{mha}/wo"] == [16, 32]
        assert want[f"params/{mha}/bo"] == [32]
        assert want["params/residual_1/main/dense/bias"] == [64]
        assert want["params/embedding/table"] == [32, 32]
        assert want[f"opt_state/#1/#3/#0/#1/{mha}/wq"] == [32, 16]  # mu
    if run == "scan":
        blk = "scanned_blocks/blocks/residual/main/multi_head_attention"
        assert want[f"params/{blk}/wo"] == [2, 16, 32]  # row1
        assert want[f"params/{blk}/wq"] == [2, 32, 16]  # col


def test_tp_comm_bytes_estimate_equals_jax(runs):
    f32 = {k: int(v) for k, v in runs["estimates"]["f32"].items()}
    bf16 = {k: int(v) for k, v in runs["estimates"]["bf16"].items()}
    assert f32["activation_reduce_bytes_per_token_per_device"] > 0
    for row in runs["port"].values():
        assert row["estimate"] == f32
        assert row["estimate_bf16"] == bf16


def test_tp_replicated_leaves_identical(runs):
    for row in runs["port"].values():
        assert "embedding/table" in row["replicated"]
        assert "residual/main/multi_head_attention/bo" in row["replicated"]
        assert not any(p.endswith("/wq") for p in row["replicated"])


def test_tp_generate_matches_single_device_and_jax(runs):
    for row in runs["port"].values():
        assert row["gen_tp"] == row["gen_single"]
        np.testing.assert_array_equal(row["gen_tp"], runs["jax_gen"])


def test_tp_engine_serves_as_data_parallel(runs):
    for row in runs["port"].values():
        assert row["engine_tp"] == row["engine_dp"]


def test_tp_int8_predict_as_data_parallel(runs):
    for row in runs["port"].values():
        assert row["int8_same"]


def test_tp_checkpoints_cross_both_ways(runs):
    got = runs["got"]["from_jax"]
    assert set(got) == set(runs["jax_saved"])
    for path, v in runs["jax_saved"].items():
        np.testing.assert_array_equal(got[path], v, err_msg=path)
    step, flat = runs["back"]
    assert step == runs["port"][0]["saved_step"] == 3
    for path, v in flat.items():
        if path.startswith("params/"):
            np.testing.assert_array_equal(v, runs["got"]["sgd"][path],
                                          err_msg=path)
    for row in runs["port"].values():
        assert row["jax_step"] == 3
        assert row["dp_restore"] == [3, True]
        assert row["weights_same"]
    # Each Megatron block once: ranks 0 and 1 (data line 0) write wq's
    # column blocks, ranks 2 and 3 none of them.
    step_dir = runs["tmp"] / "out_port" / "ckpt-3"
    key = "params/residual/main/multi_head_attention/wq@0,16@32,16"
    with np.load(step_dir / "proc-1.npz") as z:
        assert key in z.files
    with np.load(step_dir / "proc-3.npz") as z:
        assert not any(k.startswith("params/residual/main/multi_head")
                       for k in z.files)


def test_tp_col_gather_and_row_split_paths(runs):
    for row in runs["port"].values():
        loss_rel, param_abs = row["mlp"]
        assert loss_rel <= 1e-5 and param_abs <= 1e-6, row["mlp"]


def test_tp_errors(runs):
    for r, row in runs["port"].items():
        assert row["coords"] == [r // 2, r % 2]
        assert row["mp3"] == "4 devices not divisible by model_parallel=3"
        assert "not yet ported (ROADMAP 1.3a)" in row["capturable"]


@pytest.mark.parametrize("strategy", ["tp1", "sp1"])
def test_degenerate_axes_bitwise_data_parallel(runs, strategy):
    for row in runs["degenerate"].values():
        assert row[strategy] == [True, True]


def test_degenerate_tp_runs_the_megatron_path(runs):
    # Each of the 2 layers stores wq/wk/wv/bq/bk/bv/wo and the MLP's col
    # kernel and bias and row kernel as blocks of one rank's line, and
    # each of the 3 steps' forwards copies attention's and the MLP's
    # inputs to the line and reduces wo's and the row kernel's outputs.
    for row in runs["degenerate"].values():
        assert row["tp1_blocks"] == [["model", 1]]
        assert row["tp1_hinted"] == 20
        assert row["tp1_calls"] == {"copy_to_group": 12,
                                    "reduce_from_group": 12}
