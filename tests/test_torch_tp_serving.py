"""``serving.Engine`` under tensor parallelism, on 4 gloo ranks, against JAX.

One group of 4 worker processes (the port's launcher, data 2 x model 2)
serves the LM (2 layers, d 32, 4 heads, vocab 32, max_len 16) with
``Engine(max_slots=2, block_size=4, max_len=16)`` built on a
``DataTensorParallel(model_parallel=2)`` model; the JAX ``Engine`` runs
here on ``jax.devices()[:4]`` under the JAX ``DataTensorParallel(
model_parallel=2)``, from the same JAX-built parameters. Greedy, f32:

- tokens equal JAX's, exactly, with plain pools, int8 KV, the prefix
  cache with ``prefill_chunk=4``, ``decode_kernel="fused"`` (the plain
  K1 over each rank's 2-head pools), a TP-built 1-layer draft at
  ``spec_k=3`` (tokens only: the reference's acceptance counts vary from
  run to run), int8 weights (``quant.quantize_model``), after
  ``update_weights`` with a whole tree of other weights (JAX's engine
  built on those), and under ``CompositeParallel({"data": 2, "model":
  2})``;
- each rank's served leaves and pool leaves have JAX's addressable shard
  shapes (``wq`` (32, 16), pools (9, 4, 2, 8)): the snapshot gathers
  nothing, an int8 weight's ``q`` is a block (the scale of a "row"
  weight is whole, where JAX splits it);
- every rank returns the same tokens, and the paged paths run Megatron's
  pair twice a block per dispatch;
- 2 heads on a model line of 4 raise the layer's error.

And the gang's teardown: 2 ranks form ``DataExpertParallel`` and
``CompositeParallel`` sub-groups, run a collective on each and call
``cluster.shutdown()``; both exit 0, and no gloo worker thread
(``pt_gloo_runloop``) is left after it.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import (WORKER_PRELUDE, jax_engine, lm_tokens, run_pair,
                          run_ranks, shard_shapes)

torch.set_num_threads(1)

WORKER = WORKER_PRELUDE + '''
from distributed_tpu_torch.parallel import collectives

NEW = {k[2:]: data[k] for k in data.files if k[:2] == "n:"}
DRAFT = {k[2:]: data[k] for k in data.files if k[:2] == "d:"}
PROMPTS = [(TX[i, :6], 4) for i in range(3)]
SHARED = [(np.concatenate([TX[0, :8], TX[i, :2]]), 4) for i in range(3)]
CALLS = {"copy_to_group": 0, "reduce_from_group": 0}


def counted(name, fn):
    def call(*a, **kw):
        CALLS[name] += 1
        return fn(*a, **kw)
    return call


for _name in CALLS:
    setattr(collectives, _name, counted(_name, getattr(collectives, _name)))


def lm4(layers=2, heads=4):
    return dtt.models.transformer_lm(32, num_layers=layers, d_model=32,
                                     num_heads=heads, max_len=16)


def make(st, params, **kw):
    m = build(st, "lm", dtt.optim.SGD(0.1), module=lm4(**kw))
    if params is not None:
        dtt.interop.place(m, params=params)
    return m


def engine(m, **kw):
    return dtt.serving.Engine(m, max_slots=2, block_size=4, max_len=16, **kw)


def tokens(e, prompts=PROMPTS):
    return [t.tolist() for t in e.run(prompts)]


def shapes(served):
    return {"params/" + k: list(v.shape) for k, v in served.params.items()}


def pools(kv):
    return sorted(list(v.shape) for v in
                  dtt.interop.flatten_tree(kv.caches).values())


out = {}
tp = dtt.DataTensorParallel(model_parallel=2, device="cpu")
m = make(tp, PARAMS["lm"])
for k in CALLS:
    CALLS[k] = 0
e = engine(m)
out["plain"] = tokens(e)
tel = e.last_run_telemetry
out["pair"] = [dict(CALLS), tel["decode_steps"] + tel["prefill_dispatches"]]
out["served"] = shapes(e._target)
out["pool"] = pools(e.kv)
e = engine(m, kv_dtype="int8")
out["int8_kv"] = tokens(e)
out["pool_int8"] = pools(e.kv)
e = engine(m, prefix_cache=True, prefill_chunk=4)
out["prefix"] = tokens(e, SHARED)
out["prefix_hits"] = e.last_run_telemetry["prefix_cache"]["hit_blocks"]
out["fused"] = tokens(engine(m, decode_kernel="fused"))
e = engine(m, draft_model=make(tp, DRAFT, layers=1), spec_k=3)
out["spec"] = tokens(e)
out["draft_served"] = shapes(e._draft_served)
e = engine(m)
e.update_weights(NEW)
out["swapped"] = tokens(e)
q = make(tp, PARAMS["lm"])
dtt.quant.quantize_model(q)
e = engine(q)
out["int8_w"] = tokens(e)
out["served_int8"] = shapes(e._target)
cp = dtt.CompositeParallel({"data": 2, "model": 2}, device="cpu")
e = engine(make(cp, PARAMS["lm"]))
out["composite"] = tokens(e)
out["served_cp"] = shapes(e._target)
try:
    engine(make(dtt.DataTensorParallel(model_parallel=4, device="cpu"),
                None, heads=2))
    out["heads"] = None
except ValueError as err:
    out["heads"] = str(err)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''

TEARDOWN = '''
import os

import torch

torch.set_num_threads(1)
import torch.distributed as dist

import distributed_tpu_torch as dtt

def threads():
    return sorted(open(f"/proc/self/task/{t}/comm").read().strip()
                  for t in os.listdir("/proc/self/task"))


before = threads()
dtt.cluster.initialize(device="cpu", timeout=60)
ep = dtt.DataExpertParallel(expert_parallel=2, device="cpu")
cp = dtt.CompositeParallel({"data": 1, "model": 2}, device="cpu")
# No reference to a group outlives the loop: a group the caller holds
# keeps its workers.
for name in ("ep_group", "tp_group", "_rows", "_batch_group"):
    dist.all_reduce(torch.ones(1),
                    group=getattr(ep if name == "ep_group" else cp, name))
dtt.cluster.shutdown()
dtt.launch.report_result([before, threads()])
'''


def _jax_lm(seed, layers=2):
    strategy = dtpu.DataTensorParallel(devices=jax.devices()[:4],
                                       model_parallel=2)
    with strategy.scope():
        m = dtpu.Model(dtpu.models.transformer_lm(
            32, num_layers=layers, d_model=32, num_heads=4, max_len=16))
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=[])
    return m.build((16,), seed=seed)


def _flat(m):
    return dtt.interop.flatten_tree(jax.device_get(m.params))


def _serve(m, prompts, **kw):
    e = jax_engine(m, max_slots=2, block_size=4, max_len=16, **kw)
    return e, [np.asarray(t).tolist() for t in e.run(prompts)]


def _pools(e):
    return sorted(shard_shapes(e.kv.caches, "pool").values())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    tx, ty = lm_tokens()
    prompts = [(tx[i, :6], 4) for i in range(3)]
    shared = [(np.concatenate([tx[0, :8], tx[i, :2]]), 4) for i in range(3)]
    jm, jn, jd = _jax_lm(0), _jax_lm(1), _jax_lm(2, layers=1)
    want = {}
    e, want["plain"] = _serve(jm, prompts)
    want["pool"] = _pools(e)
    e, want["int8_kv"] = _serve(jm, prompts, kv_dtype="int8")
    want["pool_int8"] = _pools(e)
    _, want["prefix"] = _serve(jm, shared, prefix_cache=True,
                               prefill_chunk=4)
    _, want["spec"] = _serve(jm, prompts, draft_model=jd, spec_k=3)
    _, want["swapped"] = _serve(jn, prompts)
    want["served"] = shard_shapes(jm.params, "params")
    want["draft_served"] = shard_shapes(jd.params, "params")
    jq = _jax_lm(0)
    dtpu.quant.quantize_model(jq)
    _, want["int8_w"] = _serve(jq, prompts)
    want["served_int8"] = shard_shapes(jq.params, "params")
    np.savez(tmp / "in.npz", x=np.zeros(1), y=np.zeros(1), tx=tx, ty=ty,
             **{f"l:{k}": v for k, v in _flat(jm).items()},
             **{f"n:{k}": v for k, v in _flat(jn).items()},
             **{f"d:{k}": v for k, v in _flat(jd).items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", timeout=200)
    return dict(port=port, want=want)


@pytest.mark.parametrize("case", ["plain", "int8_kv", "prefix", "spec",
                                  "swapped", "int8_w"])
def test_tp_engine_tokens_equal_jax(runs, case):
    for row in runs["port"].values():
        assert row[case] == runs["want"][case], case


@pytest.mark.parametrize("case", ["fused", "composite"])
def test_tp_engine_fused_and_composite_equal_jax(runs, case):
    for row in runs["port"].values():
        assert row[case] == runs["want"]["plain"], case


def test_tp_engine_prefix_cache_hits(runs):
    for row in runs["port"].values():
        assert row["prefix_hits"] > 0


@pytest.mark.parametrize("served,want", [
    ("served", "served"), ("served_cp", "served"),
    ("draft_served", "draft_served")])
def test_tp_served_leaves_are_jax_shards(runs, served, want):
    shapes = runs["want"][want]
    mha = "params/residual/main/multi_head_attention"
    assert shapes[f"{mha}/wq"] == [32, 16]
    for row in runs["port"].values():
        assert row[served] == shapes


def test_tp_int8_weights_stored_as_blocks(runs):
    want = runs["want"]["served_int8"]
    mha = "params/residual/main/multi_head_attention"
    assert want[f"{mha}/wq/q"] == [32, 16]
    assert want[f"{mha}/wo/q"] == [16, 32]
    for row in runs["port"].values():
        got = row["served_int8"]
        assert set(got) == set(want)
        for path, shape in got.items():
            if path.endswith("/wo/scale") or (
                    path.endswith("/scale") and "dense_1" in path):
                # A "row" weight's per-output-channel scale is whole here
                # (it factors out of the row sum); JAX splits it.
                assert shape == [2 * want[path][0]], path
            else:
                assert shape == want[path], path


@pytest.mark.parametrize("pool", ["pool", "pool_int8"])
def test_tp_pools_hold_the_ranks_heads(runs, pool):
    want = runs["want"][pool]
    assert [9, 4, 2, 8] in want
    for row in runs["port"].values():
        assert row[pool] == want


def test_tp_ranks_agree_and_run_the_megatron_pair(runs):
    rows = list(runs["port"].values())
    for row in rows[1:]:
        for case in ("plain", "int8_kv", "prefix", "fused", "spec",
                     "swapped", "int8_w", "composite"):
            assert row[case] == rows[0][case], case
    for row in rows:
        calls, dispatches = row["pair"]
        assert calls == {"copy_to_group": 2 * 2 * dispatches,
                         "reduce_from_group": 2 * 2 * dispatches}


def test_tp_engine_heads_not_divisible_raise(runs):
    for row in runs["port"].values():
        assert row["heads"] == ("num_heads 2 not divisible by the model "
                                "axis size 4")


def test_gang_teardown_joins_every_gloo_worker(tmp_path):
    rows = run_pair(tmp_path, TEARDOWN, timeout=60)
    for before, after in rows.values():
        assert "pt_gloo_runloop" not in before
        assert "pt_gloo_runloop" not in after, after
