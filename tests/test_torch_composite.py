"""``CompositeParallel`` in the port, on 4 gloo ranks, against the JAX package.

One group of 4 worker processes runs the JAX tests' four combinations,
each against the JAX ``CompositeParallel`` of the same axes on
``jax.devices()[:4]``, from the same JAX-built parameters and batches (3
``fit`` steps of ``SGD(0.1)`` at batch 8): losses rtol 1e-5, parameters
atol 1e-5, and each rank's shape of every parameter and optimizer leaf
equals JAX's addressable shard's.

- data 1 x model 2 x pipe 2: a pipelined stack (split over "pipe") and a
  column-parallel head (split over "model") in one model;
- fsdp 2 x model 2: the LM's Megatron leaves split over both axes at once
  (a two-axis ``Layout``: the ZeRO-3 overlay on the Megatron block), the
  others over "fsdp";
- data 2 x seq 2: ring attention over the seq line, as
  ``DataSeqParallel``;
- data 1 x fsdp 2 x pipe 2: rows over ("data", "fsdp") while the stack
  pipelines; the stack is excluded from the fsdp overlay.

A sharded checkpoint of the fsdp x model ranks restores under
``DataParallel`` bit for bit. The constructor raises JAX's errors
(missing axes, an unknown axis, no batch axis, a bad attention mode),
counts the replicas over ("data", "fsdp"), and data x expert, outside
the ported combinations (these four and the pairs of
tests/test_torch_composite_pairs.py), raises "not yet ported" naming
ROADMAP 1.7.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, lm_tokens, run_ranks, shard_shapes

torch.set_num_threads(1)

COMBOS = {
    "dmp": {"data": 1, "model": 2, "pipe": 2},
    "fm": {"fsdp": 2, "model": 2},
    "ds": {"data": 2, "seq": 2},
    "dfp": {"data": 1, "fsdp": 2, "pipe": 2},
}

WORKER = WORKER_PRELUDE + '''
import json

COMBOS = json.loads(sys.argv[3])
P = {name: {k[len(name) + 1:]: data[k] for k in data.files
            if k.startswith(name + ":")} for name in COMBOS}


def pipe_tp_lm():
    n = dtt.nn
    from distributed_tpu_torch.models.transformer import transformer_block
    return n.Sequential([
        n.Embedding(32, 32), n.PositionalEmbedding(16),
        n.PipelinedBlocks(lambda: n.Sequential(
            transformer_block(32, 4, 128)), 2),
        n.LayerNorm(), n.Dense(32, shard="col")], name="pipe_tp_lm")


def module(name):
    if name in ("dmp", "dfp"):
        return pipe_tp_lm()
    return dtt.models.transformer_lm(32, num_layers=1, d_model=32,
                                     num_heads=4, max_len=16)


out = {}
for name, axes in COMBOS.items():
    st = dtt.CompositeParallel(axes, device="cpu")
    m = build(st, "lm", dtt.optim.SGD(0.1), module=module(name))
    dtt.interop.place(m, params=P[name])
    out["shapes_" + name] = local_shapes(m)
    out[name] = fit(m, "lm")
    flat = {k: v.detach().numpy() for k, v in m.params.items()}
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)
    if name == "fm":
        dtt.ShardedCheckpointer(sys.argv[2] + "_ck").save(m)
        d = build(dtt.DataParallel(device="cpu"), "lm", dtt.optim.SGD(0.1),
                  module=module(name))
        dtt.ShardedCheckpointer(sys.argv[2] + "_ck").restore_into(d)
        out["restore_same"] = same(full(m), full(d))
errors = {}
for key, args, kw in (("none", (), {}), ("unknown", ({"data": 2, "banana": 2},), {}),
                      ("batch", ({"model": 2, "pipe": 2},), {}),
                      ("mode", ({"data": 2, "seq": 2},),
                       {"seq_attention": "nope"}),
                      ("unported", ({"data": 2, "expert": 2},), {})):
    try:
        dtt.CompositeParallel(*args, device="cpu", **kw)
        errors[key] = None
    except (ValueError, NotImplementedError) as e:
        errors[key] = [type(e).__name__, str(e)]
out["errors"] = errors
s = dtt.CompositeParallel({"data": 2, "fsdp": 2}, device="cpu")
s2 = dtt.CompositeParallel({"data": 2, "model": 2}, device="cpu")
out["replicas"] = [s.num_replicas_in_sync, s.fsdp_axis,
                   s2.num_replicas_in_sync, s2.fsdp_axis, s2.model_axis]
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _pipe_tp_lm():
    from distributed_tpu.models.transformer import transformer_block
    n = dtpu.nn
    return n.Sequential([
        n.Embedding(32, 32), n.PositionalEmbedding(16),
        n.PipelinedBlocks(lambda: n.Sequential(
            transformer_block(32, 4, 128)), 2),
        n.LayerNorm(), n.Dense(32, shard="col")], name="pipe_tp_lm")


def _module(name):
    if name in ("dmp", "dfp"):
        return _pipe_tp_lm()
    return dtpu.models.transformer_lm(32, num_layers=1, d_model=32,
                                      num_heads=4, max_len=16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("composite")
    tx, ty = lm_tokens()
    devs = jax.devices()[:4]
    jax_runs, starts = {}, {}
    for name, axes in COMBOS.items():
        with dtpu.CompositeParallel(axes, devs).scope():
            m = dtpu.Model(_module(name))
            m.compile(optimizer=dtpu.optim.SGD(0.1),
                      loss="sparse_categorical_crossentropy", metrics=[])
        m.build((16,), seed=0)
        starts[name] = dtt.interop.flatten_tree(jax.device_get(m.params))
        shapes = dict(shard_shapes(m.params, "params"),
                      **shard_shapes(m.opt_state, "opt_state"))
        hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                     shuffle=True, seed=0, verbose=0)
        jax_runs[name] = (shapes, hist.history["loss"],
                          dtt.interop.flatten_tree(jax.device_get(m.params)))
    np.savez(tmp / "in.npz", x=np.zeros((1, 28, 28, 1), np.float32),
             y=np.zeros(1, np.int32), tx=tx, ty=ty,
             **{f"{n}:{k}": v for n, p in starts.items()
                for k, v in p.items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     json.dumps(COMBOS), timeout=300)
    got = {}
    for name in COMBOS:
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(port=port, got=got, jax=jax_runs)


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_composite_matches_jax(runs, name):
    shapes, want_losses, want = runs["jax"][name]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[name], want_losses, rtol=1e-5)
    got = runs["got"][name]
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_composite_shard_shapes_equal_jax(runs, name):
    want = runs["jax"][name][0]
    for row in runs["port"].values():
        assert row["shapes_" + name] == want
    if name == "fm":
        # wq (32, 32): "model" on its columns, "fsdp" on its rows.
        assert want["params/residual/main/multi_head_attention/wq"] == [16, 16]


def test_composite_checkpoint_restores_under_data_parallel(runs):
    for row in runs["port"].values():
        assert row["restore_same"]


def test_composite_construction_errors(runs):
    errors = runs["port"][0]["errors"]
    assert errors["none"][0] == "ValueError" and "axis sizes" in \
        errors["none"][1]
    assert "Unknown mesh axes" in errors["unknown"][1]
    assert "batch axis" in errors["batch"][1]
    assert "ring" in errors["mode"][1]
    assert errors["unported"][0] == "NotImplementedError"
    assert "not yet ported (ROADMAP 1.7)" in errors["unported"][1]
    assert runs["port"][0]["replicas"] == [4, "fsdp", 2, None, "model"]
    with pytest.raises(ValueError, match="axis sizes"):
        dtpu.CompositeParallel()
