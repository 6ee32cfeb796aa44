"""``CompositeParallel``'s remaining axis pairs, on 4 gloo ranks, against JAX.

One group of 4 worker processes runs each pair against the JAX
``CompositeParallel`` of the same axes on ``jax.devices()[:4]``, from the
same JAX-built parameters and batches (3 ``fit`` steps of ``SGD(0.1)`` at
batch 8): losses rtol 1e-5, parameters and the state atol 1e-5, and each
rank's shape of every parameter and optimizer leaf equals JAX's
addressable shard's.

- seq x model (data 1): ring attention over the seq line at this rank's
  model coordinate, on its H/m heads; and with Ulysses at H 4, m 2, s 2;
- fsdp x seq: rows over fsdp, positions over seq; an fsdp leaf's
  gradient arrives reduce-scattered over fsdp and is summed over seq;
- expert x model (data 1): an MoE LM whose attention is Megatron-split
  and whose expert stacks split over the expert line only;
- expert x seq (data 1): the MoE routes the global token order of a
  sequence split (``Strategy.token_layout``) on each expert rank;
- expert x fsdp: the expert stacks split over expert, then fsdp (a
  two-axis ``Layout``), the rows over fsdp;
- expert x pipe (data 1): a pipelined stack with an MoE after it (an MoE
  inside the stack raises in both packages).

A mesh that splits both seq and pipe raises in both packages: JAX's fit
fails in the pipeline's ``shard_map`` and the port refuses it at
construction. Data x expert stays "not yet ported" (ROADMAP 1.7).
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, lm_tokens, run_ranks, shard_shapes

torch.set_num_threads(1)

# name: (axes, keywords, model)
CASES = {
    "seq_model": ({"data": 1, "seq": 2, "model": 2}, {}, "lm"),
    "seq_model_ulysses": ({"data": 1, "seq": 2, "model": 2},
                          {"seq_attention": "ulysses"}, "lm"),
    "fsdp_seq": ({"fsdp": 2, "seq": 2}, {}, "lm"),
    "expert_model": ({"data": 1, "expert": 2, "model": 2}, {}, "moe"),
    "expert_seq": ({"data": 1, "expert": 2, "seq": 2}, {}, "moe"),
    "expert_fsdp": ({"fsdp": 2, "expert": 2}, {}, "moe"),
    "expert_pipe": ({"data": 1, "expert": 2, "pipe": 2}, {}, "pipe_moe"),
}

WORKER = WORKER_PRELUDE + '''
import json

CASES = json.loads(sys.argv[3])
P = {name: {k[len(name) + 1:]: data[k] for k in data.files
            if k.startswith(name + ":")} for name in CASES}


def module(kind):
    n = dtt.nn
    if kind == "pipe_moe":
        from distributed_tpu_torch.models.transformer import (
            transformer_block)
        return n.Sequential([
            n.Embedding(32, 32), n.PositionalEmbedding(16),
            n.PipelinedBlocks(lambda: n.Sequential(
                transformer_block(32, 4, 128)), 2),
            n.Residual(n.Sequential([n.LayerNorm(), n.MoE(4, 32)],
                                    name="main")),
            n.LayerNorm(), n.Dense(32, shard="col")], name="pipe_moe_lm")
    return dtt.models.transformer_lm(
        32, num_layers=1, d_model=32, num_heads=4, max_len=16,
        **({"moe_experts": 4, "moe_every": 1} if kind == "moe" else {}))


out = {}
for name, (axes, kw, kind) in CASES.items():
    st = dtt.CompositeParallel(axes, device="cpu", **kw)
    m = build(st, "lm", dtt.optim.SGD(0.1), module=module(kind))
    dtt.interop.place(m, params=P[name])
    out["shapes_" + name] = local_shapes(m)
    out[name] = fit(m, "lm")
    flat = {"params/" + k: v.detach().numpy() for k, v in m.params.items()}
    flat.update({"state/" + k: v.detach().numpy()
                 for k, v in m.state.items()})
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)
errors = {}
for key, axes in (("seq_pipe", {"data": 1, "seq": 2, "pipe": 2}),
                  ("unported", {"data": 2, "expert": 2})):
    try:
        dtt.CompositeParallel(axes, device="cpu")
        errors[key] = None
    except (ValueError, NotImplementedError) as e:
        errors[key] = [type(e).__name__, str(e)]
out["errors"] = errors
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _module(kind):
    n = dtpu.nn
    if kind == "pipe_moe":
        from distributed_tpu.models.transformer import transformer_block
        return n.Sequential([
            n.Embedding(32, 32), n.PositionalEmbedding(16),
            n.PipelinedBlocks(lambda: n.Sequential(
                transformer_block(32, 4, 128)), 2),
            n.Residual(n.Sequential([n.LayerNorm(), n.MoE(4, 32)],
                                    name="main")),
            n.LayerNorm(), n.Dense(32, shard="col")], name="pipe_moe_lm")
    return dtpu.models.transformer_lm(
        32, num_layers=1, d_model=32, num_heads=4, max_len=16,
        **({"moe_experts": 4, "moe_every": 1} if kind == "moe" else {}))


def _jax_model(axes, kw, kind, devs):
    with dtpu.CompositeParallel(axes, devs, **kw).scope():
        m = dtpu.Model(_module(kind))
        m.compile(optimizer=dtpu.optim.SGD(0.1),
                  loss="sparse_categorical_crossentropy", metrics=[])
    m.build((16,), seed=0)
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("composite_pairs")
    tx, ty = lm_tokens()
    devs = jax.devices()[:4]
    jax_runs, starts = {}, {}
    for name, (axes, kw, kind) in CASES.items():
        m = _jax_model(axes, kw, kind, devs)
        starts[name] = dtt.interop.flatten_tree(jax.device_get(m.params))
        shapes = dict(shard_shapes(m.params, "params"),
                      **shard_shapes(m.opt_state, "opt_state"))
        hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                     shuffle=True, seed=0, verbose=0)
        jax_runs[name] = (shapes, hist.history["loss"],
                          dtt.interop.flatten_tree(jax.device_get(
                              {"params": m.params, "state": m.state})))
    np.savez(tmp / "in.npz", x=np.zeros((1, 28, 28, 1), np.float32),
             y=np.zeros(1, np.int32), tx=tx, ty=ty,
             **{f"{n}:{k}": v for n, p in starts.items()
                for k, v in p.items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     json.dumps(CASES), timeout=300)
    got = {}
    for name in CASES:
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(port=port, got=got, jax=jax_runs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_composite_pair_matches_jax(runs, name):
    _, want_losses, want = runs["jax"][name]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[name], want_losses, rtol=1e-5)
    got = runs["got"][name]
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_composite_pair_shard_shapes_equal_jax(runs, name):
    want = runs["jax"][name][0]
    for row in runs["port"].values():
        assert row["shapes_" + name] == want
    if name == "expert_fsdp":
        # (E, D, H) = (4, 32, 128): "expert" on dim 0, "fsdp" on dim 2.
        assert want["params/residual_1/main/moe/w_in"] == [2, 32, 64]
    if name == "expert_model":
        assert want["params/residual_1/main/moe/w_in"] == [2, 32, 128]
        assert want["params/residual/main/multi_head_attention/wq"] == [
            32, 16]


def test_seq_pipe_raises_in_both_packages(runs):
    kind, msg = runs["port"][0]["errors"]["seq_pipe"]
    assert kind == "ValueError"
    assert "JAX package cannot run" in msg
    m = _jax_model({"data": 1, "seq": 2, "pipe": 2}, {}, "pipe_moe",
                   jax.devices()[:4])
    tx, ty = lm_tokens()
    with pytest.raises(ValueError, match="shard_map"):
        m.fit(tx, ty, batch_size=8, epochs=1, steps_per_epoch=1,
              verbose=0)


def test_data_expert_composite_still_unported(runs):
    kind, msg = runs["port"][0]["errors"]["unported"]
    assert kind == "NotImplementedError"
    assert "not yet ported (ROADMAP 1.7)" in msg
