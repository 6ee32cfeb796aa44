"""``nn.MoE`` under a sequence split, on 4 gloo ranks, against the JAX package.

Under a sequence split a rank holds rows ``[r0, r0 + b)`` and positions
``[s0, s0 + T/s)`` of the batch, so its tokens are not one range of the
global token order that JAX's routing groups run over. The port gives
each rank its block of that order (``Strategy.token_layout``) and sums
the per-piece routing counts over the batch group, so every token gets
the slot JAX gives it. JAX runs here on ``jax.devices()[:4]``, from the
same JAX-built parameters and inputs.

- The layer alone: a (4, 16, 8) input, ``group_size`` 12, so groups
  straddle row and sequence blocks and the last of the 64 tokens' groups
  is padded; row 1 has sample weight 0; the router's experts 1 and 2 are
  equal, so their probabilities tie (the lower expert first); capacity 3
  a group of 12, so choices drop. Under ``DataSeqParallel`` data 2 x
  seq 2 and data 1 x seq 4, each rank's output block and the aux loss
  equal JAX's at atol 1e-5, and the ranks' kept choices sum to fewer
  than their routed ones.
- A one-MoE-layer LM (causal attention, ``group_size`` 12, capacity
  factor 0.5): 3 ``fit`` steps of ``SGD(0.1)`` at batch 8 under
  ``DataSeqParallel(seq_parallel=2)`` with ring and with Ulysses
  attention and under ``CompositeParallel({"data": 2, "seq": 2})``,
  against the JAX strategy of each: losses rtol 1e-5, parameters and the
  aux loss (the state) atol 1e-5, each rank's leaf shapes JAX's
  addressable shards'. ``evaluate`` over 12 rows (the last batch padded:
  rows of weight 0 route nothing) equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, lm_tokens, run_ranks, shard_shapes

torch.set_num_threads(1)

RUNS = ("ring", "ulysses", "composite")
LAYER_SPLITS = {"ds22": 2, "ds14": 4}

WORKER = WORKER_PRELUDE + '''
START = {k[2:]: data[k] for k in data.files if k[:2] == "p:"}
LAYER = {k[2:]: data[k] for k in data.files if k[:2] == "w:"}
LX, LW = data["lx"], data["lw"]


def moe_seq_lm():
    n = dtt.nn
    return n.Sequential([
        n.Embedding(32, 32), n.PositionalEmbedding(16),
        n.Residual(n.Sequential([n.LayerNorm(), n.MultiHeadAttention(
            4, causal=True)], name="attn")),
        n.Residual(n.Sequential([n.LayerNorm(), n.MoE(
            4, 32, capacity_factor=0.5, group_size=12)], name="main")),
        n.LayerNorm(), n.Dense(32)])


def strategy(name):
    if name == "composite":
        return dtt.CompositeParallel({"data": 2, "seq": 2}, device="cpu")
    return dtt.DataSeqParallel(seq_parallel=2, attention=name, device="cpu")


out = {}
for key, s in (("ds22", 2), ("ds14", 4)):
    st = dtt.DataSeqParallel(seq_parallel=s, device="cpu")
    layer = dtt.nn.MoE(4, 16, capacity_factor=0.5, group_size=12)
    layer.build((16, 8), torch.Generator().manual_seed(0))
    for k, v in LAYER.items():
        getattr(layer, k).data.copy_(torch.from_numpy(v))
    b = LX.shape[0] // (4 // s)
    lo, _ = st.row_range(LX.shape[0])
    x = st.shard_seq(torch.from_numpy(LX[lo:lo + b]))
    with st.scope(), dtt.nn.moe.sample_weights(torch.from_numpy(
            LW[lo:lo + b])), torch.no_grad():
        y = layer(x)
    out["layer_" + key] = [lo, st.seq_offset(x.shape[1]),
                           y.numpy().tolist()]
    out["aux_" + key] = float(layer.aux_term)
    out["routed_" + key] = layer.routed.tolist()
for name in ("ring", "ulysses", "composite"):
    m = build(strategy(name), "lm", dtt.optim.SGD(0.1), module=moe_seq_lm())
    dtt.interop.place(m, params=START)
    out["shapes_" + name] = local_shapes(m)
    out[name] = fit(m, "lm")
    if name == "ring":
        out["eval"] = m.evaluate(TX[:12], TY[:12], batch_size=8,
                                 verbose=0)["loss"]
    flat = {"params/" + k: v.detach().numpy() for k, v in m.params.items()}
    flat.update({"state/" + k: v.detach().numpy()
                 for k, v in m.state.items()})
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _moe_seq_lm():
    n = dtpu.nn
    return n.Sequential([
        n.Embedding(32, 32), n.PositionalEmbedding(16),
        n.Residual(n.Sequential([n.LayerNorm(), n.MultiHeadAttention(
            4, causal=True)], name="attn")),
        n.Residual(n.Sequential([n.LayerNorm(), n.MoE(
            4, 32, capacity_factor=0.5, group_size=12)], name="main")),
        n.LayerNorm(), n.Dense(32)])


def _jax_strategy(name, devs):
    if name == "composite":
        return dtpu.CompositeParallel({"data": 2, "seq": 2}, devs)
    return dtpu.DataSeqParallel(devs, seq_parallel=2, attention=name)


def _jax_layer():
    """The MoE layer's JAX output and aux loss on a seeded input, with a
    zero-weight row and tied router columns."""
    from distributed_tpu.nn.core import eval_sample_weights

    layer = dtpu.nn.MoE(4, 16, capacity_factor=0.5, group_size=12)
    params, state, _ = layer.init(jax.random.PRNGKey(0), (16, 8))
    params = dict(params, router=params["router"].at[:, 2].set(
        params["router"][:, 1]))
    x = np.random.default_rng(5).normal(size=(4, 16, 8)).astype(np.float32)
    w = np.array([1, 0, 1, 1], np.float32)
    with eval_sample_weights(jnp.asarray(w)):
        y, st = layer.apply(params, state, jnp.asarray(x))
    return ({k: np.asarray(v) for k, v in params.items()}, x, w,
            np.asarray(y), float(st["aux_loss"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_seq")
    tx, ty = lm_tokens()
    devs = jax.devices()[:4]
    jax_runs, start = {}, None
    for name in RUNS:
        with _jax_strategy(name, devs).scope():
            m = dtpu.Model(_moe_seq_lm())
            m.compile(optimizer=dtpu.optim.SGD(0.1),
                      loss="sparse_categorical_crossentropy", metrics=[])
        m.build((16,), seed=0)
        start = dtt.interop.flatten_tree(jax.device_get(m.params))
        shapes = dict(shard_shapes(m.params, "params"),
                      **shard_shapes(m.opt_state, "opt_state"))
        hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                     shuffle=True, seed=0, verbose=0)
        jax_runs[name] = (shapes, hist.history["loss"],
                          dtt.interop.flatten_tree(jax.device_get(
                              {"params": m.params, "state": m.state})))
        if name == "ring":
            jax_eval = m.evaluate(tx[:12], ty[:12], batch_size=8,
                                  verbose=0)["loss"]
    lp, lx, lw, ly, laux = _jax_layer()
    np.savez(tmp / "in.npz", x=np.zeros((1, 28, 28, 1), np.float32),
             y=np.zeros(1, np.int32), tx=tx, ty=ty, lx=lx, lw=lw,
             **{f"p:{k}": v for k, v in start.items()},
             **{f"w:{k}": v for k, v in lp.items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     timeout=300)
    got = {}
    for name in RUNS:
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(port=port, got=got, jax=jax_runs, eval=jax_eval,
                layer=(ly, laux))


@pytest.mark.parametrize("split", sorted(LAYER_SPLITS))
def test_moe_layer_block_matches_jax_global_routing(runs, split):
    want, aux = runs["layer"]
    s = LAYER_SPLITS[split]
    kept = routed = 0
    for row in runs["port"].values():
        lo, off, y = row["layer_" + split]
        y = np.asarray(y)
        b, t = y.shape[:2]
        assert t == 16 // s
        np.testing.assert_allclose(y, want[lo:lo + b, off:off + t],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(row["aux_" + split], aux, rtol=1e-5)
        kept += row["routed_" + split][0]
        routed += row["routed_" + split][1]
    # Row 1 routes nothing (3 valid rows x 16 tokens x 2 choices), and
    # the capacity (3 a group of 12) drops choices.
    assert routed == 3 * 16 * 2
    assert kept < routed
    assert dtt.nn.MoE(4, 16, capacity_factor=0.5,
                      group_size=12)._capacity(12) == 3


@pytest.mark.parametrize("run", RUNS)
def test_moe_seq_fit_matches_jax(runs, run):
    shapes, want_losses, want = runs["jax"][run]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[run], want_losses, rtol=1e-5)
        assert row["shapes_" + run] == shapes
    got = runs["got"][run]
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)


def test_moe_seq_evaluate_with_padded_rows_matches_jax(runs):
    for row in runs["port"].values():
        np.testing.assert_allclose(row["eval"], runs["eval"], rtol=1e-5)
