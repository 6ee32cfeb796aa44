"""``DataSeqParallel`` in the port, on 4 gloo ranks, against the JAX package.

One group of 4 worker processes (the port's launcher) trains the LM (2
layers, d 32, 4 heads, vocab 32, T 16) under three strategies on the same
ranks: ring attention on data 2 x seq 2 (the zigzag schedule: causal, 8
positions a rank), Ulysses on data 2 x seq 2 with ``flash=True`` (K3-K5's
plain versions over the whole sequence for 2 heads a rank), and ring on
seq 4. The JAX side runs here on ``jax.devices()[:4]`` under the JAX
``DataSeqParallel`` of the same mesh and mode, from the same JAX-built
parameters and numpy batches.

- 3 ``fit`` steps of ``SGD(0.1)``: losses within rtol 1e-5 of JAX's,
  parameters within atol 1e-5; ring and Ulysses within rtol 1e-5 of each
  other.
- ``evaluate`` after training equals JAX's (rel 1e-5).
- Greedy ``generate`` of each SP-trained model equals the single-device
  port's on the same weights.
- ``PositionalEmbedding`` adds rank r's rows ``[r*T/s, (r+1)*T/s)``.
- A BatchNorm between two Dense layers on (B, T, C) inputs, data 2 x
  seq 2: sync-BN's statistics are the global batch's (every row and
  position, as JAX's), so 3 ``fit`` steps give JAX's losses (rtol 1e-5),
  parameters and running statistics (atol 1e-5).
- Errors: JAX's for heads that the seq axis does not divide (Ulysses) and
  for an attention mode other than "ring" or "ulysses"; Dropout under a
  seq axis keeps the rank's rows and positions of the global mask.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, lm_tokens, run_ranks

torch.set_num_threads(1)

RUNS = {"ring": (2, "ring", {}), "ulysses": (2, "ulysses", {"flash": True}),
        "ring4": (4, "ring", {})}

WORKER = WORKER_PRELUDE + '''
import json

RUNS = json.loads(sys.argv[3])


def lm4(**kw):
    return dtt.models.transformer_lm(32, num_layers=2, d_model=32,
                                     num_heads=4, max_len=16, **kw)


out = {"rank": spec.index}
for name, (seq, mode, kw) in RUNS.items():
    st = dtt.DataSeqParallel(seq_parallel=seq, attention=mode, device="cpu")
    m = build(st, "lm", dtt.optim.SGD(0.1), module=lm4(**kw))
    dtt.interop.place(m, params=PARAMS["lm"])
    out[f"losses_{name}"] = fit(m, "lm")
    out[f"eval_{name}"] = m.evaluate(TX[:16], TY[:16], batch_size=8,
                                     verbose=0)
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz",
                 **dtt.interop.params_to_numpy(m.params))
    prompt = TX[:2, :5]
    out[f"gen_{name}"] = m.generate(prompt, 6, temperature=0.0).tolist()
    single = dtt.Model(lm4(**kw), device="cpu").build((16,))
    single.load_params(full(m))
    out[f"gen_single_{name}"] = single.generate(prompt, 6,
                                                temperature=0.0).tolist()
    if name == "ring":
        pe = m.module.layers[1]
        with st.scope(), torch.no_grad():
            rows = pe(torch.zeros((1, 8, 32)))[0]
        table = m.params["positional_embedding/table"].detach()
        r = st.sp_rank
        out["offset"] = [st.seq_offset(8),
                         bool(torch.equal(rows, table[r * 8:(r + 1) * 8]))]
        drop = dtt.nn.Dropout(0.1)
        drop.train()
        key = np.zeros(2, np.uint32)
        with st.scope(), dtt.nn.core.rng_scope(key):
            kept = drop(torch.ones((1, 8, 32))) != 0
        whole = dtt.utils.threefry.bernoulli(key, 0.9, (2, 16, 32), "cpu")
        d = st.row_range(2)[0]
        out["dropout"] = bool(torch.equal(
            kept, whole[d:d + 1, r * 8:(r + 1) * 8]))
    if mode == "ulysses":
        attn = dtt.nn.MultiHeadAttention(3, head_dim=4)
        attn.build((8, 12), torch.Generator().manual_seed(0))
        try:
            with st.scope():
                attn(torch.zeros((1, 4, 12)))
            out["heads"] = None
        except ValueError as e:
            out["heads"] = str(e)

# Sync-BN over data x seq: the statistics of every row and position.
BN = np.load(sys.argv[4])
st = dtt.DataSeqParallel(seq_parallel=2, device="cpu")
with st.scope():
    m = dtt.Model(dtt.nn.Sequential([dtt.nn.Dense(8), dtt.nn.BatchNorm(),
                                     dtt.nn.Dense(5)]))
    m.compile(optimizer=dtt.optim.SGD(0.1), loss=LOSS, metrics=[])
m.build((16, 6))
dtt.interop.place(m, params={k[2:]: BN[k] for k in BN.files
                             if k[:2] == "p:"})
out["losses_bn"] = [float(v) for v in m.fit(
    BN["x"], BN["y"], batch_size=8, epochs=3, steps_per_epoch=1,
    shuffle=True, seed=0, verbose=0).history["loss"]]
if spec.is_chief:
    np.savez(f"{sys.argv[2]}_bn.npz", **dtt.interop.params_to_numpy(m.params),
             **{f"state/{k}": v.numpy() for k, v in m.state.items()})
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _jax_bn():
    n = dtpu.nn
    return n.Sequential([n.Dense(8), n.BatchNorm(), n.Dense(5)])


def _jax_lm(**kw):
    return dtpu.models.transformer_lm(32, num_layers=2, d_model=32,
                                      num_heads=4, max_len=16, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("sp")
    tx, ty = lm_tokens()
    devs = jax.devices()[:4]
    jax_runs, start = {}, None
    for name, (seq, mode, kw) in RUNS.items():
        with dtpu.DataSeqParallel(devices=devs, seq_parallel=seq,
                                  attention=mode).scope():
            m = dtpu.Model(_jax_lm(**kw))
            m.compile(optimizer=dtpu.optim.SGD(0.1),
                      loss="sparse_categorical_crossentropy", metrics=[])
        m.build((16,), seed=0)
        if start is None:
            start = dtt.interop.flatten_tree(jax.device_get(m.params))
        hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                     shuffle=True, seed=0, verbose=0)
        jax_runs[name] = dict(
            losses=hist.history["loss"],
            params=dtt.interop.flatten_tree(jax.device_get(m.params)),
            eval=m.evaluate(tx[:16], ty[:16], batch_size=8, verbose=0))
    bx = np.random.default_rng(5).standard_normal((32, 16, 6)).astype(
        np.float32)
    by = np.random.default_rng(6).integers(0, 5, (32, 16)).astype(np.int32)
    with dtpu.DataSeqParallel(devices=devs, seq_parallel=2).scope():
        m = dtpu.Model(_jax_bn())
        m.compile(optimizer=dtpu.optim.SGD(0.1),
                  loss="sparse_categorical_crossentropy", metrics=[])
    m.build((16, 6), seed=0)
    bn_start = dtt.interop.flatten_tree(jax.device_get(m.params))
    hist = m.fit(bx, by, batch_size=8, epochs=3, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0)
    jax_runs["bn"] = dict(
        losses=hist.history["loss"],
        params=dict(dtt.interop.flatten_tree(jax.device_get(m.params)),
                    **{f"state/{k}": v for k, v in dtt.interop.flatten_tree(
                        jax.device_get(m.state)).items()}))
    np.savez(tmp / "in.npz", x=np.zeros(1), y=np.zeros(1), tx=tx, ty=ty,
             **{f"l:{k}": v for k, v in start.items()})
    np.savez(tmp / "bn.npz", x=bx, y=by,
             **{f"p:{k}": v for k, v in bn_start.items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     json.dumps(RUNS), tmp / "bn.npz", timeout=200)
    got = {}
    for name in list(RUNS) + ["bn"]:
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(port=port, got=got, jax=jax_runs)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sp_matches_jax_sp(runs, run):
    want = runs["jax"][run]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[f"losses_{run}"], want["losses"],
                                   rtol=1e-5)
    for path, v in want["params"].items():
        np.testing.assert_allclose(runs["got"][run][path], v, rtol=0,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sp_evaluate_matches_jax(runs, run):
    want = runs["jax"][run]["eval"]
    for row in runs["port"].values():
        assert row[f"eval_{run}"]["loss"] == pytest.approx(want["loss"],
                                                           rel=1e-5)


def test_sp_batch_norm_matches_jax(runs):
    want = runs["jax"]["bn"]
    for row in runs["port"].values():
        np.testing.assert_allclose(row["losses_bn"], want["losses"],
                                   rtol=1e-5)
    assert sorted(runs["got"]["bn"]) == sorted(want["params"])
    for path, v in want["params"].items():
        np.testing.assert_allclose(runs["got"]["bn"][path], v, rtol=0,
                                   atol=1e-5, err_msg=path)


def test_ring_and_ulysses_agree(runs):
    for row in runs["port"].values():
        np.testing.assert_allclose(row["losses_ring"], row["losses_ulysses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sp_generate_matches_single_device(runs, run):
    for row in runs["port"].values():
        assert row[f"gen_{run}"] == row[f"gen_single_{run}"]


def test_positional_offsets(runs):
    for r, row in runs["port"].items():
        assert row["offset"] == [(r % 2) * 8, True]


def test_sp_errors(runs):
    for row in runs["port"].values():
        assert row["heads"] == (
            "Ulysses attention shards heads over the 'seq' axis: num_heads "
            "3 not divisible by its size 2")
        # Dropout runs: the rank's rows and positions of the global mask.
        assert row["dropout"] is True
    with pytest.raises(ValueError) as jax_err:
        dtpu.DataSeqParallel(seq_parallel=2, attention="flash")
    with pytest.raises(ValueError) as port_err:
        dtt.DataSeqParallel(seq_parallel=2, attention="flash", device="cpu")
    assert str(port_err.value) == str(jax_err.value)
