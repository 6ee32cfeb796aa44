"""``data.Pipeline(shard="auto")`` under strategies whose batch axis is not
the world, on 4 gloo ranks, against the JAX strategy fed the host-global
batch.

JAX's "auto" is ``(process index, process count)``: a TPU host holds
whole model lines. The port runs one process a card, so "auto" gives
this rank's coordinate on the strategy's row line and the number of row
shards (``Strategy.row_shard``): the ranks of one model or seq line read
the same rows, and under a sequence split each cuts its positions from
them. A pipeline built outside the strategy's scope with "auto" is
resharded to the row line by the ``fit``, ``evaluate`` or ``predict`` it
is handed to.

The model reads (B, 28, 28) uint8 image rows as 28 positions of 28
features (a Dense, positions, bidirectional attention, a 10-way head per
position) and takes the cross-entropy of every position against its
row's label, so a sequence split has positions to split. Under
``DataTensorParallel(model_parallel=2)`` (data 2 x model 2) and
``CompositeParallel({"data": 2, "seq": 2})``, each from JAX-built
parameters:

- a pipeline built inside the scope gives ``(row coordinate, 2)``; one
  built outside gives ``(rank, 4)`` and is ``(row coordinate, 2)`` after
  ``predict``; ``reshard("auto")`` in the scope gives it too;
- 2 epochs of ``fit`` (4 steps each, ``SGD(0.1)``) from the sharded
  pipeline match JAX's from the unsharded one: losses rtol 1e-5,
  parameters atol 1e-5;
- ``predict`` from a sharded pipeline returns every row on every rank,
  within rtol 1e-5 of JAX's; ``evaluate`` matches JAX's at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, run_ranks

torch.set_num_threads(1)

BATCH = 16
RUNS = ("tp", "ds")


def images(n=64):
    x, y = dtt.data.synthetic_images(n, (28, 28), 10, 4)
    return x.astype(np.uint8), y.astype(np.int32)


WORKER = WORKER_PRELUDE + '''
X8, Y8 = data["x8"], data["y8"]
START = {k[2:]: data[k] for k in data.files if k[:2] == "p:"}


def module():
    n = dtt.nn
    return n.Sequential([
        n.Dense(32), n.PositionalEmbedding(28),
        n.Residual(n.Sequential([n.LayerNorm(), n.MultiHeadAttention(4)],
                                name="attn")),
        n.LayerNorm(), n.Dense(10)])


def loss(logits, y):
    return dtt.ops.losses.sparse_categorical_crossentropy(
        logits, y[:, None].expand(logits.shape[:2]))


def pipe(shard, shuffle=False):
    return dtt.data.Pipeline(X8, Y8, ''' + str(BATCH) + ''', shard=shard,
                             shuffle=shuffle, seed=3, use_native=False)


out = {}
for name in ("tp", "ds"):
    st = (dtt.DataTensorParallel(model_parallel=2, device="cpu")
          if name == "tp" else
          dtt.CompositeParallel({"data": 2, "seq": 2}, device="cpu"))
    with st.scope():
        m = dtt.Model(module())
        m.compile(optimizer=dtt.optim.SGD(0.1), loss=loss, metrics=[])
        train = pipe("auto", shuffle=True)
    m.build((28, 28))
    dtt.interop.place(m, params=START)
    out["inside_" + name] = list(train.shard)
    out[name] = [float(v) for v in
                 m.fit(train, epochs=2, verbose=0).history["loss"]]
    outside = pipe("auto")
    out["outside_" + name] = list(outside.shard)
    np.save(f"{sys.argv[2]}_{name}_{spec.index}.npy", m.predict(outside))
    out["after_" + name] = list(outside.shard)
    out["eval_" + name] = m.evaluate(pipe("auto"), verbose=0)["loss"]
    again = pipe((spec.index, 4))
    with st.scope():
        again.reshard("auto")
    out["reshard_" + name] = list(again.shard)
    for p in (train, outside, again):
        p.close()
    flat = {k: v.detach().numpy() for k, v in m.params.items()}
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _module():
    n = dtpu.nn
    return n.Sequential([
        n.Dense(32), n.PositionalEmbedding(28),
        n.Residual(n.Sequential([n.LayerNorm(), n.MultiHeadAttention(4)],
                                name="attn")),
        n.LayerNorm(), n.Dense(10)])


def _loss(logits, y):
    return dtpu.ops.losses.sparse_categorical_crossentropy(
        logits, jnp.broadcast_to(y[:, None], logits.shape[:2]))


def _pipe(x8, y8, shuffle=False):
    return dtpu.data.Pipeline(x8, y8, BATCH, shuffle=shuffle, seed=3,
                              use_native=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_auto")
    x8, y8 = images()
    devs = jax.devices()[:4]
    jax_runs, start = {}, None
    for name in RUNS:
        st = (dtpu.DataTensorParallel(devs, model_parallel=2)
              if name == "tp" else
              dtpu.CompositeParallel({"data": 2, "seq": 2}, devs))
        with st.scope():
            m = dtpu.Model(_module())
            m.compile(optimizer=dtpu.optim.SGD(0.1), loss=_loss,
                      metrics=[])
        m.build((28, 28), seed=0)
        start = dtt.interop.flatten_tree(jax.device_get(m.params))
        with _pipe(x8, y8, shuffle=True) as train:
            losses = m.fit(train, epochs=2, verbose=0).history["loss"]
        with _pipe(x8, y8) as p:
            logits = np.asarray(m.predict(p))
        with _pipe(x8, y8) as p:
            ev = m.evaluate(p, verbose=0)["loss"]
        jax_runs[name] = (losses, logits, ev, dtt.interop.flatten_tree(
            jax.device_get(m.params)))
    np.savez(tmp / "in.npz", x=np.zeros(1), y=np.zeros(1), tx=np.zeros(1),
             ty=np.zeros(1), x8=x8, y8=y8,
             **{f"p:{k}": v for k, v in start.items()})
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     timeout=300)
    got = {}
    for name in RUNS:
        with np.load(tmp / f"out_{name}.npz") as z:
            params = {k: z[k] for k in z.files}
        got[name] = (params, [np.load(tmp / f"out_{name}_{r}.npy")
                              for r in range(4)])
    return dict(port=port, got=got, jax=jax_runs)


@pytest.mark.parametrize("name", RUNS)
def test_auto_shard_is_the_row_line(runs, name):
    for r, row in runs["port"].items():
        assert row["inside_" + name] == [r // 2, 2]
        assert row["outside_" + name] == [r, 4]
        assert row["after_" + name] == [r // 2, 2]
        assert row["reshard_" + name] == [r // 2, 2]


@pytest.mark.parametrize("name", RUNS)
def test_auto_shard_fit_matches_jax(runs, name):
    want_losses, _, _, want = runs["jax"][name]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[name], want_losses, rtol=1e-5)
    params = runs["got"][name][0]
    assert set(params) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(params[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", RUNS)
def test_auto_shard_predict_and_evaluate_match_jax(runs, name):
    _, logits, ev, _ = runs["jax"][name]
    ranks = runs["got"][name][1]
    assert ranks[0].shape == (64, 28, 10)
    for got in ranks:
        assert np.array_equal(got, ranks[0])
    np.testing.assert_allclose(ranks[0], logits, rtol=1e-5, atol=1e-6)
    for row in runs["port"].values():
        np.testing.assert_allclose(row["eval_" + name], ev, rtol=1e-5)
