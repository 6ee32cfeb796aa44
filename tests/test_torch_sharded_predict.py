"""``Model.predict`` from a per-host-sharded source, on 2 gloo ranks,
against the port's unsharded predict and the JAX package's.

A ``data.Pipeline(shard="auto")`` gives each rank its rows of every
global batch. Under ``DataParallel`` and ``FSDP`` (whose batch axis is
the whole world) each rank runs the forward on its rows and the logits
are all-gathered over the batch group in shard order, so every rank
returns the whole result, as the JAX package's predict does
(``distributed_tpu/training/model.py:1873-1890``). Checked here with
``mnist_cnn`` on JAX-built parameters, 64 uint8 images in batches of 16:

- every rank's logits equal, bit for bit, the port's predict from the
  unsharded pipeline of the same stream (every rank computing every row);
- they agree with the JAX model's predict from its own unsharded
  pipeline within rtol 1e-5;
- a shard count other than the replica count still raises the
  ``ValueError`` that ``fit`` and ``evaluate`` raise;
- under a strategy whose batch axis is not the whole world, predict
  from a sharded source gathers over the row group.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, run_pair

torch.set_num_threads(1)

BATCH = 16


def images(n=64):
    x, y = dtt.data.synthetic_images(n, (28, 28), 10, 4)
    return x[..., None].astype(np.uint8), y.astype(np.int32)


WORKER = WORKER_PRELUDE + '''
X8, Y8 = data["x8"], data["y8"]
out = {"rank": spec.index}
for name in ("dp", "fsdp"):
    st = (dtt.DataParallel(device="cpu") if name == "dp"
          else dtt.FSDP(device="cpu"))
    m = build(st, "mnist", dtt.optim.SGD(0.1))
    kw = dict(shuffle=True, seed=3, use_native=False)
    with dtt.data.Pipeline(X8, Y8, ''' + str(BATCH) + ''', shard="auto",
                           **kw) as sharded, \\
            dtt.data.Pipeline(X8, Y8, ''' + str(BATCH) + ''', **kw) as whole:
        out[f"shard_{name}"] = list(sharded.shard)
        got = m.predict(sharded)
        want = m.predict(whole)
    out[f"same_{name}"] = bool(np.array_equal(got, want))
    np.save(f"{sys.argv[2]}_{name}_{spec.index}.npy", got)
    with dtt.data.Pipeline(X8, Y8, ''' + str(BATCH) + ''',
                           shard=(spec.index, 4), **kw) as bad:
        try:
            m.predict(bad)
            out[f"count_{name}"] = None
        except ValueError as e:
            out[f"count_{name}"] = str(e)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    x8, y8 = images()
    jm = dtpu.Model(dtpu.models.mnist_cnn())
    jm.compile(optimizer=dtpu.optim.SGD(0.1),
               loss="sparse_categorical_crossentropy", metrics=[])
    jm.build((28, 28, 1), seed=0)
    with dtpu.data.Pipeline(x8, y8, BATCH, shuffle=True, seed=3,
                            use_native=False) as pipe:
        want = jm.predict(pipe)
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    np.savez(tmp / "in.npz", x=np.zeros(1), y=np.zeros(1), tx=np.zeros(1),
             ty=np.zeros(1), x8=x8, y8=y8,
             **{f"m:{k}": v for k, v in start.items()})
    port = run_pair(tmp, WORKER, tmp / "in.npz", tmp / "out", timeout=180)
    got = {(name, r): np.load(tmp / f"out_{name}_{r}.npy")
           for name in ("dp", "fsdp") for r in range(2)}
    return dict(port=port, got=got, jax=want)


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_sharded_predict_equals_unsharded_on_every_rank(runs, name):
    for r, row in runs["port"].items():
        assert row[f"shard_{name}"] == [r, 2]
        assert row[f"same_{name}"] is True
    assert runs["got"][(name, 0)].shape == (64, 10)
    assert np.array_equal(runs["got"][(name, 0)], runs["got"][(name, 1)])


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_sharded_predict_matches_jax(runs, name):
    np.testing.assert_allclose(runs["got"][(name, 0)], runs["jax"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_shard_count_error_is_kept(runs, name):
    for row in runs["port"].values():
        assert "cannot assemble into a whole batch" in row[f"count_{name}"]


def test_hinted_strategy_with_other_axes_still_raises(monkeypatch):
    """A strategy whose batch axis is not the whole world (here a world-1
    ``DataTensorParallel`` made to report a batch axis of 2) no longer
    refuses a sharded source (ROADMAP 1.6.2 is done): predict runs the
    rank's rows and gathers them over its row group, which here holds
    the rank alone, so it returns shard 0's rows of every batch
    (tests/test_torch_shard_auto.py runs the 4-rank case)."""
    x8, y8 = images(32)
    try:
        st = dtt.DataTensorParallel(model_parallel=1, device="cpu")
        with st.scope():
            m = dtt.Model(dtt.models.mnist_cnn())
        m.build((28, 28, 1))
        kw = dict(shuffle=True, seed=3, use_native=False)
        with dtt.data.Pipeline(x8, y8, BATCH, **kw) as whole:
            want = m.predict(whole)
        monkeypatch.setattr(type(st), "num_replicas_in_sync",
                            property(lambda self: 2))
        with dtt.data.Pipeline(x8, y8, BATCH, shard=(0, 2), **kw) as pipe:
            got = m.predict(pipe)
        half = want.reshape(-1, 2, BATCH // 2, 10)[:, 0].reshape(-1, 10)
        assert np.array_equal(got, half)
    finally:
        dtt.cluster.shutdown()
