"""Losses with a global divisor, and the data-parallel strategies' JAX keywords.

One pair of 2 gloo ranks (the port's launcher) runs the worker below; the
JAX side runs here on ``jax.devices()[:2]``, from the same JAX-built
parameters and numpy batches.

- ``cross_entropy_with_ignore`` under ``DataParallel``: ``mnist_cnn``,
  ``SGD(0.1)``, global batch 64 of 64 rows (no shuffle, 3 steps), 24 of
  rank 0's 32 labels at -100 and none of rank 1's. Each rank's sum is
  divided by the GLOBAL count of kept labels, as the JAX step's one
  divisor: losses within rtol 1e-5 of JAX ``DataParallel``'s, parameters
  within atol 1e-5. A per-rank mean (the port before this repair) moves
  the parameters ~1e-2 away. The rows are the 64 of ``mnist_data(64)``
  (JAX's first loss 2.28138).
- A loss callable that returns a ``(sum, count)`` pair trains bit for bit
  as the known ratio loss; ``evaluate`` of the ratio loss equals JAX's
  (a partial last batch included).
- ``DataSeqParallel(seq_parallel=2)`` on the LM with the last 5 of each
  row's 16 labels at -100 (all on seq rank 1): JAX's losses and
  parameters at the same tolerances.
- ``DataParallel(mesh=make_mesh({"data": 2}))`` trains bit for bit as
  ``DataParallel()``; ``devices=[0]`` (a subset of the group) raises "not
  yet ported" naming ROADMAP 1.7b.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, lm_tokens, mnist_data, run_pair

torch.set_num_threads(1)

WORKER = WORKER_PRELUDE + '''
from distributed_tpu_torch.ops import losses

YI, TYI = data["yi"], data["tyi"]
out = {}


def pair_loss(logits, y):
    return losses._ce_ignore_sum_count(logits, y)


def train(strategy, kind, loss, x, y, batch):
    with strategy.scope():
        m = dtt.Model(dtt.models.mnist_cnn() if kind == "mnist" else lm())
        m.compile(optimizer=dtt.optim.SGD(0.1), loss=loss, metrics=[])
    m.build((28, 28, 1) if kind == "mnist" else (16,))
    dtt.interop.place(m, params=PARAMS[kind])
    hist = m.fit(x, y, batch_size=batch, epochs=3, steps_per_epoch=1,
                 shuffle=False, verbose=0)
    return m, [float(v) for v in hist.history["loss"]]


def save(m, name):
    flat = {k: v.detach().numpy() for k, v in m.params.items()}
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **flat)


dp = dtt.DataParallel(device="cpu")
m, out["dp"] = train(dp, "mnist", losses.cross_entropy_with_ignore, X, YI, 64)
save(m, "dp")
out["eval"] = m.evaluate(np.concatenate([X, X[:16]]),
                         np.concatenate([YI, Y[:16]]), batch_size=32,
                         verbose=0)["loss"]
ref = full(m)
m2, out["pair"] = train(dp, "mnist", pair_loss, X, YI, 64)
out["pair_same"] = [out["pair"] == out["dp"], same(full(m2), ref)]
mesh = dtt.parallel.make_mesh({"data": 2}, device_type="cpu")
m3, out["mesh"] = train(dtt.DataParallel(mesh=mesh, device="cpu"), "mnist",
                        losses.cross_entropy_with_ignore, X, YI, 64)
out["mesh_same"] = [out["mesh"] == out["dp"], same(full(m3), ref)]
sp = dtt.DataSeqParallel(seq_parallel=2, device="cpu")
m4, out["sp"] = train(sp, "lm", losses.cross_entropy_with_ignore, TX[:8],
                      TYI[:8], 8)
save(m4, "sp")
try:
    dtt.DataParallel(devices=[0], device="cpu")
    out["subset"] = None
except NotImplementedError as e:
    out["subset"] = str(e)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _jax(strategy, module, shape, x, y, batch, params=None):
    with strategy.scope():
        m = dtpu.Model(module)
        m.compile(optimizer=dtpu.optim.SGD(0.1),
                  loss=dtpu.ops.losses.cross_entropy_with_ignore, metrics=[])
    m.build(shape, seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(m.params))
    hist = m.fit(x, y, batch_size=batch, epochs=3, steps_per_epoch=1,
                 shuffle=False, verbose=0)
    return m, start, hist.history["loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ratio")
    devs = jax.devices()[:2]
    x, y = mnist_data(64)
    yi = y.copy()
    yi[:24] = -100  # 24 of rank 0's 32 rows; none of rank 1's
    tx, ty = lm_tokens()
    tyi = ty.copy()
    tyi[:, -5:] = -100  # the end of each row: seq rank 1's block
    jm, mstart, jlosses = _jax(dtpu.DataParallel(devs), dtpu.models.mnist_cnn(),
                               (28, 28, 1), x, yi, 64)
    jeval = jm.evaluate(np.concatenate([x, x[:16]]),
                        np.concatenate([yi, y[:16]]), batch_size=32,
                        verbose=0)["loss"]
    lm = dtpu.models.transformer_lm(32, num_layers=2, d_model=32,
                                    num_heads=2, max_len=16)
    js, lstart, slosses = _jax(dtpu.DataSeqParallel(devs, seq_parallel=2), lm,
                               (16,), tx[:8], tyi[:8], 8)
    np.savez(tmp / "in.npz", x=x, y=y, tx=tx, ty=ty, yi=yi, tyi=tyi,
             **{f"m:{k}": v for k, v in mstart.items()},
             **{f"l:{k}": v for k, v in lstart.items()})
    port = run_pair(tmp, WORKER, tmp / "in.npz", tmp / "out", timeout=200)
    got = {}
    for name in ("dp", "sp"):
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    flat = {name: dtt.interop.flatten_tree(jax.device_get(m.params))
            for name, m in (("dp", jm), ("sp", js))}
    return dict(port=port, got=got, jax=flat, losses={"dp": jlosses,
                                                      "sp": slosses},
                eval=jeval)


@pytest.mark.parametrize("run", ["dp", "sp"])
def test_ratio_loss_matches_jax_global_divisor(runs, run):
    for row in runs["port"].values():
        np.testing.assert_allclose(row[run], runs["losses"][run], rtol=1e-5)
    got = runs["got"][run]
    for path, want in runs["jax"][run].items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-5,
                                   err_msg=path)


def test_sum_count_callable_trains_as_the_ratio_loss(runs):
    for row in runs["port"].values():
        assert row["pair_same"] == [True, True]


def test_ratio_loss_evaluate_matches_jax(runs):
    for row in runs["port"].values():
        np.testing.assert_allclose(row["eval"], runs["eval"], rtol=1e-5)


def test_data_parallel_takes_a_one_axis_mesh(runs):
    for row in runs["port"].values():
        assert row["mesh_same"] == [True, True]


def test_data_parallel_subset_raises_not_yet_ported(runs):
    for row in runs["port"].values():
        assert "not yet ported (ROADMAP 1.7b)" in row["subset"]


def test_sum_count_form_of_the_known_ratio_loss():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    y = torch.tensor([0, -100, 3, 4, -100, 1])
    total, count = dtt.ops.losses._ce_ignore_sum_count(logits, y)
    assert float(count) == 4.0
    assert torch.equal(total / count,
                       dtt.ops.losses.cross_entropy_with_ignore(logits, y))
    assert dtt.ops.losses.get_sum_count(
        dtt.ops.losses.cross_entropy_with_ignore) is not None
    assert dtt.ops.losses.get_sum_count(
        dtt.ops.losses.sparse_categorical_crossentropy) is None
