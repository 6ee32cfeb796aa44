"""``nn.Dropout`` under tensor, sequence and data parallelism, on 2 gloo
ranks, against the JAX package.

JAX draws a Dropout mask over the layer's global shape
(``jax.random.bernoulli(rng, keep, x.shape)``) and each device keeps its
block of it. The port's ranks draw the counters of their own block only
(``utils.threefry.bernoulli_block``). One group of 2 worker processes
checks, for each strategy, that a rank's mask is its slice of JAX's
full-shape mask bit for bit:

- ``DataTensorParallel(model_parallel=2)``: a Dropout between a
  column-parallel and a row-parallel ``Dense`` holds the rank's feature
  columns; a Dropout on the replicated activation (between blocks) the
  whole tensor, the same on both ranks;
- ``DataSeqParallel(seq_parallel=2)``, ring (causal, so the zigzag
  schedule inside the attention) and Ulysses: the rank's contiguous
  positions of each row, which is how the activations between blocks are
  laid out in every mode;
- ``DataParallel`` on 2 ranks: the rank's rows; so do ``RandomFlip``'s
  coins and ``RandomCrop``'s offsets, which JAX draws over the global
  batch (each rank's augmented rows equal JAX's rows of the augmented
  global batch bit for bit).

Then an LM (2 blocks, d 32, 4 heads, vocab 32, T 16) with a Dropout(0.1)
between the column and the row product of each MLP and one after each
block trains 3 ``fit`` steps of ``SGD(0.1)`` under each of the four
strategies, from JAX-built parameters, against the JAX strategy of the
same kind on 8 virtual CPU devices (data 4 x model 2, data 4 x seq 2,
data 8): losses within rtol 1e-5, parameters within atol 1e-5. The JAX
fits run while the workers do.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import WORKER_PRELUDE, lm_tokens, run_ranks

torch.set_num_threads(1)

KEY_SEED, KEEP = 42, 0.9
SHAPES = {"col": (4, 16, 64), "whole": (4, 16, 32)}
STRATEGIES = ("tp", "ring", "ulysses", "dp")
IMAGES = (8, 6, 7, 2)  # global NHWC batch of the augmentation check
AUGMENT = {"flip": lambda nn: nn.RandomFlip("horizontal_and_vertical"),
           "crop": lambda nn: nn.RandomCrop(4, 5, padding=1)}


def lm_drop(pkg, flash="auto", rate=0.1):
    nn = pkg.nn
    layers = [nn.Embedding(32, 32), nn.PositionalEmbedding(16)]
    for _ in range(2):
        layers += [
            nn.Residual(nn.Sequential([
                nn.LayerNorm(),
                nn.MultiHeadAttention(4, causal=True, flash=flash)])),
            nn.Residual(nn.Sequential([
                nn.LayerNorm(), nn.Dense(64, activation="gelu", shard="col"),
                nn.Dropout(rate), nn.Dense(32, shard="row")])),
            nn.Dropout(rate)]
    return nn.Sequential(layers + [nn.LayerNorm(), nn.Dense(32)])


WORKER = WORKER_PRELUDE + '''
import json

KEY = np.array([0, ''' + str(KEY_SEED) + '''], np.uint32)
FULL = np.load(sys.argv[3])
RATE = 1.0 - ''' + str(KEEP) + '''


def lm_drop(flash="auto", rate=0.1):
    nn = dtt.nn
    layers = [nn.Embedding(32, 32), nn.PositionalEmbedding(16)]
    for _ in range(2):
        layers += [
            nn.Residual(nn.Sequential([
                nn.LayerNorm(),
                nn.MultiHeadAttention(4, causal=True, flash=flash)])),
            nn.Residual(nn.Sequential([
                nn.LayerNorm(), nn.Dense(64, activation="gelu", shard="col"),
                nn.Dropout(rate), nn.Dense(32, shard="row")])),
            nn.Dropout(rate)]
    return nn.Sequential(layers + [nn.LayerNorm(), nn.Dense(32)])


AUGMENT = {"flip": lambda: dtt.nn.RandomFlip("horizontal_and_vertical"),
           "crop": lambda: dtt.nn.RandomCrop(4, 5, padding=1)}


def mask(layer, shape, st):
    """The kept positions of ``layer`` on ones of local ``shape``."""
    layer.train()
    with st.scope(), dtt.nn.rng_scope(KEY), torch.no_grad():
        return (layer(torch.ones(shape)) != 0).numpy()


def strategy(name):
    if name == "tp":
        return dtt.DataTensorParallel(model_parallel=2, device="cpu")
    if name == "dp":
        return dtt.DataParallel(device="cpu")
    return dtt.DataSeqParallel(seq_parallel=2, attention=name, device="cpu")


r = spec.index
out = {"rank": r}
for name in json.loads(sys.argv[4]):
    st = strategy(name)
    whole = FULL["whole"]
    if name == "tp":
        with st.scope():
            pair = dtt.Model(dtt.nn.Sequential([
                dtt.nn.Dense(64, shard="col"), dtt.nn.Dropout(RATE),
                dtt.nn.Dense(32, shard="row")]))
        pair.build((16, 32))
        col = pair.module.layers[1]
        out["tp_paired"] = [pair.module.layers[0].feeds_row,
                            pair.module.layers[2].takes_block,
                            col.col_source is pair.module.layers[0]]
        got = mask(col, (4, 16, 32), st)
        out["mask_tp_col"] = bool(np.array_equal(
            got, FULL["col"][..., r * 32:(r + 1) * 32]))
        want = whole
    elif name == "dp":
        want = whole[r * 2:(r + 1) * 2]
        n = len(FULL["img"]) // 2
        rows = slice(r * n, (r + 1) * n)
        for kind, make in AUGMENT.items():
            layer = make()
            layer.train()
            with st.scope(), dtt.nn.rng_scope(KEY), torch.no_grad():
                got = layer(torch.from_numpy(FULL["img"][rows])).numpy()
            out[f"aug_{kind}"] = bool(np.array_equal(got, FULL[kind][rows]))
    else:
        want = whole[:, r * 8:(r + 1) * 8]
    got = mask(dtt.nn.Dropout(RATE), want.shape, st)
    out[f"mask_{name}"] = bool(np.array_equal(got, want))
    m = build(st, "lm", dtt.optim.SGD(0.1),
              module=lm_drop(flash=True if name == "ulysses" else "auto"))
    dtt.interop.place(m, params=PARAMS["lm"])
    out[f"losses_{name}"] = fit(m, "lm")
    params = dtt.interop.params_to_numpy(m.params)  # every rank gathers
    if spec.is_chief:
        np.savez(f"{sys.argv[2]}_{name}.npz", **params)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _jax_strategy(name):
    devs = jax.devices()[:8]
    if name == "tp":
        return dtpu.DataTensorParallel(devices=devs, model_parallel=2)
    if name == "dp":
        return dtpu.DataParallel(devs)
    return dtpu.DataSeqParallel(devices=devs, seq_parallel=2, attention=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dropout")
    tx, ty = lm_tokens()
    key = jax.random.PRNGKey(KEY_SEED)
    full = {k: np.asarray(jax.random.bernoulli(key, KEEP, s))
            for k, s in SHAPES.items()}
    img = np.random.default_rng(3).standard_normal(IMAGES).astype(
        np.float32)
    full["img"] = img
    local = {}  # rank 1's rows drawn at the local batch instead
    for kind, make in AUGMENT.items():
        layer = make(dtpu.nn)
        full[kind] = np.asarray(layer.apply({}, {}, img, train=True,
                                            rng=key)[0])
        local[kind] = np.asarray(layer.apply(
            {}, {}, img[len(img) // 2:], train=True, rng=key)[0])
    np.savez(tmp / "full.npz", **full)
    models = {}
    for name in STRATEGIES:
        with _jax_strategy(name).scope():
            m = dtpu.Model(lm_drop(
                dtpu, flash=True if name == "ulysses" else "auto"))
            m.compile(optimizer=dtpu.optim.SGD(0.1),
                      loss="sparse_categorical_crossentropy", metrics=[])
        m.build((16,), seed=0)
        models[name] = m
    start = dtt.interop.flatten_tree(jax.device_get(models["tp"].params))
    np.savez(tmp / "in.npz", x=np.zeros(1), y=np.zeros(1), tx=tx, ty=ty,
             **{f"l:{k}": v for k, v in start.items()})
    port = {}

    def workers():
        port.update(run_ranks(2, tmp, WORKER, tmp / "in.npz", tmp / "out",
                              tmp / "full.npz", json.dumps(STRATEGIES),
                              timeout=240))

    thread = threading.Thread(target=workers, name="dtpu-test-workers")
    thread.start()
    jax_runs = {}
    try:
        for name, m in models.items():
            assert all(np.array_equal(v, start[k]) for k, v in
                       dtt.interop.flatten_tree(
                           jax.device_get(m.params)).items())
            hist = m.fit(tx, ty, batch_size=8, epochs=3, steps_per_epoch=1,
                         shuffle=True, seed=0, verbose=0)
            jax_runs[name] = dict(
                losses=hist.history["loss"],
                params=dtt.interop.flatten_tree(jax.device_get(m.params)))
    finally:
        thread.join()
    got = {}
    for name in STRATEGIES:
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(port=port, got=got, jax=jax_runs, full=full, local=local)


@pytest.mark.parametrize("name", STRATEGIES)
def test_rank_mask_is_its_slice_of_jax_full_mask(runs, name):
    assert len(runs["port"]) == 2
    for row in runs["port"].values():
        assert row[f"mask_{name}"] is True
        if name == "tp":
            assert row["tp_paired"] == [True, True, True]
            assert row["mask_tp_col"] is True
    # The draw is not degenerate: both values occur.
    assert 0.8 < runs["full"]["whole"].mean() < 0.98


@pytest.mark.parametrize("kind", sorted(AUGMENT))
def test_dp_augment_is_its_rows_of_jax_global_draw(runs, kind):
    assert len(runs["port"]) == 2
    for row in runs["port"].values():
        assert row[f"aug_{kind}"] is True
    # A draw at the local batch would differ on rank 1: the check bites.
    half = len(runs["full"]["img"]) // 2
    assert not np.array_equal(runs["local"][kind],
                              runs["full"][kind][half:])


@pytest.mark.parametrize("name", STRATEGIES)
def test_dropout_fit_matches_jax_strategy(runs, name):
    want = runs["jax"][name]
    for row in runs["port"].values():
        np.testing.assert_allclose(row[f"losses_{name}"], want["losses"],
                                   rtol=1e-5)
    got = runs["got"][name]
    assert sorted(got) == sorted(want["params"])
    for path, v in want["params"].items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-5,
                                   err_msg=path)
