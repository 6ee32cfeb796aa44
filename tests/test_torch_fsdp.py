"""FSDP (ZeRO-3) in the port, on 2 gloo ranks, against the JAX package.

One pair of worker processes (the port's launcher, each under a timeout
of 120 s) runs every check of this file; the JAX side runs here on
``jax.devices()[:2]``, from the same JAX-built parameters and numpy
batches.

- ``FSDP`` against the JAX ``FSDP`` on mnist_cnn and a tiny
  ``transformer_lm`` (2 layers, d 32, vocab 32), 3 ``fit`` steps of
  ``SGD(0.05, momentum=0.9)``: losses within rtol 1e-5, parameters within
  atol 1e-5 (the data-parallel gate), and each rank's shape of every
  parameter and optimizer leaf equal to JAX's addressable shard shape
  (awkward shapes replicated).
- ``FSDP`` against the port's ``DataParallel`` on the same 2 ranks: bit
  for bit under SGD with momentum, Adam, AdamW and ``fused_adamw`` (the
  update is elementwise and a sum of two addends has one order), the LM
  whose layers have their own ``dtype="bfloat16"`` and the LM with remat
  (its recompute gathers again) under Adam, and a tiny ResNet's sync-BN
  (parameters and running statistics); within
  rtol 1e-6 under ``grad_clip`` and ``Lamb`` (their norms sum the ranks'
  blocks in another order; parameters with an absolute floor of 1e-9 for
  entries near 0). A stack sharded on its stacked axis (each
  slice on one rank, broadcast) is bit for bit too.
- The scanned LM's overlap: ``scan_overlap`` "require", "auto" and "off"
  give identical losses, and the ``overlap`` telemetry equals JAX's.
- ``mixed_bfloat16``: every gather of a policy-cast leaf moves bf16, and
  ``comm_bytes_estimate`` equals JAX's for the same tree.
- The model state per rank is smaller than ``DataParallel``'s.
- A model built under FSDP serves as DP's does: the Engine's snapshot
  (gathered), ``generate`` and, after ``quant.quantize_model`` (each
  weight gathered, quantized, its ``q`` and ``scale`` stored as blocks and
  both gathered where read), ``predict``: the same tokens and bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import (WORKER_PRELUDE, lm_tokens, mnist_data, run_pair,
                          shard_shapes)

torch.set_num_threads(1)

WORKER = WORKER_PRELUDE + '''
from distributed_tpu_torch.parallel import collectives

out = {"rank": spec.index}
fsdp = dtt.FSDP(device="cpu")
dp = dtt.DataParallel(device="cpu")

# FSDP against JAX: losses, parameters (rank 0 saves them), shapes.
for kind in ("mnist", "lm"):
    m = build(fsdp, kind, dtt.optim.SGD(0.05, momentum=0.9))
    out[f"shapes_{kind}"] = local_shapes(m)
    out[f"losses_{kind}"] = fit(m, kind)
    params = dtt.interop.params_to_numpy(m.params)
    if spec.is_chief:
        np.savez(sys.argv[2] + f"_{kind}.npz", **params)
    out[f"bytes_{kind}"] = m.last_fit_telemetry[
        "model_state_bytes_per_device"]
out["bytes_dp"] = None

# FSDP against DataParallel, the same ranks: bit for bit.
bitwise = {}
for name, make in opts().items():
    a = build(dp, "mnist", make())
    la = fit(a, "mnist")
    b = build(fsdp, "mnist", make())
    lb = fit(b, "mnist")
    bitwise[name] = [la == lb, same(full(a), full(b))]
    if name == "adam":
        out["bytes_dp"] = a.last_fit_telemetry["model_state_bytes_per_device"]
        out["bytes_fsdp"] = b.last_fit_telemetry[
            "model_state_bytes_per_device"]
# Layers with their own dtype= (the early return of _compute_leaf) gather
# too: the bf16-layer LM, FSDP against DataParallel.
a = build(dp, "lm", dtt.optim.Adam(1e-3), module=lm(dtype="bfloat16"))
la = fit(a, "lm")
b = build(fsdp, "lm", dtt.optim.Adam(1e-3), module=lm(dtype="bfloat16"))
lb = fit(b, "lm")
bitwise["bf16_layers"] = [la == lb, same(full(a), full(b))]
# Remat re-gathers in the backward's recompute.
a = build(dp, "lm", dtt.optim.Adam(1e-3), module=lm(remat=True))
la = fit(a, "lm")
b = build(fsdp, "lm", dtt.optim.Adam(1e-3), module=lm(remat=True))
lb = fit(b, "lm")
bitwise["remat"] = [la == lb, same(full(a), full(b))]
# Sync-BN: BatchNorm's scale and bias gathered, its sums all-reduced.
rng = np.random.default_rng(5)
rx = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
ry = rng.integers(0, 10, (16,)).astype(np.int32)
runs_bn = []
for strategy in (dp, fsdp):
    with strategy.scope():
        m = dtt.Model(dtt.models.resnet(50, 10, small_inputs=True,
                                        stage_blocks=(1, 1, 1, 1), width=8))
        m.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9), loss=LOSS,
                  metrics=[])
    m.build((16, 16, 3), seed=2)
    runs_bn.append((m.fit(rx, ry, batch_size=8, epochs=3, steps_per_epoch=1,
                          shuffle=False, verbose=0).history["loss"],
                    full(m), {k: v.clone() for k, v in m.state.items()}))
(la, pa, sa), (lb, pb, sb) = runs_bn
bitwise["resnet_sync_bn"] = [la == lb, same(pa, pb) and same(sa, sb)]
out["bitwise"] = bitwise
close = {}
for name, make, kw in (("clip", lambda: dtt.optim.Adam(1e-3),
                        dict(grad_clip=0.05)),
                       ("lamb", lambda: dtt.optim.Lamb(1e-3), {})):
    a = build(dp, "mnist", make(), **kw)
    la = fit(a, "mnist")
    b = build(fsdp, "mnist", make(), **kw)
    lb = fit(b, "mnist")
    close[name] = [max(abs(u - v) / abs(v) for u, v in zip(la, lb)),
                   max_excess(full(a), full(b), 1e-6)]
out["close"] = close

# A stack sharded on its stacked axis: slice i lives on rank i // 2.
def stack():
    return dtt.nn.Sequential([
        dtt.nn.Flatten(), dtt.nn.Dense(3),
        dtt.nn.ScannedBlocks(lambda: dtt.nn.Sequential(
            [dtt.nn.Dense(3, activation="tanh")]), 4),
        dtt.nn.Dense(10)])


def stacked_model(strategy):
    with strategy.scope():
        m = dtt.Model(stack())
        m.compile(optimizer=dtt.optim.Adam(1e-2), loss=LOSS, metrics=[])
    return m.build((28, 28, 1), seed=4)


a, b = stacked_model(dp), stacked_model(fsdp)
lay = collectives.layout_of(
    b.live_params()["scanned_blocks/blocks/dense/kernel"])
out["stack_dim"] = lay.dim
out["stack_bitwise"] = [fit(a, "mnist") == fit(b, "mnist"),
                        same(full(a), full(b))]

# The scanned LM's overlap: identical losses, JAX's telemetry.
overlap = {}
for mode in ("require", "auto", "off"):
    m = build(fsdp, "lm", dtt.optim.SGD(0.05, momentum=0.9),
              module=lm(scan=True, scan_overlap=mode))
    if mode == "require":
        rec = []
        orig = collectives.start_gather
        collectives.start_gather = lambda *a, **k: rec.append(1) or orig(
            *a, **k)
        fsdp_overlap = fsdp.overlap_spec
        fsdp.overlap_spec = lambda: collectives.start_gather
    losses = fit(m, "lm")
    if mode == "require":
        collectives.start_gather = orig
        fsdp.overlap_spec = fsdp_overlap
        out["overlap_gathers"] = len(rec)
    overlap[mode] = [losses, m.last_fit_telemetry["overlap"]]
out["overlap"] = overlap

# mixed_bfloat16: the gathered leaves' dtypes, and the estimate.
seen = []
orig_gather = collectives._gather_into


def spy(x, layout, async_op=False):
    seen.append(str(x.dtype))
    return orig_gather(x, layout, async_op)


collectives._gather_into = spy
m = build(fsdp, "lm", dtt.optim.SGD(0.05, momentum=0.9),
          precision="mixed_bfloat16")
fit(m, "lm", epochs=1)
collectives._gather_into = orig_gather
out["bf16_gathers"] = sorted(set(seen))
out["bf16_estimate"] = m.last_fit_telemetry["comm_bytes_estimate"]
out["mesh"] = repr(fsdp.mesh.mesh_dim_names)

# Serving a model built under FSDP: generate gathers as it reads, the
# Engine serves a gathered snapshot, int8 weights gather q and scale.
prompts = [(TX[i, :6], 4) for i in range(3)]
served = {}
for name, strategy in (("dp", dp), ("fsdp", fsdp)):
    m = build(strategy, "lm", dtt.optim.SGD(0.05, momentum=0.9))
    eng = dtt.serving.Engine(m, max_slots=2, block_size=4, max_len=16)
    toks = [t.tolist() for t in eng.run(prompts)]
    gen = m.generate(TX[:2, :6], 4, temperature=0.0).tolist()
    dtt.quant.quantize_model(m)
    q = m.live_params()["dense/kernel/q"]
    served[name] = [toks, gen, m.predict(TX[:4], batch_size=4).tolist(),
                    collectives.layout_of(q) is not None]
out["served"] = served
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''

SGD = dict(learning_rate=0.05, momentum=0.9)


def _jax_fit(strategy, module, shape, x, y, batch, **compile_kw):
    with strategy.scope():
        m = dtpu.Model(module)
        m.compile(optimizer=dtpu.optim.SGD(**SGD),
                  loss="sparse_categorical_crossentropy", metrics=[],
                  **compile_kw)
    m.build(shape, seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(m.params))
    shapes = dict(shard_shapes(m.params, "params"),
                  **shard_shapes(m.opt_state, "opt_state"))
    hist = m.fit(x, y, batch_size=batch, epochs=3, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0)
    return m, start, shapes, hist.history["loss"]


def _jax_lm(**kw):
    return dtpu.models.transformer_lm(32, num_layers=2, d_model=32,
                                      num_heads=2, max_len=16, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    x, y = mnist_data()
    tx, ty = lm_tokens()
    devs = jax.devices()[:2]
    jm, m_start, m_shapes, m_losses = _jax_fit(
        dtpu.FSDP(devs), dtpu.models.mnist_cnn(), (28, 28, 1), x, y, 64)
    jl, l_start, l_shapes, l_losses = _jax_fit(
        dtpu.FSDP(devs), _jax_lm(), (16,), tx, ty, 8)
    overlap = {}
    for mode in ("auto", "off"):
        js, _, _, _ = _jax_fit(dtpu.FSDP(devs), _jax_lm(
            scan=True, scan_overlap=mode), (16,), tx, ty, 8)
        overlap[mode] = js.last_fit_telemetry["overlap"]
    bf16_estimate = dtpu.FSDP(devs).comm_bytes_estimate(
        jl.params, compute_dtype=jnp.bfloat16)
    np.savez(tmp / "in.npz", x=x, y=y, tx=tx, ty=ty,
             **{f"m:{k}": v for k, v in m_start.items()},
             **{f"l:{k}": v for k, v in l_start.items()})
    port = run_pair(tmp, WORKER, tmp / "in.npz", tmp / "out")
    got = {}
    for kind in ("mnist", "lm"):
        with np.load(tmp / f"out_{kind}.npz") as z:
            got[kind] = {k: z[k] for k in z.files}
    return dict(port=port, got=got, losses={"mnist": m_losses,
                                            "lm": l_losses},
                params={"mnist": dtt.interop.flatten_tree(
                    jax.device_get(jm.params)),
                    "lm": dtt.interop.flatten_tree(
                        jax.device_get(jl.params))},
                shapes={"mnist": m_shapes, "lm": l_shapes},
                overlap=overlap, bf16_estimate=bf16_estimate)


@pytest.mark.parametrize("kind", ["mnist", "lm"])
def test_fsdp_matches_jax_fsdp(runs, kind):
    for row in runs["port"].values():
        np.testing.assert_allclose(row[f"losses_{kind}"],
                                   runs["losses"][kind], rtol=1e-5)
    want = runs["params"][kind]
    assert set(runs["got"][kind]) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(runs["got"][kind][path], v, rtol=0,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("kind", ["mnist", "lm"])
def test_fsdp_shard_shapes_equal_jax(runs, kind):
    want = runs["shapes"][kind]
    for row in runs["port"].values():
        assert row[f"shapes_{kind}"] == want
    if kind == "mnist":
        # (5408, 64) on its rows, the conv kernel (3, 3, 1, 32) on its
        # channels, the step count whole.
        assert want["params/dense/kernel"] == [2704, 64]
        assert want["params/conv2d/kernel"] == [3, 3, 1, 16]
        assert want["opt_state/#0"] == []


@pytest.mark.parametrize("opt", ["sgd_momentum", "adam", "adamw",
                                 "fused_adamw", "bf16_layers", "remat",
                                 "resnet_sync_bn"])
def test_fsdp_bitwise_equal_to_data_parallel(runs, opt):
    for row in runs["port"].values():
        assert row["bitwise"][opt] == [True, True]


@pytest.mark.parametrize("case", ["clip", "lamb"])
def test_fsdp_norms_sum_the_blocks(runs, case):
    for row in runs["port"].values():
        loss_rel, param_rel = row["close"][case]
        # allclose(rtol=1e-6, atol=1e-9): the floor is for entries near 0.
        assert loss_rel <= 1e-6 and param_rel <= 1e-9, (loss_rel, param_rel)


def test_fsdp_stack_sharded_on_its_stacked_axis(runs):
    for row in runs["port"].values():
        assert row["stack_dim"] == 0
        assert row["stack_bitwise"] == [True, True]


def test_fsdp_overlap_identical_losses_and_jax_telemetry(runs):
    for row in runs["port"].values():
        ov = row["overlap"]
        assert ov["require"][0] == ov["auto"][0] == ov["off"][0]
        assert ov["require"][1] == ov["auto"][1] == runs["overlap"]["auto"]
        assert ov["off"][1] == runs["overlap"]["off"]
        assert ov["auto"][1] == {"overlap": True,
                                 "exposed_comm_fraction": 0.5, "layers": 2}
        # Every forward of the 3 steps issues one gather per stacked leaf
        # and block through the strategy's overlap_spec.
        assert row["overlap_gathers"] > 0


def test_overlap_spec_only_where_parameters_are_gathered():
    assert dtt.SingleDevice(device="cpu").overlap_spec() is None
    try:
        assert dtt.DataParallel(device="cpu").overlap_spec() is None
        assert dtt.ZeroDataParallel(device="cpu").overlap_spec() is None
        assert callable(dtt.FSDP(device="cpu").overlap_spec())
        assert dtt.FullyShardedDataParallel(device="cpu").axis == "fsdp"
        assert dtt.FSDP(device="cpu").axis == "data"
    finally:
        dtt.cluster.shutdown()


def test_fsdp_bf16_gathers_and_estimate(runs):
    want = {k: int(v) for k, v in runs["bf16_estimate"].items()}
    for row in runs["port"].values():
        assert row["bf16_gathers"] == ["torch.bfloat16"]
        assert row["bf16_estimate"] == want
    assert want["gathered_param_bytes_per_device"] > 0


def test_fsdp_serving_gathers_every_read(runs):
    for row in runs["port"].values():
        dp, fsdp = row["served"]["dp"], row["served"]["fsdp"]
        assert fsdp[:3] == dp[:3]  # Engine, generate, int8 predict
        assert fsdp[3] and not dp[3]  # q stored as blocks under FSDP only


def test_fsdp_model_state_bytes_below_data_parallel(runs):
    for row in runs["port"].values():
        assert row["bytes_fsdp"] < 0.75 * row["bytes_dp"]
        assert row["mesh"] == "('data',)"


def test_largest_divisible_spec_is_jax_rule():
    from distributed_tpu.parallel.strategy import _largest_divisible_spec \
        as jax_rule
    from distributed_tpu_torch.parallel.strategy import \
        _largest_divisible_spec as port_rule

    for shape in [(), (10,), (8,), (3, 3, 1, 32), (5408, 64), (64, 64),
                  (12, 768, 3072), (2, 32, 32), (4, 3, 3), (7, 9)]:
        for n in (1, 2, 4, 8):
            spec = jax_rule(shape, n, "x")
            want = next((d for d, s in enumerate(tuple(spec) + (None,) * (
                len(shape) - len(spec))) if s == "x"), None)
            assert port_rule(shape, n) == want, (shape, n)
