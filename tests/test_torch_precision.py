"""The port's precision policies against the JAX package's.

A small LM (vocab 64, 2 layers, d_model 32, 2 heads, T 16, flash
attention, no ``dtype=`` on its layers, so the policy decides) is built on
the same weights in both packages and fitted 3 steps with ``Adam(1e-3)``
and the pallas loss under each preset (and none), on the same seeded
batches (``shuffle=True, seed=0``). The JAX side runs its Pallas kernels
in interpret mode; the port runs its kernels' plain versions.

Tolerances, per-step losses and the evaluation loss: f32 (no policy,
``"float32"``) rtol 1e-5; ``mixed_bfloat16`` rtol 2e-3 (the compute dtype's
rounding lands on different values: XLA keeps fused bf16 chains at f32,
the port rounds each operation; the loss averages 64 tokens of them);
``mixed_float16`` rtol 5e-4 (three more mantissa bits).

Dynamic loss scaling: from an initial scale of 2^20 with a growth interval
of 2 the f16 gradients overflow for 5 steps, then the scale grows once
and overflows again; the scale after every step equals the JAX package's
``loss_scale_value`` exactly (powers of two). Checkpoints written under
each policy by either package restore in the other bit for bit, f32 on
disk; crossing between a loss-scaling and a non-scaling policy raises the
format error in both.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu_torch.checkpoint import core as pckpt
from torch_parity import lm_pair

torch.set_num_threads(1)

V, T, LR = 64, 16, 1e-3
PALLAS = "pallas_sparse_categorical_crossentropy"
PRESETS = (None, "float32", "mixed_bfloat16", "mixed_float16")
RTOL = {None: 1e-5, "float32": 1e-5, "mixed_bfloat16": 2e-3,
        "mixed_float16": 5e-4}


def _data(n=8, seed=0):
    tok = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _pair(precision, seed=0):
    jm, pm = lm_pair(vocab=V, num_layers=2, d_model=32, num_heads=2,
                     max_len=T, flash=True, seed=seed)
    jm.compile(optimizer=dtpu.optim.Adam(LR), loss=PALLAS,
               metrics=["accuracy"], precision=precision)
    pm.compile(optimizer=dtt.optim.Adam(LR), loss=PALLAS,
               metrics=["accuracy"], precision=precision)
    return jm, pm


def _fit(m, x, y, steps=3):
    return m.fit(x, y, batch_size=4, epochs=steps, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0).history


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("preset", PRESETS[1:])
def test_presets_and_get_match_jax(preset):
    j, p = dtpu.precision.Policy(preset), dtt.precision.Policy(preset)
    for attr in ("param_dtype", "compute_dtype", "output_dtype"):
        assert _name(getattr(p, attr)) == str(getattr(j, attr)), attr
    for attr in ("name", "loss_scaling", "initial_loss_scale",
                 "loss_scale_growth_interval", "loss_scale_factor",
                 "needs_compute_cast", "compute_itemsize"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert dtt.precision.get(preset).name == preset
    assert dtt.precision.get(p) is p and dtt.precision.get(None) is None
    custom = dtt.precision.Policy(compute_dtype="float16",
                                  loss_scaling=False)
    assert custom.name == "policy(float32/float16/float32)"
    assert not custom.loss_scaling
    with pytest.raises(ValueError, match="Unknown precision policy"):
        dtt.precision.get("mixed_int4")
    with pytest.raises(TypeError):
        dtt.precision.get(3)
    # The tree helpers, as the JAX package's.
    tree = {"w": torch.ones(2, 3, dtype=torch.bfloat16),
            "n": torch.arange(3)}
    acc = dtt.precision.grad_accum_init(tree)
    assert acc["w"].dtype == torch.float32 and acc["n"].dtype == torch.int64
    dtt.precision.assert_f32_accumulator(acc)
    with pytest.raises(AssertionError, match="expected float32"):
        dtt.precision.assert_f32_accumulator(tree)
    back = dtt.precision.cast_like(acc, tree)
    assert back["w"].dtype == torch.bfloat16
    assert p.cast_params_to_storage(tree) is tree  # f32 masters: a no-op
    assert p.cast_output(torch.ones(2, dtype=torch.float16)).dtype == \
        torch.float32
    assert p.cast_output(torch.arange(2)).dtype == torch.int64


def _hinted(pkg):
    """A stack whose first and last layers carry their own dtype=."""
    nn = pkg.nn
    return nn.Sequential([
        nn.Embedding(V, 16, dtype="float32"), nn.LayerNorm(),
        nn.Dense(8), nn.Dense(4, dtype="bfloat16")])


def test_cast_to_compute_skips_the_hinted_layers_as_jax():
    jmod, pmod = _hinted(dtpu), _hinted(dtt)
    jm = dtpu.Model(jmod)
    jm.compile(optimizer="sgd")
    jm.build((5,))
    pm = dtt.Model(pmod, device="cpu").build((5,))
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    jh = jmod.dtype_hints()
    ph = pmod.dtype_hints()
    assert {k: str(v) for k, v in ph.items()} == {
        k: str(np.dtype(v)) if not isinstance(v, str) else v
        for k, v in jh.items()}
    tree = pckpt.unflatten_tree(dict(pm.params))
    for preset in ("mixed_bfloat16", "mixed_float16"):
        want = dtpu.precision.Policy(preset).cast_to_compute(jm.params, jh)
        got = dtt.precision.Policy(preset).cast_to_compute(tree, ph)
        w = dtt.interop.flatten_tree(jax.device_get(want))
        for path, leaf in dtt.interop.iter_leaf_paths(got):
            assert _name(leaf.dtype) == str(w[path].dtype), path
            np.testing.assert_array_equal(
                leaf.detach().to(torch.float32).numpy(),
                w[path].astype(np.float32))
    # The layers read their leaves so under the policy's scope: the
    # forward equals JAX's apply of the cast tree in the scope.
    x = np.random.default_rng(1).integers(0, V, (3, 5)).astype(np.int32)
    pol_j = dtpu.precision.Policy("mixed_bfloat16")
    with pol_j.scope():
        want, _ = jmod.apply(pol_j.cast_to_compute(jm.params, jh),
                             jm.state, x)
    with dtt.precision.Policy("mixed_bfloat16").scope():
        got = pmod(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def trained():
    """{preset: (jax model, port model, jax history, port history)} after
    3 steps, built once a preset."""
    out = {}
    x, y = _data()

    def get(preset):
        if preset not in out:
            jm, pm = _pair(preset)
            out[preset] = (jm, pm, _fit(jm, x, y), _fit(pm, x, y))
        return out[preset]

    return get


@pytest.mark.parametrize("preset", PRESETS)
def test_fit_three_steps_matches_jax(trained, preset):
    jm, pm, hj, hp = trained(preset)
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=RTOL[preset])
    x, y = _data(seed=3, n=7)
    ej = jm.evaluate(x, y, batch_size=4, verbose=0)
    ep = pm.evaluate(x, y, batch_size=4, verbose=0)
    np.testing.assert_allclose(ep["loss"], ej["loss"], rtol=RTOL[preset])
    # f32 masters in both, whatever the policy.
    assert all(t.dtype == torch.float32 for t in pm.params.values())
    assert _name(pm.decode_dtype()) == str(jm.decode_dtype())
    report = pm.last_fit_telemetry
    assert report["precision"] == (None if preset is None else preset)


def test_loss_scale_trajectory_matches_jax():
    """Skip (the scale halves), grow after 2 finite steps, skip again: the
    same scale after every step in both packages."""
    x, y = _data(n=16)
    kw = dict(initial_loss_scale=2.0 ** 20, loss_scale_growth_interval=2)
    jm, pm = lm_pair(vocab=V, num_layers=2, d_model=32, num_heads=2,
                     max_len=T, flash=True)
    jm.compile(optimizer=dtpu.optim.Adam(LR), loss=PALLAS,
               precision=dtpu.precision.Policy("mixed_float16", **kw))
    pm.compile(optimizer=dtt.optim.Adam(LR), loss=PALLAS,
               precision=dtt.precision.Policy("mixed_float16", **kw))
    want, got, counts = [], [], []
    for _ in range(8):
        for m in (jm, pm):
            m.fit(x, y, batch_size=4, epochs=1, steps_per_epoch=1,
                  shuffle=False, verbose=0)
        want.append(float(jax.device_get(
            dtpu.optim.loss_scale_value(jm.opt_state))))
        got.append(float(dtt.optim.loss_scale_value(pm.opt_state)))
        counts.append(pm.opt_state.growth_count)
    assert got == want
    assert min(np.diff(np.log2(got))) == -1  # a skipped step
    assert max(np.diff(np.log2(got))) == 1  # a grown scale
    # Skipped steps left Adam's count behind, as the select does in JAX.
    assert pm.opt_state.inner_state["count"] == int(jax.device_get(
        jm.opt_state.inner_state.inner_state[0].count))


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("preset", PRESETS[1:])
def test_checkpoint_crosses_packages_under_each_policy(tmp_path, trained,
                                                       saver, preset):
    """A checkpoint written by one package under ``preset`` restores in
    the other, compiled the same way, to the file's bits: parameters and
    the optimizer state (the live loss scale of ``mixed_float16``
    included). Every floating leaf on disk is f32."""
    jm, pm, _, _ = trained(preset)
    src = jm if saver == "jax" else pm
    (dtpu.Checkpointer if saver == "jax" else dtt.Checkpointer)(
        tmp_path).save(src)
    jd, pd = _pair(preset, seed=5)  # other weights: the restore must move
    dst = pd if saver == "jax" else jd
    (dtt.Checkpointer if saver == "jax" else dtpu.Checkpointer)(
        tmp_path).restore_into(dst)
    with np.load(tmp_path / "ckpt-3.npz") as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    floating = [k for k, a in flat.items() if a.dtype.kind == "f"]
    assert floating and all(flat[k].dtype == np.float32 for k in floating)
    if saver == "jax":
        params = dtt.interop.params_to_numpy(pd.params)
        opt = pckpt.flatten_tree(dtt.interop.opt_state_to_tree(
            pd.tx, pd.opt_state, pd.params))
    else:
        params = dtt.interop.flatten_tree(jax.device_get(jd.params))
        opt = dtt.interop.flatten_tree(jax.device_get(jd.opt_state))
    for section, tree in (("params", params), ("opt_state", opt)):
        for path, leaf in tree.items():
            np.testing.assert_array_equal(
                np.asarray(leaf), flat[f"{section}/{path}"],
                err_msg=f"{section}/{path}")
    if preset == "mixed_float16":
        scale = float(flat["opt_state/#0"])
        assert scale == float(dtt.optim.loss_scale_value(pm.opt_state)) \
            if saver == "port" else scale == float(jax.device_get(
                dtpu.optim.loss_scale_value(jm.opt_state)))
        live = (dtt.optim.loss_scale_value(pd.opt_state) if saver == "jax"
                else jax.device_get(dtpu.optim.loss_scale_value(
                    jd.opt_state)))
        assert float(live) == scale


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("save_under,restore_under", [
    ("mixed_float16", "mixed_bfloat16"), ("float32", "mixed_float16")])
def test_crossing_loss_scaling_raises_the_format_error(
        tmp_path, trained, saver, save_under, restore_under):
    jm, pm, _, _ = trained(save_under)
    src = jm if saver == "jax" else pm
    (dtpu.Checkpointer if saver == "jax" else dtt.Checkpointer)(
        tmp_path).save(src)
    jd, pd = _pair(restore_under, seed=5)
    dst, ck = ((pd, dtt.Checkpointer) if saver == "jax"
               else (jd, dtpu.Checkpointer))
    with pytest.raises(ValueError, match="optimizer-state FORMAT"):
        ck(tmp_path).restore_into(dst)
