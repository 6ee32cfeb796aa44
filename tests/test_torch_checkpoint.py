"""The port's checkpoints against the JAX package's: the same files.

(a) The port's optimizer state under optax's tree paths
(``interop.opt_state_to_tree``) has the flat paths, shapes and dtypes of
the JAX package's ``flatten_tree(model.opt_state)`` for every named
optimizer, and after two steps from the same parameters the same counts
and hyperparameters (each moment leaf within 1e-5 of its largest
entry: the two frameworks' gradients part by their rounding).
(b) The port resumes itself: 6 straight steps equal 3 + save + restore +
3, bit for bit (parameters, BatchNorm state, momentum or moments, and the
batch cursor).
(c) Across packages, mid-``fit`` through ``ModelCheckpoint``: a port
checkpoint restored by the JAX package and a JAX checkpoint restored by
the port, each continued 2 steps; the continued losses match the saving
package's uninterrupted run at rtol 1e-5 (f32: each side continues from
the same bits, so they part by two steps of rounding).
(d) Weights across packages (``save_weights``/``load_weights``, HDF5 and
npz, and a bare ``export_hdf5`` parameter file): ``predict`` on the
loaded model equals the saving model's at rtol/atol 1e-5 (eval-mode f32
logits, as in ``test_torch_resnet.py``).
(e) The checkpointer's own behaviour: keep and gc, a stale ``latest``
pointer, a corrupt newest file skipped, a corrupt named step raised, a
different optimizer refused with the JAX package's format error.
(f) An async save equals a synchronous one taken at the same step, with
the writer held back until the next step has updated the parameters in
place.
(h) Importing the port imports neither ``h5py`` nor ``tensorboard``.

Models with BatchNorm are the tiny ResNet of ``test_torch_resnet.py`` at
its data seed 4 (see its docstring: the JAX package's own training is
discontinuous at these sizes).
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.checkpoint import core as jckpt
from distributed_tpu.training import callbacks as jcb
from distributed_tpu_torch.checkpoint import core as pckpt
from distributed_tpu_torch.training import callbacks as pcb

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(small_inputs=True, stage_blocks=(1, 1, 1, 1), width=16)
COMPILE = dict(loss="sparse_categorical_crossentropy", metrics=["accuracy"])
OPTIMIZERS = {
    "sgd_momentum": ("SGD", dict(learning_rate=0.05, momentum=0.9)),
    "sgd": ("SGD", dict(learning_rate=0.05)),
    "adam": ("Adam", dict(learning_rate=1e-3)),
    "adamw": ("AdamW", dict(learning_rate=1e-3, weight_decay=0.01)),
    "fused_adam": ("fused_adam", dict(learning_rate=1e-3)),
    "fused_adamw": ("fused_adamw", dict(learning_rate=1e-3,
                                        weight_decay=0.01)),
}


def _opt(pkg, name):
    ctor, kw = OPTIMIZERS[name]
    return getattr(pkg.optim, ctor)(**kw)


def _mnist_data(n=256):
    x, y = dtt.data.synthetic_images(n, (28, 28), 10, 3)
    return x[..., None].astype(np.float32) / 255.0, y.astype(np.int32)


def _resnet_data(n=32):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
    return x, rng.integers(0, 10, n).astype(np.int32)


CASES = {
    # name: (JAX module, port module, input shape, data, batch)
    "mnist": (dtpu.models.mnist_cnn, dtt.models.mnist_cnn, (28, 28, 1),
              _mnist_data, 32),
    "resnet": (lambda: dtpu.models.resnet(50, 10, **TINY),
               lambda: dtt.models.resnet(50, 10, **TINY), (16, 16, 3),
               _resnet_data, 8),
}


def _pair(case, opt):
    """A JAX model and a port model of ``case`` on the JAX model's
    parameters and state, both compiled with the optimizer ``opt``."""
    jmod, pmod, shape, _, _ = CASES[case]
    jm = dtpu.Model(jmod())
    jm.compile(optimizer=_opt(dtpu, opt), **COMPILE)
    jm.build(shape, seed=0)
    pm = dtt.Model(pmod(), device="cpu")
    pm.compile(optimizer=_opt(dtt, opt), **COMPILE)
    pm.build(shape)
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    pm.load_state(dtt.interop.state_from_jax(jax.device_get(jm.state)))
    return jm, pm


def _port(case, opt):
    _, pmod, shape, _, _ = CASES[case]
    pm = dtt.Model(pmod(), device="cpu")
    pm.compile(optimizer=_opt(dtt, opt), **COMPILE)
    pm.build(shape, seed=0)
    return pm


def _port_opt_flat(pm):
    tree = dtt.interop.opt_state_to_tree(pm.tx, pm.opt_state, pm.params)
    return pckpt.flatten_tree(tree)


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_layout_matches_optax(opt):
    jm, pm = _pair("mnist", opt)
    x, y = _mnist_data()
    for m in (jm, pm):
        m.fit(x, y, batch_size=32, epochs=1, steps_per_epoch=2, seed=0,
              verbose=0)
    want = jckpt.flatten_tree(jm.opt_state)
    got = _port_opt_flat(pm)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        assert got[path].dtype == want[path].dtype, path
        if got[path].ndim == 0:  # counts and hyperparameters: exact
            assert got[path] == want[path], path
        else:  # the two frameworks' gradients part by their rounding
            scale = np.abs(want[path]).max()
            assert np.abs(got[path] - want[path]).max() <= 1e-5 * scale, path
    # The mapping round-trips the port's own state, bit for bit.
    back = dtt.interop.opt_state_from_tree(
        pm.tx, dtt.interop.opt_state_to_tree(pm.tx, pm.opt_state, pm.params),
        pm.params)
    again = dtt.interop.opt_state_to_tree(pm.tx, back, pm.params)
    for path, leaf in pckpt.flatten_tree(again).items():
        np.testing.assert_array_equal(leaf, got[path], err_msg=path)


def test_optimizer_mapping_refuses_what_the_port_does_not_run():
    pm = _port("mnist", "adam")
    flat = _port_opt_flat(pm)
    flat["#1/eps_root"] = np.float32(1e-8)
    with pytest.raises(ValueError, match="eps_root"):
        dtt.interop.opt_state_from_tree(pm.tx, flat, pm.params)
    flat = _port_opt_flat(pm)
    flat["#3/#0/#1/dense/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        dtt.interop.opt_state_from_tree(pm.tx, flat, pm.params)


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("case,opt", [("resnet", "sgd_momentum"),
                                      ("mnist", "adam")])
def test_port_resume_matches_uninterrupted_run(tmp_path, case, opt):
    x, y = CASES[case][3]()
    kw = dict(batch_size=CASES[case][4], epochs=1, steps_per_epoch=3,
              verbose=0, seed=3)
    solid = _port(case, opt)
    solid.fit(x, y, **dict(kw, steps_per_epoch=6))
    first = _port(case, opt)
    first.fit(x, y, **kw)
    ck = dtt.Checkpointer(tmp_path / "ck")
    ck.save(first)
    resumed = dtt.Model(CASES[case][1](), device="cpu")  # built by restore
    resumed.compile(optimizer=_opt(dtt, opt), **COMPILE)
    assert ck.restore_into(resumed) == 3
    assert resumed.step == resumed._resumed_step == 3
    resumed.fit(x, y, **kw)
    for got, want in ((resumed.params, solid.params),
                      (resumed.state, solid.state),
                      (_port_opt_flat(resumed), _port_opt_flat(solid))):
        got, want = pckpt.flatten_tree(got), pckpt.flatten_tree(want)
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)


# ------------------------------------------------------------------- (c)
def _losses(pkg_cb, model, x, y, batch, callbacks):
    """Per-step losses of 5 steps in one epoch, read at each step's end."""
    seen = []
    rec = pkg_cb.LambdaCallback(
        on_batch_end=lambda m, s, logs: seen.append(float(logs["loss"])))
    model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=5, seed=1,
              verbose=0, callbacks=list(callbacks) + [rec])
    return seen


@pytest.mark.parametrize("case,opt", [("mnist", "sgd_momentum"),
                                      ("mnist", "adam"),
                                      ("resnet", "sgd_momentum")])
def test_cross_package_resume_mid_fit(tmp_path, case, opt):
    _, pmod, _, data, batch = CASES[case]
    x, y = data()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jm, pm = _pair(case, opt)
    jax_run = _losses(jcb, jm, x, y, batch,
                      [jcb.ModelCheckpoint(jdir, save_freq=3)])
    port_run = _losses(pcb, pm, x, y, batch,
                       [pcb.ModelCheckpoint(pdir, save_freq=3)])
    assert jcb.ModelCheckpoint(jdir).ckpt.all_steps() == [3]
    assert pcb.ModelCheckpoint(pdir).ckpt.all_steps() == [3]

    # Each model then takes the other package's checkpoint, which replaces
    # its parameters, state, optimizer state and step (the JAX model keeps
    # its compiled step: one compile less).
    jax_resumed = _losses(jcb, jm, x, y, batch, [jcb.ModelCheckpoint(
        pdir, save_freq=100, restore=True)])
    assert jm.step == 5 and len(jax_resumed) == 2
    np.testing.assert_allclose(jax_resumed, port_run[3:], rtol=1e-5)
    port_resumed = _losses(pcb, pm, x, y, batch, [pcb.ModelCheckpoint(
        jdir, save_freq=100, restore=True)])
    assert pm.step == 5 and len(port_resumed) == 2
    np.testing.assert_allclose(port_resumed, jax_run[3:], rtol=1e-5)
    # A fresh port model is built from the JAX checkpoint's meta.
    fresh = dtt.Model(pmod(), device="cpu")
    fresh.compile(optimizer=_opt(dtt, opt), **COMPILE)
    assert _losses(pcb, fresh, x, y, batch, [pcb.ModelCheckpoint(
        jdir, save_freq=100, restore=True)]) == port_resumed


def test_jax_checkpoint_restores_bit_for_bit(tmp_path):
    """A JAX save restored by the port holds the file's bits: parameters,
    BatchNorm state and the momentum (the continued losses above then
    start from the same place)."""
    jm, _ = _pair("resnet", "sgd_momentum")
    x, y = _resnet_data()
    jm.fit(x, y, batch_size=8, epochs=1, steps_per_epoch=2, verbose=0)
    dtpu.Checkpointer(tmp_path).save(jm)
    pm = dtt.Model(CASES["resnet"][1](), device="cpu")
    pm.compile(optimizer=_opt(dtt, "sgd_momentum"), **COMPILE)
    assert dtt.Checkpointer(tmp_path).restore_into(pm) == 2
    assert pm.input_shape == (16, 16, 3)
    with np.load(tmp_path / "ckpt-2.npz") as z:
        for section, got in (("params", pm.params), ("state", pm.state),
                             ("opt_state", _port_opt_flat(pm))):
            for path, leaf in pckpt.flatten_tree(got).items():
                want = z[f"{section}/{path}"]
                assert leaf.dtype == want.dtype, path
                np.testing.assert_array_equal(leaf, want, err_msg=path)


# ------------------------------------------------------------------- (d)
@pytest.fixture(scope="module")
def resnet_weights():
    """A tiny ResNet trained 1 step in JAX (so the BatchNorm state has
    moved) and its eval-mode predictions."""
    jm, _ = _pair("resnet", "sgd_momentum")
    x, y = _resnet_data()
    jm.fit(x, y, batch_size=8, epochs=1, steps_per_epoch=1, verbose=0)
    return jm, x[:12]


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_jax_weights_load_into_port(tmp_path, resnet_weights, suffix):
    jm, x = resnet_weights
    path = jm.save_weights(tmp_path / f"w{suffix}")
    pm = _port("resnet", "sgd_momentum")
    pm.load_weights(path)
    want = np.asarray(jm.predict(x, batch_size=8))
    got = pm.predict(x, batch_size=8)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for path_, leaf in dtt.interop.state_to_numpy(pm.state).items():
        np.testing.assert_array_equal(
            leaf, dtt.interop.flatten_tree(jax.device_get(jm.state))[path_])


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_port_weights_load_into_jax(tmp_path, suffix):
    pm = _port("resnet", "sgd_momentum")
    x, y = _resnet_data()
    pm.fit(x, y, batch_size=8, epochs=1, steps_per_epoch=1, verbose=0)
    path = pm.save_weights(tmp_path / f"w{suffix}")
    jm = dtpu.Model(CASES["resnet"][0]())
    jm.compile(optimizer=_opt(dtpu, "sgd_momentum"), **COMPILE)
    jm.build((16, 16, 3), seed=1)
    jm.load_weights(str(path))
    np.testing.assert_allclose(np.asarray(jm.predict(x[:12], batch_size=8)),
                               pm.predict(x[:12], batch_size=8),
                               rtol=1e-5, atol=1e-5)


def test_bare_hdf5_params_and_artifact_load_into_port(tmp_path,
                                                      resnet_weights):
    jm, x = resnet_weights
    path = dtpu.export_hdf5(tmp_path / "p.h5", jm.params, attrs={"v": 1})
    row = dtt.checkpoint.artifact_encode(path)
    out = dtt.checkpoint.artifact_decode(row, tmp_path / "got" / "m.hdf5")
    params, attrs = dtt.import_hdf5(out)
    assert attrs["v"] == 1
    pm = _port("resnet", "sgd_momentum")
    state = {k: v.clone() for k, v in pm.state.items()}
    pm.load_weights(out)
    for path_, leaf in dtt.interop.params_to_numpy(pm.params).items():
        np.testing.assert_array_equal(leaf, pckpt.flatten_tree(params)[path_])
    for k, v in pm.state.items():  # a bare parameter file leaves the state
        assert torch.equal(v, state[k])


def test_load_weights_checks_before_copying(tmp_path):
    pm = _port("mnist", "sgd")
    before = {k: v.clone() for k, v in pm.params.items()}
    bad = dtt.interop.params_to_numpy(pm.params)
    bad["dense_1/kernel"] = np.zeros((3, 3), np.float32)
    dtt.checkpoint.save_npz(tmp_path / "bad.npz", {"params": bad})
    with pytest.raises(ValueError, match="dense_1/kernel"):
        pm.load_weights(tmp_path / "bad.npz")
    for k, v in pm.params.items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(RuntimeError, match="Build the model"):
        dtt.Model(dtt.models.mnist_cnn(), device="cpu").load_weights(
            tmp_path / "bad.npz")


# ------------------------------------------------------------------- (e)
def _fit_steps(m, steps=1):
    x, y = _mnist_data(64)
    m.fit(x, y, batch_size=32, epochs=1, steps_per_epoch=steps, verbose=0)


def test_checkpointer_keep_gc_and_latest(tmp_path):
    m = _port("mnist", "sgd_momentum")
    ck = dtt.Checkpointer(tmp_path / "ck", keep=2)
    for _ in range(4):
        _fit_steps(m)
        ck.save(m)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4 == ck.latest_valid_step()
    # A stale pointer (a crash between the rename and the pointer's write)
    # loses to the newer file; a garbage pointer falls back to the scan.
    (tmp_path / "ck" / "latest").write_text('{"step": 3}')
    assert ck.latest_step() == 4
    (tmp_path / "ck" / "latest").write_text("garbage")
    assert ck.latest_step() == 4


def test_checkpointer_skips_a_corrupt_newest_file(tmp_path):
    m = _port("mnist", "sgd_momentum")
    ck = dtt.Checkpointer(tmp_path, keep=5)
    _fit_steps(m)
    ck.save(m)
    want = {k: v.clone() for k, v in m.params.items()}
    _fit_steps(m)
    ck.save(m)
    (tmp_path / "ckpt-2.npz").write_bytes(b"torn")
    assert not ck.is_valid(2) and ck.latest_valid_step() == 1
    fresh = _port("mnist", "sgd_momentum")
    assert ck.restore_into(fresh) == 1
    for k, v in fresh.params.items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(Exception):  # a named step loads exactly or raises
        ck.restore_into(fresh, step=2)
    with pytest.raises(FileNotFoundError, match="No checkpoints"):
        dtt.Checkpointer(tmp_path / "empty").restore_into(fresh)


def test_checkpointer_refuses_another_optimizer(tmp_path):
    m = _port("mnist", "sgd_momentum")
    _fit_steps(m)
    dtt.Checkpointer(tmp_path).save(m)
    other = _port("mnist", "adam")
    before = {k: v.clone() for k, v in other.params.items()}
    with pytest.raises(ValueError, match="optimizer-state FORMAT"):
        dtt.Checkpointer(tmp_path).restore_into(other)
    for k, v in other.params.items():  # checked before anything moved
        assert torch.equal(v, before[k]), k


def test_npz_meta_and_tree_round_trip(tmp_path):
    tree = {"a": {"b": np.arange(4.0)}, "c": (np.ones(2), {},
                                              {"d": np.zeros(3)})}
    flat = pckpt.flatten_tree(tree)
    assert set(flat) == {"a/b", "c/#0", "c/#2/d"} == set(
        jckpt.flatten_tree(tree))
    back = pckpt.unflatten_tree(flat)
    assert isinstance(back["c"], tuple) and len(back["c"]) == 2
    path = dtt.checkpoint.save_npz(tmp_path / "t.npz",
                                   {"w": torch.ones(2, 3)}, meta={"step": 7})
    got, meta = jckpt.load_npz(path)
    assert meta == {"step": 7} and got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], np.ones((2, 3), np.float32))


# ------------------------------------------------------------------- (f)
def test_async_save_equals_sync_save_despite_in_place_update(tmp_path,
                                                             monkeypatch):
    step3 = threading.Event()
    real_save = pckpt.save_npz

    def held_back(path, tree, meta=None):
        if threading.current_thread().name == "dtpu-ckpt-writer":
            assert step3.wait(60)  # write only after step 3's update
        return real_save(path, tree, meta)

    monkeypatch.setattr(pckpt, "save_npz", held_back)
    m = _port("resnet", "sgd_momentum")
    x, y = _resnet_data()
    seen = {}

    def after(model, step, logs):
        if step == 3:
            seen["p3"] = pckpt.flatten_tree(model.params)
            step3.set()

    cbs = [pcb.ModelCheckpoint(tmp_path / "async", save_freq=2,
                               async_save=True),
           pcb.ModelCheckpoint(tmp_path / "sync", save_freq=2),
           pcb.LambdaCallback(on_batch_end=after)]
    m.fit(x, y, batch_size=8, epochs=1, steps_per_epoch=3, verbose=0,
          callbacks=cbs)
    a, meta_a = pckpt._load_flat(tmp_path / "async" / "ckpt-2.npz")
    s, meta_s = pckpt._load_flat(tmp_path / "sync" / "ckpt-2.npz")
    assert meta_a == meta_s and set(a) == set(s)
    for k in s:
        np.testing.assert_array_equal(a[k], s[k], err_msg=k)
    moved = [k for k in seen["p3"]
             if not np.array_equal(seen["p3"][k], s[f"params/{k}"])]
    assert moved  # step 3 did change the parameters in place


def test_async_writer_error_surfaces_at_the_next_save(tmp_path, monkeypatch):
    def broken(path, tree, meta=None):
        raise OSError("disk full")

    monkeypatch.setattr(pckpt, "save_npz", broken)
    m = _port("mnist", "sgd")
    ck = dtt.Checkpointer(tmp_path, async_save=True)
    ck.save(m)
    with pytest.raises(OSError, match="disk full"):
        dtt.checkpoint.wait_all_async()
    ck.wait()  # the error is raised once


# ------------------------------------------------------------------- (h)
def test_port_import_needs_neither_h5py_nor_tensorboard():
    code = ("import sys\n"
            "import distributed_tpu_torch\n"
            "from distributed_tpu_torch.training import callbacks\n"
            "print(sorted(m for m in ('h5py', 'tensorboard', "
            "'torch.utils.tensorboard') if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
