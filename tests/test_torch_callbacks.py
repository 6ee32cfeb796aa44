"""The port's fit-loop callbacks against the JAX package's, on the same run.

mnist_cnn starts from the JAX model's parameters in both packages and
trains on the same batches (``SGD(0.05)``), with the cases of
``tests/test_callbacks.py``: the hook order and counts,
``ModelCheckpoint``'s saves and its resume (at an epoch's end and mid-epoch,
bit for bit against an uninterrupted port run), ``EarlyStopping`` (and
``restore_best``), ``CSVLogger``, ``LearningRateScheduler``,
``ReduceLROnPlateau``, ``LambdaCallback`` and ``validation_data``. The
logs of the two packages agree at rtol 1e-5 (f32: the two frameworks
round the convolutions' sums differently), the learning rates and the
epochs a callback stops at exactly. ``TensorBoard`` writes through a
stand-in ``SummaryWriter`` (the real import pulls in TensorFlow here and
takes seconds), and ``ProfilerCallback`` writes a Chrome trace of the CPU
steps.
"""

import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.training import callbacks as jcb
from distributed_tpu_torch.training import callbacks as pcb

torch.set_num_threads(1)

COMPILE = dict(loss="sparse_categorical_crossentropy", metrics=["accuracy"])
FIT = dict(batch_size=32, epochs=3, steps_per_epoch=2, seed=0, verbose=0)


def _data(n=128):
    x, y = dtt.data.synthetic_images(n, (28, 28), 10, seed=3)
    return x[..., None].astype(np.float32) / 255.0, y.astype(np.int32)


@pytest.fixture(scope="module")
def start():
    m = dtpu.Model(dtpu.models.mnist_cnn())
    m.compile(optimizer=dtpu.optim.SGD(0.05), **COMPILE)
    m.build((28, 28, 1), seed=0)
    return jax.device_get(m.params)


def _jax(params):
    m = dtpu.Model(dtpu.models.mnist_cnn())
    m.compile(optimizer=dtpu.optim.SGD(0.05), **COMPILE)
    m.build((28, 28, 1), seed=0)
    m.params = m.strategy.put_params(params)
    return m


def _port(params=None):
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    m.compile(optimizer=dtt.optim.SGD(0.05), **COMPILE)
    m.build((28, 28, 1))
    if params is not None:
        m.load_params(dtt.interop.params_from_jax(params))
    return m


def _both(start, make_callbacks, **kw):
    """(JAX history, port history, JAX record, port record): the same fit
    in both packages; ``make_callbacks(cb_module, record)`` gives each
    package's callbacks, which may append to ``record``."""
    x, y = _data()
    out = []
    for cb_mod, model in ((jcb, _jax(start)), (pcb, _port(start))):
        record = []
        hist = model.fit(x, y, callbacks=make_callbacks(cb_mod, record),
                         **dict(FIT, **kw))
        out.append((hist.history, record, model))
    (jh, jr, jm), (ph, pr, pm) = out
    return jh, ph, jr, pr, jm, pm


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_hook_order_counts_and_logs_match_jax(start):
    def cbs(mod, events):
        return [mod.LambdaCallback(
            on_train_begin=lambda m: events.append("train_begin"),
            on_epoch_begin=lambda m, e: events.append(f"epoch_begin:{e}"),
            on_batch_end=lambda m, s, logs: events.append(f"batch:{s}"),
            on_epoch_end=lambda m, e, logs: events.append(f"epoch_end:{e}"),
            on_train_end=lambda m, h: events.append("train_end"),
        )]

    jh, ph, jr, pr, _, _ = _both(start, cbs, epochs=2)
    assert pr == jr == [
        "train_begin",
        "epoch_begin:0", "batch:1", "batch:2", "epoch_end:0",
        "epoch_begin:1", "batch:3", "batch:4", "epoch_end:1",
        "train_end",
    ]
    _close(ph, jh)


def test_validation_data_logs_match_jax(start):
    x, y = _data(160)
    jh, ph, _, pr, _, pm = _both(
        start, lambda mod, rec: [mod.LambdaCallback(
            on_epoch_end=lambda m, e, logs: rec.append(
                getattr(m.module, "training", None)))],
        validation_data=(x[128:], y[128:]))
    assert sorted(ph) == ["accuracy", "loss", "val_accuracy", "val_loss"]
    _close(ph, jh)
    # Validation leaves the module in train mode for the next epoch.
    assert pr == [True] * 3 and not pm.module.training
    # A plain validation iterator needs validation_steps, as in JAX.
    with pytest.raises(ValueError, match="validation_steps"):
        pm.fit(x, y, validation_data=iter([(x, y)]), **FIT)


def test_checkpoint_epoch_and_step_saves(tmp_path):
    x, y = _data()
    cb = pcb.ModelCheckpoint(tmp_path / "e", save_freq="epoch", keep=2)
    _port().fit(x, y, callbacks=[cb], **FIT)
    assert cb.ckpt.all_steps() == [4, 6]  # keep=2 of steps 2, 4, 6
    cb = pcb.ModelCheckpoint(tmp_path / "s", save_freq=3, keep=10)
    _port().fit(x, y, callbacks=[cb], **dict(FIT, epochs=1,
                                             steps_per_epoch=7))
    assert cb.ckpt.all_steps() == [3, 6]
    with pytest.raises(ValueError, match="save_freq"):
        pcb.ModelCheckpoint(tmp_path, save_freq=0)
    # sharded=True saves per-rank block files (checkpoint/sharded.py);
    # buddy= needs them (tests/test_torch_redundancy.py).
    cb = pcb.ModelCheckpoint(tmp_path / "sh", sharded=True, save_freq=3)
    assert isinstance(cb.ckpt, dtt.ShardedCheckpointer)
    _port().fit(x, y, callbacks=[cb], **dict(FIT, epochs=1,
                                             steps_per_epoch=4))
    assert cb.ckpt.all_steps() == [3]
    assert (tmp_path / "sh" / "ckpt-3" / "proc-0.npz").exists()
    with pytest.raises(ValueError, match="buddy= needs sharded=True"):
        pcb.ModelCheckpoint(tmp_path, buddy=True)
    with pytest.raises(ValueError, match="buddy_refresh_every"):
        pcb.ModelCheckpoint(tmp_path, sharded=True, buddy_refresh_every=0)


@pytest.mark.parametrize("save_freq,first_epochs,steps", [
    ("epoch", 2, 2),  # resume at an epoch's end
    (3, 1, 4),  # resume mid-epoch: step 3 of 4
])
def test_restore_resumes_identically(tmp_path, save_freq, first_epochs,
                                     steps):
    """An identical relaunch (same command, no ``initial_epoch``) finishes
    the run: only the epochs and steps not done run, and the result is the
    uninterrupted run's, bit for bit."""
    x, y = _data()
    kw = dict(FIT, epochs=4, steps_per_epoch=steps, seed=11)
    solid = _port()
    solid.fit(x, y, **kw)
    _port().fit(x, y, callbacks=[pcb.ModelCheckpoint(
        tmp_path, save_freq=save_freq, keep=1)],
                **dict(kw, epochs=first_epochs))
    resumed = _port()
    hist = resumed.fit(x, y, callbacks=[pcb.ModelCheckpoint(
        tmp_path, save_freq=100, restore=True)], **kw)
    assert resumed.step == solid.step
    done = 2 * steps if save_freq == "epoch" else 3
    assert len(hist.history["loss"]) == 4 - done // steps
    for k, v in solid.params.items():
        assert torch.equal(resumed.params[k], v), k


def test_early_stopping_matches_jax(start):
    jh, ph, _, _, jm, pm = _both(
        start, lambda mod, rec: [mod.EarlyStopping(
            monitor="loss", patience=0, min_delta=1e9)], epochs=5)
    assert len(ph["loss"]) == len(jh["loss"]) == 2
    _close(ph, jh)
    assert pm.stop_training and jm.stop_training


def test_early_stopping_restore_best(start):
    """``restore_best`` puts back the best epoch's parameters: a
    ``LambdaCallback`` copies them at each epoch's end, and the monitor is
    made to get worse after epoch 0."""
    def run(mod, model):
        values = iter([1.0, 2.0, 3.0])
        snaps = []
        fake = mod.LambdaCallback(on_epoch_end=lambda m, e, logs: (
            logs.__setitem__("loss", next(values)),
            snaps.append(dtt.checkpoint.core.flatten_tree(
                m.params if isinstance(m, dtt.Model)
                else jax.device_get(m.params)))))
        stop = mod.EarlyStopping(monitor="loss", patience=1,
                                 restore_best=True)
        x, y = _data()
        model.fit(x, y, callbacks=[fake, stop], **FIT)
        return snaps[0], dtt.checkpoint.core.flatten_tree(
            model.params if isinstance(model, dtt.Model)
            else jax.device_get(model.params))

    for mod, model in ((jcb, _jax(start)), (pcb, _port(start))):
        best, final = run(mod, model)
        for k in best:
            np.testing.assert_array_equal(final[k], best[k], err_msg=k)


def test_csv_logger_matches_jax(start, tmp_path):
    def rows(path):
        lines = path.read_text().strip().splitlines()
        return lines[0], [[float(v) for v in ln.split(",")]
                          for ln in lines[1:]]

    _both(start, lambda mod, rec: [mod.CSVLogger(
        tmp_path / f"{mod.__name__.split('.')[0]}.csv")])
    jhead, jrows = rows(tmp_path / "distributed_tpu.csv")
    phead, prows = rows(tmp_path / "distributed_tpu_torch.csv")
    assert phead == jhead == "epoch,accuracy,loss"
    assert len(prows) == 3 and [r[0] for r in prows] == [0, 1, 2]
    np.testing.assert_allclose(prows, jrows, rtol=1e-5)


def test_learning_rate_scheduler_matches_jax(start):
    def cbs(mod, seen):
        return [mod.LearningRateScheduler(lambda epoch: 0.1 / (epoch + 1)),
                mod.LambdaCallback(on_epoch_begin=lambda m, e: seen.append(
                    m.get_learning_rate()))]

    jh, ph, jr, pr, _, _ = _both(start, cbs)
    assert pr == jr == [np.float32(0.1), np.float32(0.05),
                        np.float32(0.1 / 3)]
    _close(ph, jh)

    def two_arg(mod, seen):  # schedule(epoch, lr); bare *args probed once
        def wrapped(*args):
            return (lambda epoch, lr: lr * 0.5)(*args)
        return [mod.LearningRateScheduler(wrapped),
                mod.LambdaCallback(on_epoch_begin=lambda m, e: seen.append(
                    m.get_learning_rate()))]

    _, _, jr, pr, _, _ = _both(start, two_arg)
    assert pr == jr == [np.float32(0.025), np.float32(0.0125),
                        np.float32(0.00625)]


def test_reduce_lr_on_plateau_matches_jax(start):
    def drive(mod, model):
        cb = mod.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=2,
                                   min_delta=1e-3)
        cb.on_train_begin(model)
        lrs = []
        for epoch, loss in enumerate([1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5]):
            cb.on_epoch_end(model, epoch, {"loss": loss})
            lrs.append(model.get_learning_rate())
        return lrs

    jlrs, plrs = drive(jcb, _jax(start)), drive(pcb, _port(start))
    assert plrs == jlrs
    assert plrs[2] == np.float32(0.025) and plrs[-1] == np.float32(0.0125)

    def max_mode(mod, model):  # auc rises: no reduction; cooldown counts
        cb = mod.ReduceLROnPlateau(monitor="val_auc", factor=0.5,
                                   patience=1, cooldown=2)
        cb.on_train_begin(model)
        lrs = []
        for epoch, auc in enumerate([0.5, 0.6, 0.6, 0.6, 0.6, 0.6]):
            cb.on_epoch_end(model, epoch, {"val_auc": auc})
            lrs.append(model.get_learning_rate())
        return lrs

    assert max_mode(pcb, _port(start)) == max_mode(jcb, _jax(start))
    # The whole fit with the callback in it: the same rates.
    _, _, jr, pr, _, _ = _both(start, lambda mod, seen: [
        mod.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=0,
                              min_delta=1e9),
        mod.LambdaCallback(on_epoch_end=lambda m, e, logs: seen.append(
            m.get_learning_rate()))])
    assert pr == jr


def test_stop_training_mid_epoch_reports_the_steps_run(start):
    """A callback that sets ``stop_training`` at a step ends the epoch
    there; the epoch's logs are over the steps that ran."""
    def cbs(mod, rec):
        def at(m, step, logs):
            rec.append(float(logs["loss"]))
            if step == 3:
                m.stop_training = True
        return [mod.LambdaCallback(on_batch_end=at)]

    jh, ph, jr, pr, jm, pm = _both(start, cbs,
                                   **dict(FIT, steps_per_epoch=4))
    assert pm.step == jm.step == 3 and len(ph["loss"]) == 1
    np.testing.assert_allclose(pr, jr, rtol=1e-5)
    np.testing.assert_allclose(ph["loss"], [np.mean(np.float32(pr))],
                               rtol=1e-6)
    _close(ph, jh)


def test_tensorboard_writes_scalars_on_the_chief(monkeypatch, tmp_path):
    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(("open", log_dir))

        def add_scalar(self, key, value, step):
            written.append((key, step))

        def flush(self):
            pass

        def close(self):
            written.append(("close",))

    stub = types.ModuleType("torch.utils.tensorboard")
    stub.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", stub)
    x, y = _data()
    _port().fit(x, y, callbacks=[pcb.TensorBoard(tmp_path / "tb")],
                **dict(FIT, epochs=2))
    assert written[0] == ("open", str(tmp_path / "tb"))
    assert sorted(written[1:4]) == [("accuracy", 0), ("learning_rate", 0),
                                    ("loss", 0)]
    assert written[-1] == ("close",) and len(written) == 8
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard package"):
        _port().fit(x, y, callbacks=[pcb.TensorBoard(tmp_path / "tb")],
                    **FIT)


def test_profiler_callback_writes_a_chrome_trace(tmp_path):
    x, y = _data()
    _port().fit(x, y, callbacks=[pcb.ProfilerCallback(
        tmp_path / "prof", start_step=1, num_steps=2)], **FIT)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)


def test_sync_check_passes_on_one_process(start):
    x, y = _data()
    _port(start).fit(x, y, callbacks=[pcb.SyncCheck(
        include_opt_state=True)], **FIT)
    with pytest.raises(ValueError, match="every"):
        pcb.SyncCheck(every=0)


def test_predict_matches_jax_and_takes_a_partial_batch(start):
    x, _ = _data(50)
    jm, pm = _jax(start), _port(start)
    got = pm.predict(x, batch_size=16)
    assert got.shape == (50, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jm.predict(x, batch_size=16)),
                               rtol=1e-5, atol=1e-6)
    # A plain iterator needs steps; its batches' logits are the arrays'.
    with pytest.raises(ValueError, match="steps is required"):
        pm.predict(iter([x]))
    np.testing.assert_array_equal(
        pm.predict(iter([x[:16], x[16:32]]), steps=2), got[:32])
    with pytest.raises(RuntimeError, match="not built"):
        dtt.Model(dtt.models.mnist_cnn(), device="cpu").predict(x)
