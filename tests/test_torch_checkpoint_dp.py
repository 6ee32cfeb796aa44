"""The port's checkpoints over 2 gloo ranks on the CPU.

Two worker processes, started by the port's own launcher, each call
``cluster.initialize(device="cpu")`` and train mnist_cnn under
``DataParallel`` (global batch 64, ``SGD(0.05, momentum=0.9)``) from the
JAX package's parameters, with ``SyncCheck`` (the optimizer state
included) after each epoch. Then:

(i) The reference's model retrieval: every rank calls ``export_hdf5``
and only rank 0 writes; rank 0 sends the file as ``artifact_encode``'s
base64 row through ``report_result``, and the launching process decodes
it with ``artifact_decode``. The JAX package's ``import_hdf5`` and
``evaluate`` on the decoded parameters equal the port's ``evaluate`` on
the ranks (rtol 1e-5: f32 in two frameworks).
(j) Restore over the group: only rank 0's directory holds the
checkpoint (rank 1's is empty). Both ranks restore through
``ModelCheckpoint(restore=True)`` into models built from another seed,
and hold the file's bits (parameters, momentum, counts); a step that
rank 0 cannot load raises on both ranks; their continued
losses equal a single-process resume at rtol 1e-5 (the data-parallel
gate of ``test_torch_dp.py``: two ranks average two 32-row means where
one process takes a 64-row mean).

Every spawned process has a timeout of at most 120 s.
"""

import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu_torch.training import callbacks as pcb

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMPILE = dict(loss="sparse_categorical_crossentropy", metrics=["accuracy"])
RESUME = dict(batch_size=64, epochs=1, steps_per_epoch=5, seed=1, verbose=0)

WORKER = '''
import os
import sys
import zlib

import numpy as np
import torch

torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.checkpoint import core as ckpt
from distributed_tpu_torch.training import callbacks as cbs

spec = dtt.cluster.initialize(device="cpu", timeout=60)
tmp, data_path, ckdir = sys.argv[1:4]
data = np.load(data_path)
x, y = data["x"], data["y"]
strategy = dtt.DataParallel(device="cpu")


def model(seed):
    with strategy.scope():
        m = dtt.Model(dtt.models.mnist_cnn())
        m.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9), **%(compile)r)
    m.build((28, 28, 1), seed=seed)
    return m


m = model(0)
m.load_params({k[2:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("p:")})
m.fit(x, y, batch_size=64, epochs=2, steps_per_epoch=2, seed=0, verbose=0,
      callbacks=[cbs.SyncCheck(include_opt_state=True)])
path = os.path.join(tmp, "trained-%%d.hdf5" %% spec.index)
dtt.export_hdf5(path, m.params)
row = dtt.checkpoint.artifact_encode(path) if spec.is_chief else None
evaluated = m.evaluate(x[:64], y[:64], batch_size=32, verbose=0)

restored, losses = {}, []


def fingerprint(mm):
    tree = {"params": mm.params, "opt_state": dtt.interop.opt_state_to_tree(
        mm.tx, mm.opt_state, mm.params)}
    restored.update({p: zlib.crc32(a.tobytes())
                     for p, a in ckpt.flatten_tree(tree).items()})


if not spec.is_chief:
    ckdir = os.path.join(tmp, "empty-%%d" %% spec.index)
r = model(5)
r.fit(x, y, **%(resume)r, callbacks=[
    cbs.ModelCheckpoint(ckdir, save_freq=100, restore=True),
    cbs.LambdaCallback(
        on_train_begin=fingerprint,
        on_batch_end=lambda mm, s, logs: losses.append(float(logs["loss"])))])
try:  # a step rank 0 does not have: an error on every rank, no hang
    dtt.Checkpointer(ckdir).restore_into(r, step=99)
    missing = None
except (FileNotFoundError, RuntimeError) as e:
    missing = type(e).__name__
dtt.launch.report_result({
    "rank": spec.index, "row": row, "wrote": os.path.exists(path),
    "missing": missing,
    "evaluate": evaluated, "restored": restored, "losses": losses,
    "step": r.step,
    "files": sorted(os.listdir(ckdir)) if os.path.isdir(ckdir) else [],
})
dtt.cluster.shutdown()
'''


def _data():
    x, y = dtt.data.synthetic_images(256, (28, 28), 10, 0)
    return x[..., None].astype(np.float32) / 255.0, y.astype(np.int32)


def _port(start=None, seed=0):
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    m.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9), **COMPILE)
    m.build((28, 28, 1), seed=seed)
    if start is not None:
        m.load_params({k: torch.tensor(v) for k, v in start.items()})
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckdp")
    x, y = _data()
    jm = dtpu.Model(dtpu.models.mnist_cnn())
    jm.compile(optimizer=dtpu.optim.SGD(0.05, momentum=0.9), **COMPILE)
    jm.build((28, 28, 1), seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    np.savez(tmp / "in.npz", x=x, y=y,
             **{f"p:{k}": v for k, v in start.items()})
    # The checkpoint the ranks restore: 3 steps of one process.
    ckdir = tmp / "ck-0"
    _port(start).fit(x, y, **dict(RESUME, steps_per_epoch=3), callbacks=[
        pcb.ModelCheckpoint(ckdir, save_freq=3)])
    single = _port(seed=5)
    single_losses = []
    single.fit(x, y, **RESUME, callbacks=[
        pcb.ModelCheckpoint(ckdir, save_freq=100, restore=True),
        pcb.LambdaCallback(on_batch_end=lambda m, s, logs:
                           single_losses.append(float(logs["loss"])))])
    script = tmp / "worker.py"
    script.write_text(WORKER % dict(compile=COMPILE, resume=RESUME))
    launcher = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": str(ROOT)})
    rows = launcher.run([sys.executable, str(script), str(tmp),
                         str(tmp / "in.npz"), str(ckdir)], 2, timeout=120)
    for r in rows:
        assert r.ok, f"worker {r.index}: {r.error}\n{r.log_tail}"
    return dict(tmp=tmp, ranks={r.index: r.value for r in rows}, x=x, y=y,
                ckdir=ckdir, single_losses=single_losses, jm=jm)


def test_rank0_hdf5_artifact_evaluates_the_same_in_jax(runs):
    ranks = runs["ranks"]
    assert ranks[0]["wrote"] and not ranks[1]["wrote"]
    assert ranks[1]["row"] is None
    out = dtpu.checkpoint.artifact_decode(ranks[0]["row"],
                                          runs["tmp"] / "model.hdf5")
    params, _ = dtpu.checkpoint.import_hdf5(str(out))
    jm = runs["jm"]
    jm.params = jm.strategy.put_params(params)
    want = jm.evaluate(runs["x"][:64], runs["y"][:64], batch_size=32,
                       verbose=0)
    for rank in (0, 1):
        got = ranks[rank]["evaluate"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_restore_over_the_group_from_rank0_files(runs):
    ranks = runs["ranks"]
    # Only rank 0 had the file; both hold its bits.
    assert ranks[0]["files"] == ["ckpt-3.npz", "latest"]
    assert ranks[1]["files"] == []
    with np.load(runs["ckdir"] / "ckpt-3.npz") as z:
        want = {k: zlib.crc32(z[k].tobytes()) for k in z.files
                if k.startswith(("params/", "opt_state/"))}
    assert ranks[0]["restored"] == ranks[1]["restored"] == want
    for rank in (0, 1):
        assert ranks[rank]["step"] == 5
        np.testing.assert_allclose(ranks[rank]["losses"],
                                   runs["single_losses"], rtol=1e-5)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(runs["single_losses"]) == 2
    # A step rank 0 cannot load raises on both ranks instead of leaving
    # rank 1 waiting on the broadcast.
    assert ranks[0]["missing"] == "FileNotFoundError"
    assert ranks[1]["missing"] == "RuntimeError"
