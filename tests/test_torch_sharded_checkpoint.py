"""The port's ``ShardedCheckpointer`` against the JAX package's.

One pair of worker processes (the port's launcher, each under a timeout
of 120 s) runs the checks that need two ranks; the JAX side and the
world-1 cases run here (the port's world-1 ``FSDP`` forms a gloo group
of one in this process).

- A JAX save on 2 devices (one process: ``proc-0.npz`` holds both
  blocks) restores into the port's 2-rank ``FSDP`` bit for bit,
  parameters and optimizer state; the port's 2-rank save (a
  ``proc-<rank>.npz`` each) restores into the JAX ``FSDP`` bit for bit.
- World 2 -> 1 and 1 -> 2, and the strategy chain ZeRO-1 -> FSDP ->
  ``DataParallel`` through saves and restores: bit for bit.
- The JAX package's lifecycle cases (``tests/test_sharded_checkpoint.py``):
  block keys, the manifest as the commit marker, ``keep``, a CRC
  mismatch named by block, auto-restore falling back a step, a garbage
  file, every step corrupt, the async commit deferred to ``wait``, a
  writer's error aborting the commit, a save made before ``compile``,
  a wrong model, and ``ModelCheckpoint(sharded=True)`` resuming.
"""

import json

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu_torch.checkpoint import ShardCorruptionError
from distributed_tpu_torch.checkpoint import sharded as sharded_lib
from distributed_tpu_torch.checkpoint.core import flatten_tree
from torch_parity import WORKER_PRELUDE, lm_tokens, mnist_data, run_pair

torch.set_num_threads(1)

WORKER = WORKER_PRELUDE + '''
from distributed_tpu_torch.checkpoint.core import flatten_tree

base, jax_dir, w1_dir = sys.argv[2], sys.argv[3], sys.argv[4]
out = {"rank": spec.index}


def model(strategy):
    return build(strategy, "mnist", dtt.optim.SGD(0.05, momentum=0.9))


def dump(m, name):
    flat = flatten_tree({"params": m.params, "opt_state": m._opt_tree()})
    if spec.is_chief:
        np.savez(f"{base}_{name}.npz", **flat)


fsdp, zero, dp = (dtt.FSDP(device="cpu"), dtt.ZeroDataParallel(device="cpu"),
                  dtt.DataParallel(device="cpu"))
m = model(fsdp)
ck = dtt.ShardedCheckpointer(jax_dir)
out["jax_step"] = ck.restore_into(m)
out["jax_lr"] = m.get_learning_rate()
dump(m, "from_jax")
fit(m, "mnist", epochs=1)
ck = dtt.ShardedCheckpointer(base + "_port")
ck.save(m)
out["block_bytes"] = ck.last_max_block_bytes
dump(m, "port")
saved_step = m.step

# The world-1 save of this file's test process, into 2 ranks.
m = model(fsdp)
out["w1_step"] = dtt.ShardedCheckpointer(w1_dir).restore_into(m)
dump(m, "from_w1")

# ZeRO-1 -> FSDP -> DataParallel.
chain = []
src = base + "_port"
for i, strategy in enumerate((zero, fsdp, dp)):
    m = model(strategy)
    chain.append(dtt.ShardedCheckpointer(src).restore_into(m))
    dump(m, f"chain{i}")
    src = f"{base}_chain{i}"
    dtt.ShardedCheckpointer(src).save(m)

# Async: nothing committed until wait(); the restore is bit for bit.
m = model(fsdp)
dtt.ShardedCheckpointer(base + "_port").restore_into(m)
ck = dtt.ShardedCheckpointer(base + "_async", async_save=True)
ck.save(m)
before = ck.all_steps()
ck.wait()
out["async"] = [before, ck.all_steps()]
m2 = model(fsdp)
dtt.ShardedCheckpointer(base + "_async").restore_into(m2)
out["async_same"] = same(full(m), full(m2))
out["chain"] = chain
out["saved_step"] = saved_step
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def _jax_fsdp(devices):
    with dtpu.FSDP(devices).scope():
        m = dtpu.Model(dtpu.models.mnist_cnn())
        m.compile(optimizer=dtpu.optim.SGD(0.05, momentum=0.9),
                  loss="sparse_categorical_crossentropy", metrics=[])
    return m.build((28, 28, 1), seed=0)


def _jax_flat(m):
    return dtt.interop.flatten_tree(jax.device_get(
        {"params": m.params, "opt_state": m.opt_state}))


def _port_fsdp(seed=0):
    with dtt.FSDP(device="cpu").scope():
        m = dtt.Model(dtt.models.mnist_cnn())
        m.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9),
                  loss="sparse_categorical_crossentropy", metrics=[])
    return m.build((28, 28, 1), seed=seed)


def _port_flat(m):
    return flatten_tree({"params": m.params, "opt_state": m._opt_tree()})


def _assert_same(got, want):
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=path)


@pytest.fixture
def world1():
    """The port's world-1 group in this process, shut down after."""
    yield
    dtt.cluster.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    x, y = mnist_data()
    tx, ty = lm_tokens()
    devs = jax.devices()[:2]
    jm = _jax_fsdp(devs)
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    jm.fit(x, y, batch_size=64, epochs=1, steps_per_epoch=2, verbose=0,
           seed=0)
    jm.set_learning_rate(3.3e-4)
    dtpu.ShardedCheckpointer(tmp / "jax").save(jm)
    jax_saved = _jax_flat(jm)
    # A world-1 save of the port, for the 2-rank restore.
    try:
        pm = _port_fsdp(seed=5)
        pm.fit(x, y, batch_size=64, epochs=1, steps_per_epoch=1, verbose=0,
               seed=1)
        dtt.ShardedCheckpointer(tmp / "w1").save(pm)
        w1_saved = _port_flat(pm)
    finally:
        dtt.cluster.shutdown()
    np.savez(tmp / "in.npz", x=x, y=y, tx=tx, ty=ty,
             **{f"m:{k}": v for k, v in start.items()})
    port = run_pair(tmp, WORKER, tmp / "in.npz", tmp / "out", tmp / "jax",
                    tmp / "w1")
    got = {}
    for name in ("from_jax", "port", "from_w1", "chain0", "chain1",
                 "chain2"):
        with np.load(tmp / f"out_{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    back = _jax_fsdp(devs)
    back_step = dtpu.ShardedCheckpointer(tmp / "out_port").restore_into(back)
    return dict(tmp=tmp, port=port, got=got, jax_saved=jax_saved,
                w1_saved=w1_saved, jax_back=(back_step, _jax_flat(back)),
                xy=(x, y))


def test_jax_two_device_save_restores_into_two_ranks(runs):
    _assert_same(runs["got"]["from_jax"], runs["jax_saved"])
    for row in runs["port"].values():
        assert row["jax_step"] == 2
        assert row["jax_lr"] == pytest.approx(3.3e-4, abs=1e-9)
    # The JAX save of 2 devices in one process: one file, both blocks.
    assert sorted(p.name for p in (runs["tmp"] / "jax" / "ckpt-2").iterdir()) \
        == ["manifest.json", "proc-0.npz"]


def test_port_two_rank_save_restores_into_jax(runs):
    step, flat = runs["jax_back"]
    assert step == runs["port"][0]["saved_step"] == 3
    _assert_same(flat, runs["got"]["port"])
    step_dir = runs["tmp"] / "out_port" / "ckpt-3"
    assert sorted(p.name for p in step_dir.iterdir()) == [
        "manifest.json", "proc-0.npz", "proc-1.npz"]
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["nprocs"] == 2
    assert manifest["leaves"]["params/dense/kernel"] == {
        "shape": [5408, 64], "dtype": "float32"}
    # Each rank wrote its own block of the (5408, 64) kernel, not the leaf.
    with np.load(step_dir / "proc-1.npz") as z:
        assert "params/dense/kernel@2704,0@2704,64" in z.files
    for row in runs["port"].values():
        assert row["block_bytes"] < 5408 * 64 * 4


def test_world_two_to_one(runs, world1):
    m = _port_fsdp(seed=9)
    assert dtt.ShardedCheckpointer(runs["tmp"] / "out_port").restore_into(
        m) == 3
    _assert_same(_port_flat(m), runs["got"]["port"])


def test_world_one_to_two(runs):
    _assert_same(runs["got"]["from_w1"], runs["w1_saved"])
    for row in runs["port"].values():
        assert row["w1_step"] == 1


def test_strategy_chain_zero1_fsdp_dp(runs):
    for i in range(3):
        _assert_same(runs["got"][f"chain{i}"], runs["got"]["port"])
    for row in runs["port"].values():
        assert row["chain"] == [3, 3, 3]


def test_async_commit_waits_and_restores_bitwise(runs):
    for row in runs["port"].values():
        assert row["async"] == [[], [3]]
        assert row["async_same"]


# -------------------------------------------------- world-1 lifecycle cases
def test_key_roundtrip():
    k = sharded_lib._block_key("params/dense/kernel", (128, 0), (128, 64))
    assert sharded_lib._parse_key(k) == ("params/dense/kernel", (128, 0),
                                         (128, 64))
    k = sharded_lib._block_key("params/bias", (), ())
    assert sharded_lib._parse_key(k) == ("params/bias", (), ())


def _saved(tmp_path, steps=(2, 4)):
    m = _port_fsdp()
    ck = dtt.ShardedCheckpointer(tmp_path)
    for s in steps:
        ck.save(m, step=s)
    return m, ck


def _tamper_block(proc_file):
    """Change one entry of one block and keep the stored CRC map: only the
    block CRC can catch it."""
    with np.load(proc_file, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    key = next(k for k in sorted(data)
               if k != sharded_lib.CRC_KEY and data[k].size)
    tampered = data[key].copy()
    tampered.flat[0] = tampered.flat[0] + 1
    data[key] = tampered
    np.savez(open(proc_file, "wb"), **data)
    return key


def test_manifest_is_commit_marker_and_gc(tmp_path, world1):
    m, ck = _saved(tmp_path, steps=(1, 2, 3, 4))
    (tmp_path / "ckpt-4" / "manifest.json").unlink()
    assert ck.all_steps() == [2, 3]  # keep=3 collected step 1
    assert ck.latest_step() == 3


def test_crc_mismatch_is_loud_and_block_addressed(tmp_path, world1):
    _, ck = _saved(tmp_path)
    key = _tamper_block(tmp_path / "ckpt-4" / "proc-0.npz")
    with pytest.raises(ShardCorruptionError, match="CRC mismatch") as ei:
        ck.restore_into(_port_fsdp(), step=4)
    assert key in str(ei.value) and "proc-0.npz" in str(ei.value)


def test_auto_restore_falls_back_to_previous_step(tmp_path, world1,
                                                  monkeypatch):
    from distributed_tpu_torch.utils import events as events_lib

    monkeypatch.setenv(events_lib.ENV_VAR, str(tmp_path / "ev.jsonl"))
    m, ck = _saved(tmp_path)
    _tamper_block(tmp_path / "ckpt-4" / "proc-0.npz")
    m2 = _port_fsdp(seed=3)
    assert ck.restore_into(m2) == 2
    _assert_same(_port_flat(m2), _port_flat(m))
    ev = [json.loads(line) for line in
          (tmp_path / "ev.jsonl").read_text().splitlines()]
    skip = next(e for e in ev if e["event"] == "corrupt_checkpoint_skipped")
    assert skip["step"] == 4 and "CRC" in skip["error"]


def test_garbage_file_falls_back_and_all_corrupt_raises(tmp_path, world1):
    _, ck = _saved(tmp_path)
    (tmp_path / "ckpt-4" / "proc-0.npz").write_bytes(b"not a zip file")
    assert ck.restore_into(_port_fsdp()) == 2
    _tamper_block(tmp_path / "ckpt-2" / "proc-0.npz")
    with pytest.raises(FileNotFoundError, match="corrupt"):
        ck.restore_into(_port_fsdp())
    with pytest.raises(FileNotFoundError):
        dtt.ShardedCheckpointer(tmp_path / "empty").restore_into(
            _port_fsdp())


def test_commit_is_deferred_and_writer_error_aborts(tmp_path, world1,
                                                    monkeypatch):
    m = _port_fsdp()
    ck = dtt.ShardedCheckpointer(tmp_path, async_save=True)
    ck.save(m, step=1)
    ck.wait()
    assert ck.all_steps() == [1]
    ck.save(m, step=2)
    ck.save(m, step=3)  # the second save commits the first
    assert 2 in ck.all_steps()
    ck.wait()
    assert ck.all_steps() == [1, 2, 3]

    def boom(path, blocks):
        raise OSError("disk full")

    monkeypatch.setattr(sharded_lib, "_write_proc_npz", boom)
    ck.save(m, step=4)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.all_steps() == [1, 2, 3]


def test_uncompiled_save_keeps_fresh_opt_and_wrong_model_raises(
        tmp_path, world1):
    with dtt.FSDP(device="cpu").scope():
        m = dtt.Model(dtt.models.mnist_cnn())
    m.build((28, 28, 1), seed=2)
    ck = dtt.ShardedCheckpointer(tmp_path)
    ck.save(m, step=0)
    m2 = _port_fsdp()
    fresh = _port_flat(m2)
    ck.restore_into(m2, step=0)
    got = _port_flat(m2)
    for k, v in fresh.items():
        if k.startswith("opt_state/"):
            np.testing.assert_array_equal(got[k], v)
    for k, v in flatten_tree({"params": m.params}).items():
        np.testing.assert_array_equal(got[k], v)
    with dtt.FSDP(device="cpu").scope():
        other = dtt.Model(dtt.nn.Sequential([dtt.nn.Flatten(),
                                             dtt.nn.Dense(10)]))
        other.compile(optimizer="sgd",
                      loss="sparse_categorical_crossentropy")
    other.build((28, 28, 1))
    with pytest.raises((KeyError, ValueError)):
        ck.restore_into(other, step=0)


def test_model_checkpoint_sharded_resumes_bitwise(runs, tmp_path, world1):
    x, y = runs["xy"]
    fit = dict(batch_size=64, epochs=2, steps_per_epoch=2, verbose=0, seed=0)
    m = _port_fsdp()
    m.fit(x, y, callbacks=[dtt.callbacks.ModelCheckpoint(
        tmp_path, sharded=True, save_freq=2, async_save=True)], **fit)
    assert (tmp_path / "ckpt-4" / "proc-0.npz").exists()
    assert dtt.ShardedCheckpointer(tmp_path).latest_step() == m.step == 4
    # A run that died after its step-2 save resumes from it.
    import shutil

    shutil.rmtree(tmp_path / "ckpt-4")
    m2 = _port_fsdp(seed=7)
    m2.fit(x, y, callbacks=[dtt.callbacks.ModelCheckpoint(
        tmp_path, sharded=True, restore=True, save_freq=100)], **fit)
    assert m2.step == 4
    _assert_same(_port_flat(m2), _port_flat(m))
