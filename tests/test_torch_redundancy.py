"""The port's buddy-redundancy tier against the JAX package's.

- The ring, the store's commit protocol, retention, invalidation and
  coverage, ``select_restore_tier`` (fresh, stale and missing mirrors) and
  ``redundancy_report``: the same outcomes from the same operations.
- Mirror sets cross-read: a set the JAX package's ``BuddyRedundancy``
  wrote (``mnist_cnn`` after 2 steps of SGD with momentum) restores into
  the port bit for bit, parameters and optimizer state, the same state a
  JAX restore from that set gives JAX, with no disk block read
  (``checkpoint.sharded.read_stats``); a set the port wrote, from
  weights ``interop`` carried from JAX, is indexed by JAX's
  ``BuddyStore.build_index`` and restores into JAX bit for bit.
- In-process ``ModelCheckpoint(buddy=)``: the buddy restore continues to
  the uninterrupted run's bits with zero disk reads; a lost segment falls
  back to the disk; a stale mirror loses to a newer disk step; a failed
  refresh degrades to a warning; ``kill_during_refresh`` fires between
  the two commits; the telemetry's ``redundancy`` entry.
- Two gloo ranks (one launch, four cases): a single loss restored from
  the buddy tier, a pair loss falling back to disk, a stale mirror
  rejected for disk, and an FSDP mirror set restored into
  ``DataParallel`` (resharded on read); each resumed run ends
  bit-identical to the uninterrupted one.
- A real supervised gang through ``python -m distributed_tpu_torch.launch
  --supervise --buddy-store-dir --event-log``: rank 1 of a small LM is
  killed by ``DTPU_FAULT=kill:at_step=3``, the gang resumes from the
  buddy tier with 0 disk block reads and ends bit-identical to the
  uninterrupted run; its ``recovery`` row and flight dump are read back
  (the dump by both packages' readers).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu import resilience as jres
from distributed_tpu.checkpoint import sharded as jsharded
from distributed_tpu.obs import flight as jflight
from distributed_tpu.utils import profiler as jprofiler
from distributed_tpu_torch import resilience as pres
from distributed_tpu_torch.checkpoint import sharded as psharded
from distributed_tpu_torch.checkpoint.core import flatten_tree
from distributed_tpu_torch.launch import __main__ as launch_cli
from distributed_tpu_torch.obs import flight as pflight
from distributed_tpu_torch.resilience import faults as pfaults
from distributed_tpu_torch.utils import profiler as pprofiler
from torch_parity import ROOT, mnist_data, no_cluster_env, run_pair  # noqa: F401

torch.set_num_threads(1)


# ------------------------------------------------------------- the store --
def test_ring_matches_jax():
    for world in (1, 2, 3, 4, 8):
        for r in range(world):
            assert pres.mirror_holder(r, world) == jres.mirror_holder(r, world)
            assert pres.mirror_source(r, world) == jres.mirror_source(r, world)
            assert pres.mirror_source(pres.mirror_holder(r, world),
                                      world) == r


def _blocks(sharded, val):
    key = sharded._block_key("params/w", (0, 0), (4, 4))
    return {key: np.full((4, 4), float(val), np.float32)}


def _manifest(source, world):
    return {"source": source, "world": world, "seed": 0, "input_shape": [4],
            "leaves": {"params/w": {"shape": [4, 4], "dtype": "float32"}}}


def _store_story(res, sharded, root):
    """One sequence of store operations; returns what each step saw."""
    st = res.BuddyStore(root, keep=2)
    seen = []
    torn = st._role_dir(0, "self") / "mirror-7"
    torn.mkdir(parents=True)
    np.save(torn / "block-0.npy", np.zeros(3))
    (st._role_dir(0, "self") / "mirror-8.tmp-1").mkdir()
    seen.append(("torn", st.committed_steps(0, "self"), st.available_step()))
    for step in (1, 2, 3):
        for src in range(3):
            st.write_mirror(src, "self", step, _blocks(sharded, src),
                            _manifest(src, 3))
            st.write_mirror(res.mirror_holder(src, 3), "peer", step,
                            _blocks(sharded, src), _manifest(src, 3))
    seen.append(("kept", st.committed_steps(0, "self"),
                 st.committed_steps(1, "peer"), st.available_step(),
                 st.bytes_held(0)))
    st.write_mirror(0, "self", 4, _blocks(sharded, 0), _manifest(0, 2))
    seen.append(("mixed_world", st.available_step()))
    seen.append(("single_loss", st.invalidate_ranks([1, 5]),
                 st.available_step()))
    index, merged = st.build_index(3)
    seen.append(("index", sorted(index.blocks), merged["step"],
                 merged["source"] in (0, 2)))
    seen.append(("pair_loss", st.invalidate_ranks([2]),
                 st.available_step()))
    seen.append(("missing", type(_raised(lambda: st.build_index(3)))
                 .__name__))
    return seen


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return e
    return None


def test_store_protocol_matches_jax(tmp_path):
    got = _store_story(pres, psharded, tmp_path / "port")
    want = _store_story(jres, jsharded, tmp_path / "jax")
    assert got == want
    assert got[1][3] == 3 and got[3][2] == 3 and got[5][2] is None


class _Disk:
    def __init__(self, step):
        self.step = step

    def latest_step(self):
        return self.step


@pytest.mark.parametrize("mirror", [None, 3, 5])
@pytest.mark.parametrize("disk", [None, 4])
def test_select_restore_tier_matches_jax(tmp_path, mirror, disk):
    """Fresh (mirror >= disk), stale (mirror < disk) and missing tiers."""
    out = {}
    for name, res, sharded in (("port", pres, psharded),
                               ("jax", jres, jsharded)):
        root = tmp_path / name
        if mirror is not None:
            st = res.BuddyStore(root)
            for src in range(2):
                st.write_mirror(src, "self", mirror, _blocks(sharded, src),
                                _manifest(src, 2))
        buddy = res.BuddyRedundancy(root, rank=0, world=2)
        out[name] = [res.select_restore_tier(b, d) for b, d in (
            (buddy, _Disk(disk)), (None, _Disk(disk)), (buddy, None),
            (None, None))]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("args", [(100, 50, 4), (100, 50, None), (0, 10, 1),
                                  (3, 7, 2), (123456789, 1, 8)])
def test_redundancy_report_matches_jax(args):
    s, m, w = args
    assert pprofiler.redundancy_report(s, m, world=w) == \
        jprofiler.redundancy_report(s, m, world=w)


def test_ram_dir_is_tmpfs_when_writable():
    for res in (pres, jres):
        d = res.ram_dir(prefix="dtt-test-")
        try:
            assert d.is_dir() and d.name.startswith("dtt-test-")
            if os.access("/dev/shm", os.W_OK):
                assert str(d).startswith("/dev/shm/")
        finally:
            os.rmdir(d)


# ----------------------------------------------------- cross-package sets --
def _jax_model():
    m = dtpu.Model(dtpu.models.mnist_cnn())
    m.compile(optimizer=dtpu.optim.SGD(0.05, momentum=0.9),
              loss="sparse_categorical_crossentropy", metrics=[])
    return m.build((28, 28, 1), seed=0)


def _port_model(params=None):
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    m.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9),
              loss="sparse_categorical_crossentropy", metrics=[])
    m.build((28, 28, 1))
    if params is not None:
        dtt.interop.place(m, params=params)
    return m


def _jax_flat(m):
    return dtt.interop.flatten_tree(jax.device_get(
        {"params": m.params, "opt_state": m.opt_state}))


def _port_flat(m):
    return flatten_tree({"params": m.params, "opt_state": m._opt_tree()})


def _assert_same(got, want):
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=path)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sets")
    x, y = mnist_data(128)
    jm = _jax_model()
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    jm.fit(x, y, batch_size=64, epochs=1, steps_per_epoch=2, verbose=0,
           seed=0)
    jres.BuddyRedundancy(tmp / "jax", rank=0, world=1,
                         async_refresh=False).refresh(jm)
    pm = _port_model(params=start)
    pm.fit(x, y, batch_size=64, epochs=1, steps_per_epoch=2, verbose=0,
           seed=0)
    buddy = pres.BuddyRedundancy(tmp / "port", rank=0, world=1)
    buddy.refresh(pm)
    buddy.wait()
    return dict(tmp=tmp, jm=jm, pm=pm)


def test_jax_mirror_set_restores_into_port_as_into_jax(sets):
    tmp = sets["tmp"]
    reads = dict(psharded.read_stats)
    fresh = _port_model()
    step = pres.BuddyRedundancy(tmp / "jax", rank=0, world=1).restore_into(
        fresh)
    assert step == fresh.step == 2
    assert psharded.read_stats == reads  # RAM only
    back = _jax_model()
    assert jres.BuddyRedundancy(tmp / "jax", rank=0,
                                world=1).restore_into(back) == 2
    _assert_same(_port_flat(fresh), _jax_flat(back))
    _assert_same(_port_flat(fresh), _jax_flat(sets["jm"]))


def test_port_mirror_set_is_read_by_jax(sets):
    tmp = sets["tmp"]
    store = jres.BuddyStore(tmp / "port")
    assert store.available_step() == 2
    index, manifest = store.build_index(2)
    assert isinstance(index, jres.redundancy._MirrorIndex)
    jm_index, jm_manifest = jres.BuddyStore(tmp / "jax").build_index(2)
    assert sorted(index.blocks) == sorted(jm_index.blocks)
    assert manifest["leaves"] == jm_manifest["leaves"]
    assert sorted(manifest["keys"]) == sorted(jm_manifest["keys"])
    reads = dict(jsharded.read_stats)
    back = _jax_model()
    assert jres.BuddyRedundancy(tmp / "port", rank=0,
                                world=1).restore_into(back) == 2
    assert jsharded.read_stats == reads
    _assert_same(_jax_flat(back), _port_flat(sets["pm"]))


# ------------------------------------------------------------- in-process --
def _lm():
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=2, d_model=16,
                                            num_heads=2, max_len=8),
                  device="cpu")
    m.compile(optimizer=dtt.optim.Adam(1e-3),
              loss="sparse_categorical_crossentropy")
    return m


X = np.random.default_rng(0).integers(0, 32, (64, 8)).astype(np.int32)
FIT = dict(batch_size=8, epochs=2, steps_per_epoch=3, shuffle=True, seed=0,
           verbose=0)


def _stop_at(step):
    class Stop(dtt.callbacks.Callback):
        def on_batch_end(self, model, s, logs):
            if s == step:
                model.stop_training = True
    return Stop()


def _ckpt(tmp, **kw):
    return dtt.callbacks.ModelCheckpoint(tmp / "ckpt", sharded=True, **kw)


def _same_params(a, b):
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


@pytest.fixture(scope="module")
def solid():
    m = _lm()
    m.fit(X, X, **FIT)
    return m


def test_buddy_restore_zero_disk_reads_bitwise(tmp_path, solid, monkeypatch):
    events = tmp_path / "ev.jsonl"
    monkeypatch.setenv("DTPU_EVENT_LOG", str(events))
    store = tmp_path / "store"
    first = _lm()
    first.fit(X, X, callbacks=[_ckpt(tmp_path, save_freq=3, buddy=store),
                               _stop_at(5)], **FIT)
    red = first.last_fit_telemetry["redundancy"]
    assert red["mirror_host_bytes"] > 0 and red["overhead_ratio"] > 1.0
    assert red["world"] == 1
    reads = dict(psharded.read_stats)
    again = _lm()
    again.fit(X, X, callbacks=[_ckpt(tmp_path, save_freq=3, restore=True,
                                     buddy=store)], **FIT)
    assert psharded.read_stats == reads
    assert _same_params(again, solid)
    kinds = [(e["event"], e.get("tier"), e.get("step"))
             for e in dtt.resilience.read_events(events)
             if e["event"] in ("restore_begin", "restore_end",
                               "post_restore_step")]
    assert kinds == [("restore_begin", "buddy", None),
                     ("restore_end", "buddy", 5),
                     ("post_restore_step", None, 6)]


def test_lost_segment_falls_back_to_disk(tmp_path, solid):
    store = tmp_path / "store"
    _lm().fit(X, X, callbacks=[_ckpt(tmp_path, save_freq=2, buddy=store),
                               _stop_at(5)], **FIT)
    assert pres.BuddyStore(store).invalidate_ranks([0]) == [0]
    reads = psharded.read_stats["block_reads"]
    again = _lm()
    cb = _ckpt(tmp_path, save_freq=2, restore=True, buddy=store)
    again.fit(X, X, callbacks=[cb], **FIT)
    assert psharded.read_stats["block_reads"] > reads  # the disk tier
    assert _same_params(again, solid)


def test_stale_mirror_loses_to_newer_disk(tmp_path, solid):
    store = tmp_path / "store"
    _lm().fit(X, X, callbacks=[
        _ckpt(tmp_path, save_freq=2, buddy=store, buddy_refresh_every=3),
        _stop_at(4)], **FIT)
    buddy = pres.BuddyRedundancy(store)
    disk = dtt.ShardedCheckpointer(tmp_path / "ckpt")
    assert (buddy.available_step(), disk.latest_step()) == (3, 4)
    assert pres.select_restore_tier(buddy, disk) == ("disk", 4)
    again = _lm()
    again.fit(X, X, callbacks=[_ckpt(tmp_path, save_freq=2, restore=True,
                                     buddy=store)], **FIT)
    assert _same_params(again, solid)


def test_refresh_failure_degrades_not_raises(tmp_path, monkeypatch):
    buddy = pres.BuddyRedundancy(tmp_path / "store", rank=0, world=1)

    def broken(*a, **k):
        raise OSError("tmpfs full")

    monkeypatch.setattr(buddy.store, "write_mirror", broken)
    m = _lm()
    m.fit(X, X, callbacks=[_ckpt(tmp_path, save_freq=100, buddy=buddy)],
          **dict(FIT, epochs=1))
    assert isinstance(buddy.last_refresh_error, OSError)
    assert buddy.available_step() is None and m.step == 3


def test_kill_during_refresh_fires_between_the_commits(tmp_path,
                                                       monkeypatch):
    """The port's and JAX's writers both leave the self copy committed
    and the peer push missing."""
    class Killed(Exception):
        pass

    def fake_exit(code):
        raise Killed(code)

    monkeypatch.setattr(os, "_exit", fake_exit)
    monkeypatch.setattr(pfaults, "rank_world", lambda: (0, 2))
    import jax as _jax

    monkeypatch.setattr(_jax, "process_index", lambda: 0)
    monkeypatch.setattr(_jax, "process_count", lambda: 2)
    out = {}
    for name, res, model in (("port", pres, _lm().build((8,))),
                             ("jax", jres, _jax_model())):
        inj = res.FaultInjector("kill_during_refresh", rank=0, at_step=2)
        inj.on_train_begin(model)
        buddy = res.BuddyRedundancy(tmp_path / name, rank=0, world=2,
                                    async_refresh=False)
        buddy.refresh(model, step=1)  # before at_step: no fire
        buddy.refresh(model, step=2)
        inj.on_train_end(model, None)
        st = buddy.store
        out[name] = (inj.fired, st.committed_steps(0, "self"),
                     st.committed_steps(1, "peer"),
                     type(buddy.last_refresh_error).__name__)
    assert out["port"] == out["jax"] == (True, [1, 2], [1], "Killed")


# --------------------------------------------------------- two gloo ranks --
GANG = r'''
import sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import distributed_tpu_torch as dtt
from distributed_tpu_torch import resilience as res
from distributed_tpu_torch.checkpoint import sharded as sharded_lib

spec = dtt.cluster.initialize(device="cpu", timeout=60)
rank = spec.index
tmp = Path(sys.argv[1])
X = np.random.default_rng(0).integers(0, 32, (64, 8)).astype(np.int32)
FIT = dict(batch_size=8, epochs=2, steps_per_epoch=3, shuffle=True, seed=0,
           verbose=0)


def lm(strategy):
    with strategy(device="cpu").scope():
        m = dtt.Model(dtt.models.transformer_lm(32, num_layers=2, d_model=16,
                                                num_heads=2, max_len=8))
        m.compile(optimizer=dtt.optim.Adam(1e-3),
                  loss="sparse_categorical_crossentropy")
    return m


class Stop(dtt.callbacks.Callback):
    def __init__(self, at):
        self.at = at

    def on_batch_end(self, model, step, logs):
        if step == self.at:
            model.stop_training = True


def ckpt(d, **kw):
    return dtt.callbacks.ModelCheckpoint(d / "ckpt", sharded=True, **kw)


def digest(m):
    return {k: float(v.double().sum()) for k, v in m.params.items()}


solid = lm(dtt.DataParallel)
solid.fit(X, X, **FIT)
out = {"solid": digest(solid)}


def case(name, strategy, stop, lose, restore_strategy=None, **kw):
    d = tmp / name
    store = d / "store"
    lm(strategy).fit(X, X, callbacks=[ckpt(d, buddy=store, **kw),
                                      Stop(stop)], **FIT)
    dist.barrier()
    if rank == 0:
        res.BuddyStore(store).invalidate_ranks(lose)
    dist.barrier()
    reads = sharded_lib.read_stats["block_reads"]
    m = lm(restore_strategy or strategy)
    cb = ckpt(d, restore=True, buddy=store, **kw)
    tier = cb._select_tier()
    m.fit(X, X, callbacks=[cb], **FIT)
    out[name] = {"tier": tier,
                 "reads": sharded_lib.read_stats["block_reads"] - reads,
                 "params": digest(m)}


# rank 1 dies: its segment goes; rank 0 holds rank 1's mirror.
case("single", dtt.DataParallel, 5, [1], save_freq=3)
# both die: no copy of either shard survives in RAM.
case("pair", dtt.DataParallel, 5, [0, 1], save_freq=3)
# mirrors every 3 steps, disk every 2: the disk's step 4 is newer.
case("stale", dtt.DataParallel, 4, [1], save_freq=2, buddy_refresh_every=3)
# FSDP blocks mirrored, restored into DataParallel's whole leaves.
case("reshard", dtt.FSDP, 5, [1], restore_strategy=dtt.DataParallel,
     save_freq=3)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


def test_two_ranks_single_pair_stale_and_reshard(tmp_path):
    got = run_pair(tmp_path, GANG, tmp_path, timeout=240)
    for rank, out in got.items():
        assert out["single"]["tier"] == ["buddy", 5], rank
        assert out["single"]["reads"] == 0
        assert out["pair"]["tier"] == ["disk", 3]
        assert out["pair"]["reads"] > 0
        assert out["stale"]["tier"] == ["disk", 4]
        assert out["reshard"]["tier"] == ["buddy", 5]
        assert out["reshard"]["reads"] == 0
        for name in ("single", "pair", "stale", "reshard"):
            assert out[name]["params"] == out["solid"], (rank, name)


# ------------------------------------------------------ a supervised gang --
SUPERVISED = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.resilience import BuddyRedundancy, FaultInjector

spec = dtt.cluster.initialize(device="cpu", timeout=60)
X = np.random.default_rng(0).integers(0, 32, (64, 8)).astype(np.int32)
with dtt.DataParallel(device="cpu").scope():
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=2, d_model=16,
                                            num_heads=2, max_len=8))
    m.compile(optimizer=dtt.optim.Adam(1e-3),
              loss="sparse_categorical_crossentropy")
# The asynchronous refresh of ModelCheckpoint(buddy=True).
buddy = BuddyRedundancy.from_env()


class Settle(dtt.callbacks.Callback):
    """Waits out the refresh writer before the kill at step 3, so the kill
    finds that step's mirror committed."""

    def on_batch_end(self, model, step, logs):
        if step == 3 and buddy is not None:
            buddy.wait()


cbs = [dtt.callbacks.ModelCheckpoint(sys.argv[1], sharded=True, save_freq=2,
                                     restore=True, buddy=buddy), Settle(),
       *filter(None, [FaultInjector.from_env()])]
m.fit(X, X, batch_size=8, epochs=2, steps_per_epoch=3, shuffle=True, seed=0,
      verbose=0, callbacks=cbs)
dtt.launch.report_result({k: float(v.double().sum())
                          for k, v in m.params.items()})
dtt.cluster.shutdown()
'''


def test_supervised_gang_kill_resumes_from_buddy_tier(tmp_path, monkeypatch):
    script = tmp_path / "worker.py"
    script.write_text(SUPERVISED)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("DTPU_FAULT", "kill:at_step=3,rank=1")
    monkeypatch.setenv("DTPU_FAULT_MARKER", str(tmp_path / "fired"))
    log, rows = tmp_path / "ev.jsonl", tmp_path / "rows.json"
    store = tmp_path / "store"
    rc = launch_cli.main([
        "--num-workers", "2", "--supervise", "--checkpoint-dir",
        str(tmp_path / "ckpt"), "--buddy-store-dir", str(store),
        "--event-log", str(log), "--timeout", "120", "--results-json",
        str(rows), str(script), str(tmp_path / "ckpt")])
    assert rc == 0
    got = [r["value"] for r in json.loads(rows.read_text())]
    events = dtt.resilience.read_events(log)
    kinds = [e["event"] for e in events]
    assert kinds.count("attempt_start") == 2 and kinds[-1] == "run_complete"
    assert next(e for e in events if e["event"] == "fault_injected")[
        "step"] == 3
    inv = next(e for e in events if e["event"] == "buddy_segments_invalidated")
    assert inv["ranks"] == [1]  # rank 0's gloo error is collateral
    row = next(e for e in events if e["event"] == "recovery")
    assert (row["restore_tier"], row["restore_step"],
            row["disk_block_reads"]) == ("buddy", 3, 0)
    assert row["restore_s"] is not None and row["recompile_s"] is not None
    (dump,) = row["flight_dumps"]
    for read in (pflight.read_dump, jflight.read_dump):
        records = read(dump)
        assert records[0]["kind"] == "flight_header"
        assert records[0]["reason"] == "fault:kill" and \
            records[0]["rank"] == 1
        # The kill comes from a callback at step 3's batch end, before the
        # fit loop records that step (as in JAX).
        assert [r["step"] for r in records[1:]] == [1, 2]
    monkeypatch.delenv("DTPU_FAULT")
    rc = launch_cli.main(["--num-workers", "2", "--timeout", "120",
                          "--results-json", str(rows), str(script),
                          str(tmp_path / "ref")])
    assert rc == 0
    assert got == [r["value"] for r in json.loads(rows.read_text())]
