"""The fit loop's telemetry and the repaired event rows against the JAX
package's, on the same runs.

- One ``fit`` in each package (a small LM, arrays, a ``ModelCheckpoint``
  saving mid-epoch; and a plain iterator at K = 2): the same span and
  stall counters (``input_wait``, ``dispatch``, ``checkpoint_wait``), the
  same ``fit/*`` counters, gauges and rings, ``last_fit_telemetry`` with
  the JAX report's key tree (stored in the registry as ``model.fit``),
  and the same event rows in the same order (``metrics_snapshot`` every
  ``DTPU_OBS_FLUSH_EVERY`` dispatches and at the end, ``overlap_report``)
  with the same ``step``/``rank``/``world`` fields.
- The three rows the port lacked: ``prefix_evict`` from an engine whose
  prefix store gives up blocks (the same rows, blocks and all),
  ``corrupt_checkpoint_skipped`` from a restore that skips a torn newest
  file (the same step and path), and ``sync_check_failed`` from a
  ``SyncCheck`` whose replicas differ (a stand-in comparison that raises
  in both packages; the same epoch and step). Every port record passes
  the port's schema, whose rows are the JAX package's.
"""

import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.obs import registry as jreg
from distributed_tpu.serving import Request as JaxRequest
from distributed_tpu.training import callbacks as jcb
from distributed_tpu.utils import sync_check as jsync
from distributed_tpu_torch.obs import registry as preg
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.training import callbacks as pcb
from distributed_tpu_torch.utils import event_schema as evs
from distributed_tpu_torch.utils import sync_check as psync
from distributed_tpu_torch.utils.events import read_events

from test_torch_obs import key_tree
from torch_parity import jax_engine, lm_pair, no_cluster_env  # noqa: F401

torch.set_num_threads(1)

VOCAB, T = 64, 16
TRANSPORT = {"ts", "pid", "event"}


def _data(n=16):
    tok = np.random.default_rng(0).integers(0, VOCAB, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _rows(path, skip=()):
    return [{k: v for k, v in e.items() if k not in TRANSPORT | set(skip)}
            | {"event": e["event"]} for e in read_events(path)]


def _fit_both(tmp_path, monkeypatch, fit):
    """Run ``fit(package, model, callbacks module, directory)`` in each
    package with its own event log and a fresh registry; returns
    [(model, registry snapshot, event rows)] for JAX, then the port."""
    jm, pm = lm_pair(vocab=VOCAB, num_layers=1, d_model=16, num_heads=2,
                     max_len=T, seed=1)
    out = []
    for name, pkg, m, reg, cbs in (("jax", dtpu, jm, jreg, jcb),
                                   ("port", dtt, pm, preg, pcb)):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DTPU_EVENT_LOG", str(path))
        reg.default_registry().reset()
        fit(pkg, m, cbs, tmp_path / name)
        out.append((m, reg.default_registry().snapshot(), _rows(path)))
    return out


def _array_fit(pkg, m, cbs, where):
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    x, y = _data()
    m.fit(x, y, batch_size=4, epochs=2, steps_per_epoch=6, verbose=0,
          callbacks=[cbs.ModelCheckpoint(where, save_freq=4)])


def _iterator_fit(pkg, m, cbs, where):
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              steps_per_execution=2)
    x, y = _data(24)
    batches = ((x[i:i + 4], y[i:i + 4]) for i in range(0, 20, 4))
    m.fit(batches, epochs=1, steps_per_epoch=5, verbose=0)


@pytest.mark.parametrize("fit", [_array_fit, _iterator_fit],
                         ids=["arrays", "iterator_k2"])
def test_fit_telemetry_and_events_match_jax(tmp_path, monkeypatch, fit):
    (jm, jsnap, jrows), (pm, psnap, prows) = _fit_both(tmp_path, monkeypatch,
                                                       fit)
    for section in ("counters", "gauges", "histograms", "rings"):
        assert sorted(psnap[section]) == sorted(jsnap[section]), section
    assert key_tree(pm.last_fit_telemetry) == key_tree(jm.last_fit_telemetry)
    assert preg.default_registry().get_report("model.fit") is (
        pm.last_fit_telemetry)
    assert psnap["counters"]["fit/steps"] == jsnap["counters"]["fit/steps"]
    timing = {"step_seconds", "self_seconds"}
    assert [{k: v for k, v in r.items() if k not in timing} for r in prows] \
        == [{k: v for k, v in r.items() if k not in timing} for r in jrows]
    for r in prows:
        assert evs.check(r) == [], r
        if r["event"] == evs.METRICS_SNAPSHOT:
            assert len(r["step_seconds"]) == len(r["self_seconds"]) > 0
    report = pm.last_fit_telemetry
    assert report["device_memory"] is None  # the CPU, as XLA:CPU's
    assert 0.0 <= report["input_stall_fraction"] <= 1.0


def test_prefix_evict_rows_match_jax(tmp_path, monkeypatch):
    jm, pm = lm_pair(vocab=VOCAB, num_layers=1, d_model=16, num_heads=2,
                     max_len=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (16,)).astype(np.int32)
               for _ in range(6)]
    rows = []
    for name, make, req, m in (("jax", jax_engine, JaxRequest, jm),
                               ("port", Engine, Request, pm)):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DTPU_EVENT_LOG", str(path))
        eng = make(m, max_slots=2, block_size=4, max_len=64, num_blocks=14,
                   prefix_cache=True)
        eng.run([req(p, 8) for p in prompts])
        rows.append([r for r in _rows(path)
                     if r["event"] == evs.PREFIX_EVICT])
    assert rows[1] == rows[0] and len(rows[1]) > 3
    for r in rows[1]:
        assert evs.check(r) == []


def test_corrupt_checkpoint_skipped_rows_match_jax(tmp_path, monkeypatch):
    jm, pm = lm_pair(vocab=VOCAB, num_layers=1, d_model=16, num_heads=2,
                     max_len=T)
    rows = []
    for name, pkg, m in (("jax", dtpu, jm), ("port", dtt, pm)):
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
        where = tmp_path / name
        ck = pkg.Checkpointer(where, keep=5)
        for step in (1, 2):
            m.step = step
            ck.save(m)
        newest = ck._path(2)
        newest.write_bytes(newest.read_bytes()[:100])  # torn
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DTPU_EVENT_LOG", str(path))
        assert pkg.Checkpointer(where).restore_into(m) == 1
        rows.append([r for r in _rows(path, skip=("error",))
                     if r["event"] == evs.CORRUPT_CHECKPOINT_SKIPPED])
    assert [r["step"] for r in rows[1]] == [r["step"] for r in rows[0]] == [2]
    assert rows[1][0]["path"].endswith(rows[0][0]["path"].split("/")[-1])
    assert evs.check(read_events(tmp_path / "port.jsonl")[-1]) == []


def test_sync_check_failed_rows_match_jax(tmp_path, monkeypatch):
    jm, pm = lm_pair(vocab=VOCAB, num_layers=1, d_model=16, num_heads=2,
                     max_len=T)

    def drifted(tree, what):
        raise AssertionError(f"{what}: replicas differ at embedding/table")

    monkeypatch.setattr(jsync, "assert_replicas_identical", drifted)
    monkeypatch.setattr(psync, "assert_replicas_identical", drifted)
    x, y = _data()
    rows = []
    for name, m, cbs in (("jax", jm, jcb), ("port", pm, pcb)):
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DTPU_EVENT_LOG", str(path))
        with pytest.raises(AssertionError, match="replicas differ"):
            m.fit(x, y, batch_size=4, epochs=2, steps_per_epoch=3,
                  verbose=0, callbacks=[cbs.SyncCheck()])
        rows.append([r for r in _rows(path)
                     if r["event"] == evs.SYNC_CHECK_FAILED])
    assert rows[1] == rows[0] == [{
        "event": evs.SYNC_CHECK_FAILED, "epoch": 0, "step": 3,
        "error": "params: replicas differ at embedding/table"}]
