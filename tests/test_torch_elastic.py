"""The port's elastic gangs against the JAX package's.

- ``ElasticPolicy`` (validation, ``snap``) and ``FailureLedger`` over
  grids of arguments; the supervisor's row classification (collateral,
  initiated, preemption) over the launcher's dispositions.
- Both ``Supervisor``\\ s with an ``ElasticPolicy``, driven by the same
  scripted sized and host-list launchers (the cases of the JAX package's
  ``tests/test_elastic.py``): the same resizes, worlds, host lists,
  ``DTPU_ELASTIC_WORLD`` values and events.
- A real gang through ``python -m distributed_tpu_torch.launch
  --supervise --elastic-min-workers 2 --elastic-divisor 8``: 4 gloo ranks
  of a small FSDP LM whose rank 3 dies at step 3 on every attempt; after
  two such attempts the gang re-forms at world 2 from the sharded
  checkpoint (resharded 4 -> 2: both ranks resume from the step saved
  before the kill), finishes, and its last loss is the uninterrupted
  4-rank run's within 1e-5 (the same global batch of 8 rows, summed in
  another order).
"""

import json

import numpy as np
import pytest
import torch

from distributed_tpu.resilience import elastic as jel
from distributed_tpu.resilience import supervisor as jsup
from distributed_tpu.launch import WorkerResult as JRow
from distributed_tpu_torch.launch import WorkerResult as PRow
from distributed_tpu_torch.launch import __main__ as launch_cli
from distributed_tpu_torch.resilience import elastic as pel
from distributed_tpu_torch.resilience import supervisor as psup
from torch_parity import ROOT
from torch_resilience_parity import row_makers, run_both

torch.set_num_threads(1)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("raise", type(e).__name__, str(e))


POLICIES = [
    {}, {"min_workers": 2}, {"min_workers": 2, "max_workers": 4},
    {"min_workers": 2, "divisor_of": 32}, {"min_workers": 3,
                                           "divisor_of": 64},
    {"min_workers": 1, "max_workers": 8, "divisor_of": 12},
    {"min_workers": 5, "divisor_of": 12}, {"failure_threshold": 1},
    {"min_workers": 0}, {"min_workers": 4, "max_workers": 2},
    {"failure_threshold": 0}, {"divisor_of": 0}, {"max_resizes": -1},
]


@pytest.mark.parametrize("kw", POLICIES,
                         ids=[str(i) for i in range(len(POLICIES))])
def test_elastic_policy_snap_matches_jax(kw):
    def probe(mod):
        p = mod.ElasticPolicy(**kw)
        return [p.snap(n, dm) for n in range(0, 10) for dm in (1, 4, 8)]

    assert _outcome(lambda: probe(pel)) == _outcome(lambda: probe(jel))


def test_failure_ledger_matches_jax():
    seq = [[1], [1], [], [1, 2], [2], [0], [0], [3], [3], [3]]
    got = {}
    for name, mod in (("port", pel), ("jax", jel)):
        led = mod.FailureLedger()
        trace = []
        for i, initiators in enumerate(seq):
            led.record(initiators)
            trace.append((dict(led.counts), led.attempts_recorded,
                          sorted(led.permanent(2)), sorted(led.permanent(3))))
            if i == 6:
                led.reset()
        got[name] = trace
    assert got["port"] == got["jax"]
    assert got["port"][1][2] == [1]


def _rows(Row):
    r = row_makers(Row)
    return [
        r.ok(0), r.fail(1), r.legacy_fail(2), r.pre(3), r.collateral(4),
        r.collateral(5, disposition=None),
        r.collateral(6, error=None, disposition=None),
        r.collateral(7, error="liveness", disposition=None),
        r.collateral(8, error="timeout", disposition=None),
        r.collateral(9, error="timeout", disposition="timeout"),
        r.collateral(10, error="liveness probe", disposition="liveness_killed"),
        Row(index=11, ok=False, error="Preflight failed",
            disposition="launch_error"),
    ]


def test_row_classification_matches_jax():
    def classify(mod, Row):
        rows = _rows(Row)
        per_row = [(mod._gang_collateral(r), mod._initiated(r))
                   for r in rows]
        groups = [mod._classify_preemption(g) for g in (
            [], [rows[3]], [rows[3], rows[4]], [rows[3], rows[6]],
            [rows[3], rows[1]], [rows[4]], [rows[3], rows[9]],
            [rows[3], rows[10]])]
        return per_row, groups

    assert classify(psup, PRow) == classify(jsup, JRow)


SCENARIOS = {
    "attribution_shrink": lambda: dict(
        n=4, script=[lambda r, w: r.gang_fail(w, 1)] * 2
        + [lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=1, backoff=0.0),
        elastic=dict(min_workers=2, failure_threshold=2, divisor_of=64)),
    "shrink_prevents_budget_exhaustion": lambda: dict(
        n=4, script=[lambda r, w: r.gang_fail(w, 1)] * 2
        + [lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=1, backoff=0.0),
        elastic=dict(min_workers=1, failure_threshold=2)),
    "fixed_size_control_exhausts": lambda: dict(
        n=4, script=[lambda r, w: r.gang_fail(w, 1)] * 3,
        policy=dict(max_restarts=1, backoff=0.0)),
    "probe_shrinks_then_grows": lambda: dict(
        n=4, script=[lambda r, w: r.gang_fail(w, 1),
                     lambda r, w: r.gang_fail(w, 0),
                     lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=2, backoff=0.0),
        elastic=dict(min_workers=2, max_workers=4, probe=[4, 2, 4])),
    "initial_probe": lambda: dict(
        n=4, script=[lambda r, w: r.gang_ok(w)],
        elastic=dict(min_workers=1, probe=[2])),
    "max_resizes_cap": lambda: dict(
        n=4, script=[lambda r, w: r.gang_fail(w, 0)] * 5,
        policy=dict(max_restarts=1, backoff=0.0),
        elastic=dict(min_workers=2, max_workers=4, probe=[4, 2, 4, 2, 4],
                     max_resizes=2)),
    "non_elastic_unchanged": lambda: dict(
        n=4, script=[lambda r, w: r.gang_fail(w, 1),
                     lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=2, backoff=0.0)),
    "launch_errors_unattributable": lambda: dict(
        n=4, script=["raise", "raise", lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=2, backoff=0.0),
        elastic=dict(min_workers=1, failure_threshold=2)),
    "preemption_never_attributed": lambda: dict(
        n=4, script=[lambda r, w: [r.pre(i) for i in range(w)]] * 3
        + [lambda r, w: r.gang_ok(w)],
        elastic=dict(min_workers=2, failure_threshold=1)),
    "elastic_with_buddy_store": lambda: dict(
        n=4, buddy=True, script=[lambda r, w: r.gang_fail(w, 3)] * 2
        + [lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=3, backoff=0.0),
        elastic=dict(min_workers=2, divisor_of=32)),
    # tests/test_elastic.py's host-list cases.
    "hosts_shrink_excludes_lost": lambda: dict(
        hosts=["a", "b", "c", "d"],
        script=[lambda r, w: r.gang_fail(w, 1)] * 2
        + [lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=2, backoff=0.0),
        elastic=dict(min_workers=2, failure_threshold=2, divisor_of=64)),
    "hosts_probe_grow_ceiling": lambda: dict(
        hosts=["a", "b", "c", "d"],
        script=[lambda r, w: r.gang_fail(w, 0), lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=2, backoff=0.0),
        elastic=dict(min_workers=2, probe=[2, 4])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_elastic_supervisor_matches_jax(tmp_path, name):
    jax_rec, port_rec = run_both(SCENARIOS[name], tmp_path)
    assert port_rec == jax_rec


def test_elastic_scenarios_say_what_they_test(tmp_path):
    from torch_resilience_parity import run_one

    rec = run_one("port", SCENARIOS["attribution_shrink"](), tmp_path / "a")
    assert rec["seen"] == [4, 4, 2]
    assert [e["DTPU_ELASTIC_WORLD"] for e in rec["env"]] == ["4", "4", "2"]
    resize = next(e for e in rec["events"] if e["event"] == "gang_resize")
    assert (resize["from_world"], resize["to_world"], resize["trigger"],
            resize["lost_ranks"]) == (4, 2, "attribution", [1])
    rec = run_one("port", SCENARIOS["hosts_shrink_excludes_lost"](),
                  tmp_path / "b")
    assert rec["seen"][-1] == ["a", "c"]
    assert rec["hosts_after"] == ["a", "b", "c", "d"]
    rec = run_one("port", SCENARIOS["elastic_with_buddy_store"](),
                  tmp_path / "c")
    assert rec["seen"] == [4, 4, 2] and rec["segments_left"] == [
        "rank-0", "rank-1", "rank-2"]


ELASTIC_WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.resilience import FaultInjector

GLOBAL = 8
spec = dtt.cluster.initialize(device="cpu", timeout=60)
n = torch.distributed.get_world_size()
x = np.random.default_rng(0).integers(0, 32, (64, 8)).astype(np.int32)
with dtt.FSDP(device="cpu").scope():
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=1, d_model=16,
                                            num_heads=2, max_len=8))
    m.compile(optimizer=dtt.optim.Adam(1e-3),
              loss="sparse_categorical_crossentropy")
resumed = []


class Resumed(dtt.callbacks.Callback):
    def on_train_begin(self, model):
        resumed.append(model._resumed_step)


cbs = [dtt.callbacks.ModelCheckpoint(sys.argv[1], sharded=True, save_freq=2,
                                     restore=True), Resumed(),
       *filter(None, [FaultInjector.from_env()])]
hist = m.fit(x, x, batch_size=GLOBAL, epochs=2, steps_per_epoch=3,
             shuffle=True, seed=0, verbose=0, callbacks=cbs)
dtt.launch.report_result({"world": n, "step": m.step,
                          "resumed_step": resumed[0],
                          "loss": hist.history["loss"][-1]})
dtt.cluster.shutdown()
'''


def test_cli_elastic_gang_shrinks_4_to_2(tmp_path, monkeypatch):
    script = tmp_path / "worker.py"
    script.write_text(ELASTIC_WORKER)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("DTPU_FAULT", "kill:at_step=3,rank=3")
    monkeypatch.delenv("DTPU_FAULT_MARKER", raising=False)
    log = tmp_path / "ev.jsonl"
    rows = tmp_path / "rows.json"
    rc = launch_cli.main([
        "--num-workers", "4", "--supervise", "--max-restarts", "1",
        "--elastic-min-workers", "2", "--elastic-divisor", "8",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--event-log", str(log),
        "--timeout", "120", "--results-json", str(rows),
        str(script), str(tmp_path / "ckpt")])
    assert rc == 0
    got = json.loads(rows.read_text())
    assert [r["value"]["world"] for r in got] == [2, 2]
    # Both ranks of world 2 resumed from step 2, the last save before the
    # kills at step 3.
    assert [r["value"]["resumed_step"] for r in got] == [2, 2]
    from distributed_tpu_torch.utils.events import read_events

    events = read_events(log)
    resize = next(e for e in events if e["event"] == "gang_resize")
    assert (resize["from_world"], resize["to_world"], resize["lost_ranks"]) \
        == (4, 2, [3])
    assert [e["world_size"] for e in events
            if e["event"] == "attempt_start"] == [4, 4, 2]
    monkeypatch.delenv("DTPU_FAULT")
    rc = launch_cli.main([
        "--num-workers", "4", "--timeout", "120", "--results-json",
        str(rows), str(script), str(tmp_path / "ref")])
    assert rc == 0
    want = json.loads(rows.read_text())
    assert got[0]["value"]["step"] == want[0]["value"]["step"] == 6
    np.testing.assert_allclose(got[0]["value"]["loss"],
                               want[0]["value"]["loss"], rtol=1e-5, atol=0)
