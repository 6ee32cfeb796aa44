"""The port's ``resilience/`` against the JAX package's.

- ``RestartPolicy``, ``FaultInjector`` (``from_env`` parsing, arming by
  rank and once-marker, the replica trigger) and
  ``corrupt_latest_checkpoint`` over grids of arguments, errors included.
- Both ``Supervisor``\\ s driven by the same scripted launcher
  (``tests/torch_resilience_parity.py``; the cases of the JAX package's
  ``tests/test_resilience.py`` supervisor rows): the same
  ``SupervisedResult``, backoff sleeps, worker environment and event
  stream (kinds and fields, less clock readings).
- ``recovery_rows`` on the same event lists; resume markers written by
  either package read by the other.
- ``PreemptionHandler`` in-process, and on a real 2-rank gloo gang under
  the port's Supervisor: rank 0 is signalled a step before rank 1, both
  stop at the same step (the vote), exit 75, the restart spends no
  budget, the marker is cleared, and the run ends bit-identical to an
  uninterrupted one.
"""

import os
import signal
import sys

import numpy as np
import pytest
import torch

import distributed_tpu_torch as dtt
from distributed_tpu import resilience as jres
from distributed_tpu.resilience import faults as jfaults
from distributed_tpu_torch import resilience as pres
from distributed_tpu_torch.resilience import faults as pfaults
from torch_parity import ROOT
from torch_resilience_parity import run_both

torch.set_num_threads(1)

ENV = {"PYTHONPATH": str(ROOT)}


def _outcome(fn):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("raise", type(e).__name__, str(e))


# ------------------------------------------------------------------ policy --
POLICIES = [
    {}, {"max_restarts": 0}, {"max_restarts": 2, "backoff": 0.5},
    {"backoff": 1.0, "backoff_factor": 2.0, "backoff_max": 5.0},
    {"backoff": 0.0, "backoff_max": 0.0}, {"max_preemptions": 1},
    {"preemption_exempt": False, "max_preemptions": 0},
    {"max_restarts": -1}, {"backoff": -1.0}, {"backoff_factor": 0.5},
    {"backoff": 2.0, "backoff_max": 1.0}, {"max_preemptions": -1},
]


@pytest.mark.parametrize("kw", POLICIES, ids=[str(i) for i in
                                              range(len(POLICIES))])
def test_restart_policy_matches_jax(kw):
    def probe(mod):
        p = mod.RestartPolicy(**kw)
        return ([_outcome(lambda i=i: p.delay(i)) for i in range(0, 7)],
                [p.allows_restart(i) for i in range(5)],
                [p.allows_preemption_restart(i) for i in range(18)],
                p.preemption_exempt)

    assert _outcome(lambda: probe(pres)) == _outcome(lambda: probe(jres))


# ------------------------------------------------------------------ faults --
SPECS = [
    "kill", "kill:at_step=3", "kill:at_step=3,rank=1,exit_code=9",
    "hang:rank=all,hang_seconds=2.5", "slow_heartbeat:hang_seconds=1",
    "slow_steps:slow_seconds=0.5,rank=2",
    "corrupt_checkpoint:directory=/tmp/ck,at_step=4",
    "replica_kill:replica=decode-1,at_step=2", "buddy_kill:rank=1,at_step=5",
    "kill_during_refresh:rank=0,at_step=8", " kill : at_step=3",
    "corrupt_checkpoint", "replica_kill", "buddy_kill:rank=all",
    "kill_during_refresh:rank=all", "explode", "kill:color=red",
    "kill:at_step=x", "kill:rank=one",
]


def _fault_fields(inj):
    return (inj.mode, inj.at_step, inj.rank, str(inj.once_marker),
            inj.exit_code, inj.hang_seconds, inj.slow_seconds,
            inj.directory, inj.replica, inj.fired)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("marker", [None, "m/once"])
def test_fault_from_env_matches_jax(monkeypatch, spec, marker):
    monkeypatch.setenv("DTPU_FAULT", spec)
    if marker:
        monkeypatch.setenv("DTPU_FAULT_MARKER", marker)
    else:
        monkeypatch.delenv("DTPU_FAULT_MARKER", raising=False)

    def build(mod):
        inj = mod.FaultInjector.from_env()
        return None if inj is None else _fault_fields(inj)

    assert _outcome(lambda: build(pfaults)) == _outcome(lambda: build(jfaults))


def test_fault_from_env_unset_is_none(monkeypatch):
    monkeypatch.delenv("DTPU_FAULT", raising=False)
    assert pfaults.FaultInjector.from_env() is None
    assert jfaults.FaultInjector.from_env() is None


ARMING = [(mode, rank, me, world)
          for mode in ("kill", "buddy_kill", "slow_steps")
          for rank in (None, 0, 1, 3) for me in range(4) for world in (2, 4)
          if me < world and not (mode == "buddy_kill" and rank is None)]


def _fake_rank(monkeypatch, me, world):
    import jax

    monkeypatch.setattr(jax, "process_index", lambda: me)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(pfaults, "rank_world", lambda: (me, world))


def test_fault_arming_matches_jax(monkeypatch, tmp_path):
    """Which rank a fault arms on (buddy_kill: the target and its ring
    holder) and the once-marker each rank checks, for every case."""
    got = {}
    for pkg, mod in (("port", pfaults), ("jax", jfaults)):
        rows = []
        for mode, rank, me, world in ARMING:
            _fake_rank(monkeypatch, me, world)
            inj = mod.FaultInjector(mode, rank=rank,
                                    once_marker=tmp_path / "once")
            path = inj._marker_path()
            rows.append((mode, rank, me, world, inj._armed(),
                         None if path is None else path.name))
        got[pkg] = rows
    assert got["port"] == got["jax"]
    assert any(r[4] for r in got["port"]) and not all(r[4] for r in
                                                      got["port"])


def test_replica_trigger_matches_jax(tmp_path):
    def probe(mod, marker):
        inj = mod.FaultInjector("replica_kill", replica="decode-1",
                                at_step=3, once_marker=marker)
        return [inj.should_kill_replica(name, step)
                for name, step in (("decode-0", 5), ("decode-1", 2),
                                   ("decode-1", 3), ("decode-1", 4))]

    assert probe(pfaults, tmp_path / "p") == probe(jfaults, tmp_path / "j") \
        == [False, False, True, False]
    # A marker left by an earlier run keeps the fault disarmed.
    assert probe(pfaults, tmp_path / "p") == [False] * 4


@pytest.mark.parametrize("layout", ["npz", "sharded", "uncommitted",
                                    "empty"])
def test_corrupt_latest_checkpoint_matches_jax(tmp_path, layout):
    def make(root):
        root.mkdir(parents=True)
        if layout == "npz":
            for s in (3, 6):
                (root / f"ckpt-{s}.npz").write_bytes(b"zip" * 10)
        elif layout in ("sharded", "uncommitted"):
            for s in (3, 6):
                d = root / f"ckpt-{s}"
                d.mkdir()
                for r in (0, 1):
                    (d / f"proc-{r}.npz").write_bytes(b"zip" * 10)
                if layout == "sharded" or s == 3:
                    (d / "manifest.json").write_text("{}")
        return root

    out = {}
    for pkg, mod in (("port", pfaults), ("jax", jfaults)):
        root = make(tmp_path / pkg)
        hit = mod.corrupt_latest_checkpoint(root)
        out[pkg] = (None if hit is None else str(hit.relative_to(root)),
                    sorted((str(p.relative_to(root)), p.read_bytes())
                           for p in root.rglob("*") if p.is_file()))
    assert out["port"] == out["jax"]


# -------------------------------------------------------------- supervisor --
SCENARIOS = {
    # tests/test_resilience.py's supervisor rows.
    "backoff_until_success": lambda: dict(
        script=[lambda r, w: [r.legacy_fail()]] * 2 + [lambda r, w:
                                                       [r.ok()]],
        policy=dict(max_restarts=3, backoff=0.5, backoff_factor=2.0,
                    backoff_max=10.0)),
    "budget_exhausted": lambda: dict(
        script=[lambda r, w: [r.legacy_fail()]] * 3,
        policy=dict(max_restarts=1, backoff=0.0)),
    "preemption_is_budget_free": lambda: dict(
        script=[lambda r, w: [r.pre()]] * 2 + [lambda r, w: [r.ok()]],
        policy=dict(max_restarts=0)),
    "preemption_with_gang_killed_peer": lambda: dict(
        n=2, script=[lambda r, w: [r.pre(0), r.collateral(
            1, disposition=None)], lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=0)),
    "preemption_with_error_none_peer": lambda: dict(
        n=2, script=[lambda r, w: [r.pre(0), r.collateral(
            1, error=None, disposition=None)], lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=0)),
    "independent_fault_beside_preemption": lambda: dict(
        n=2, script=[lambda r, w: [r.pre(0), r.fail(1)],
                     lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=1, backoff=0.0)),
    "preemption_cap": lambda: dict(
        script=[lambda r, w: [r.pre()]] * 3,
        policy=dict(max_restarts=0, max_preemptions=2)),
    "launch_raises": lambda: dict(
        script=["raise", lambda r, w: [r.ok()]],
        policy=dict(max_restarts=1, backoff=0.0)),
    "liveness_and_timeout_rows": lambda: dict(
        n=3, script=[lambda r, w: [r.collateral(0, error="timeout",
                                                disposition="timeout")] * 1
                     + [r.collateral(1, error="liveness",
                                     disposition="liveness_killed"),
                        r.collateral(2)], lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=2, backoff=0.25)),
    # The buddy store: the initiator's segment goes, its peers' stay.
    "buddy_segments_invalidated": lambda: dict(
        n=3, buddy=True, script=[lambda r, w: r.gang_fail(w, 1),
                                 lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=1, backoff=0.0)),
    "buddy_kept_on_preemption": lambda: dict(
        n=2, buddy=True, script=[lambda r, w: [r.pre(0), r.pre(1)],
                                 lambda r, w: r.gang_ok(w)]),
    # The resume state: the marker's step in the restart event, the marker
    # cleared when the run completes.
    "resume_marker": lambda: dict(
        marker=7, script=[lambda r, w: [r.pre()], lambda r, w: [r.ok()]]),
    "resume_marker_kept_on_failure": lambda: dict(
        marker=4, script=[lambda r, w: [r.fail()]] * 2,
        policy=dict(max_restarts=1, backoff=0.0)),
    # The workers' snapshots: rank_skew and the straggler at run end, and
    # recovery rows from the workers' restore events.
    "straggler_and_recovery": lambda: dict(
        n=2, script=[lambda r, w: r.gang_fail(w, 0),
                     lambda r, w: r.gang_ok(w)],
        policy=dict(max_restarts=1, backoff=0.0),
        worker_events=[
            {"event": "metrics_snapshot", "rank": 0, "world": 2, "step": 5,
             "step_seconds": [0.1] * 5, "self_seconds": [0.1] * 5},
            {"event": "metrics_snapshot", "rank": 1, "world": 2, "step": 5,
             "step_seconds": [0.3] * 5, "self_seconds": [0.35] * 5},
            {"event": "restore_begin", "tier": "buddy", "rank": 0},
            {"event": "restore_end", "tier": "buddy", "step": 4, "rank": 0,
             "seconds": 0.5, "disk_block_reads": 0},
            {"event": "post_restore_step", "step": 5, "rank": 0},
            {"event": "flight_dump", "path": "/x/flight-rank0.jsonl",
             "reason": "fault:kill", "rank": 0, "records": 3,
             "attempt": 1}]),
    "no_straggler_below_threshold": lambda: dict(
        n=2, straggler_threshold=3.0, script=[lambda r, w: r.gang_ok(w)],
        worker_events=[
            {"event": "metrics_snapshot", "rank": r, "step_seconds": [s]}
            for r, s in ((0, 0.1), (1, 0.2))]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_matches_jax(tmp_path, name):
    jax_rec, port_rec = run_both(SCENARIOS[name], tmp_path)
    assert port_rec == jax_rec
    assert port_rec["events"][-1]["event"] in (
        "run_complete", "budget_exhausted", "preemption_cap_exhausted")


def test_supervisor_scenarios_say_what_they_test(tmp_path):
    """A few of the facts the scenarios pin, read from the port's record."""
    from torch_resilience_parity import run_one

    rec = run_one("port", SCENARIOS["backoff_until_success"](), tmp_path / "a")
    assert rec["sleeps"] == [0.5, 1.0] and rec["result"][:3] == (True, 3, 2)
    assert [e["DTPU_ATTEMPT"] for e in rec["env"]] == ["1", "2", "3"]
    assert all(e["DTPU_EVENT_LOG"] == "<log>" for e in rec["env"])
    rec = run_one("port", SCENARIOS["buddy_segments_invalidated"](),
                  tmp_path / "b")
    assert rec["segments_left"] == ["rank-0", "rank-2"]
    inv = [e for e in rec["events"]
           if e["event"] == "buddy_segments_invalidated"]
    assert inv == [{"event": "buddy_segments_invalidated", "ranks": [1]}]
    rec = run_one("port", SCENARIOS["resume_marker"](), tmp_path / "c")
    restart = next(e for e in rec["events"] if e["event"] == "restart")
    assert restart["marker_step"] == 7 and not rec["marker_left"]
    rec = run_one("port", SCENARIOS["straggler_and_recovery"](),
                  tmp_path / "d")
    kinds = [e["event"] for e in rec["events"]]
    assert {"rank_skew", "straggler", "recovery"} <= set(kinds)
    row = next(e for e in rec["events"] if e["event"] == "recovery")
    assert row["restore_tier"] == "buddy" and row["disk_block_reads"] == 0
    assert row["flight_dumps"] == ["/x/flight-rank0.jsonl"]


def test_supervise_one_call_matches_jax(tmp_path):
    script = tmp_path / "ok.py"
    script.write_text("print('hi')\n")
    got = pres.supervise([sys.executable, str(script)], 2, timeout=60,
                         grace=1)
    want = jres.supervise([sys.executable, str(script)], 2, timeout=60,
                          grace=1)
    assert (got.ok, got.attempts, got.world_size, len(got.results)) == (
        want.ok, want.attempts, want.world_size, len(want.results)) == (
        True, 1, 2, 2)
    assert got.failed == [] and not got.event_log


# ------------------------------------------------------------ recovery rows --
def _timeline():
    t = 100.0
    return [
        {"event": "attempt_start", "ts": t, "attempt": 1},
        {"event": "fault_injected", "ts": t + 1.0, "mode": "kill"},
        {"event": "flight_dump", "ts": t + 1.1, "path": "/d/a.jsonl",
         "attempt": 1},
        {"event": "flight_dump", "ts": t + 1.2, "path": "/d/b.jsonl"},
        {"event": "attempt_end", "ts": t + 3.0, "attempt": 1, "ok": False},
        {"event": "attempt_start", "ts": t + 3.1, "attempt": 2},
        {"event": "restore_begin", "ts": t + 5.0, "rank": 1},
        {"event": "restore_begin", "ts": t + 5.5, "rank": 0},
        {"event": "restore_end", "ts": t + 6.0, "rank": 0,
         "tier": "buddy", "step": 4, "disk_block_reads": 0},
        {"event": "post_restore_step", "ts": t + 7.5, "rank": 0},
        {"event": "attempt_end", "ts": t + 9.0, "attempt": 2, "ok": False},
        {"event": "attempt_start", "ts": t + 9.5, "attempt": 3},
        {"event": "first_step", "ts": t + 12.0},
        {"event": "attempt_end", "ts": t + 13.0, "attempt": 3, "ok": True},
    ]


@pytest.mark.parametrize("cut", ["all", "lifecycle_only", "no_relaunch",
                                 "no_fault"])
def test_recovery_rows_match_jax(cut):
    events = _timeline()
    if cut == "lifecycle_only":
        events = [e for e in events
                  if e["event"] in ("attempt_start", "attempt_end")]
    elif cut == "no_relaunch":
        events = events[:5]
    elif cut == "no_fault":
        events = [e for e in events if e["event"] != "fault_injected"]
    got = pres.recovery_rows(events)
    assert got == jres.recovery_rows(events)
    if cut == "all":
        assert got[0]["detect_s"] == 2.0 and got[0]["restore_s"] == 0.5
        assert got[0]["flight_dumps"] == ["/d/a.jsonl", "/d/b.jsonl"]
        assert got[1]["total_to_first_step_s"] == 3.0


# ----------------------------------------------------------------- markers --
@pytest.mark.parametrize("writer,reader", [(pres, jres), (jres, pres)],
                         ids=["port_to_jax", "jax_to_port"])
def test_resume_markers_cross_read(tmp_path, writer, reader):
    writer.write_resume_marker(tmp_path, 12, reason="preempted")
    rec = reader.read_resume_marker(tmp_path)
    assert rec["step"] == 12 and rec["reason"] == "preempted"
    (tmp_path / "resume-marker.json").write_text("{torn")
    assert reader.read_resume_marker(tmp_path) is None
    reader.clear_resume_marker(tmp_path)
    assert writer.read_resume_marker(tmp_path) is None
    assert pres.PREEMPTED_EXIT_CODE == jres.PREEMPTED_EXIT_CODE == 75


# -------------------------------------------------------------- preemption --
def _lm_model():
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=1, d_model=16,
                                            num_heads=2, max_len=8),
                  device="cpu")
    m.compile(optimizer=dtt.optim.Adam(1e-3),
              loss="sparse_categorical_crossentropy")
    return m


def test_preemption_handler_in_process(tmp_path):
    """exit_code=None: the signal stops fit at the next batch end, with a
    checkpoint of that step and a resume marker JAX's reader reads."""
    x = np.random.default_rng(0).integers(0, 32, (32, 8)).astype(np.int32)
    m = _lm_model()
    handler = pres.PreemptionHandler(tmp_path, exit_code=None)

    class Signal(dtt.callbacks.Callback):
        def on_batch_end(self, model, step, logs):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    m.fit(x, x, batch_size=4, epochs=2, steps_per_epoch=4, verbose=0,
          callbacks=[Signal(), handler])
    assert handler.triggered and m.step == 3
    assert jres.read_resume_marker(tmp_path)["step"] == 3
    assert dtt.Checkpointer(tmp_path).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


PREEMPT_WORKER = r'''
import os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.resilience import PreemptionHandler

ckpt, sig_dir = sys.argv[1], sys.argv[2]
spec = dtt.cluster.initialize(device="cpu", timeout=60)
rank = spec.index
x = np.random.default_rng(0).integers(0, 32, (64, 8)).astype(np.int32)
with dtt.DataParallel(device="cpu").scope():
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=1, d_model=16,
                                            num_heads=2, max_len=8))
    m.compile(optimizer=dtt.optim.Adam(1e-3),
              loss="sparse_categorical_crossentropy")
mc = dtt.callbacks.ModelCheckpoint(ckpt, sharded=True, save_freq=100,
                                   restore=True)
handler = PreemptionHandler(ckpt, checkpointer=mc.ckpt)
mark = os.path.join(sig_dir, f"sig-rank{rank}")


class Signal(dtt.callbacks.Callback):
    """Rank 0 is signalled after step 2, rank 1 after step 3 (first
    attempt only)."""

    def on_batch_end(self, model, step, logs):
        if step == 2 + rank and not os.path.exists(mark):
            open(mark, "w").close()
            os.kill(os.getpid(), signal.SIGTERM)


m.fit(x, x, batch_size=8, epochs=2, steps_per_epoch=4, shuffle=True,
      seed=0, verbose=0, callbacks=[mc, Signal(), handler])
dtt.launch.report_result({
    "step": m.step,
    "params": {k: v.double().sum().item() for k, v in m.params.items()},
    "bits": [float(v.flatten()[0]) for v in m.params.values()]})
dtt.cluster.shutdown()
'''


def test_gang_preemption_exit_75_budget_free_bit_identical(tmp_path):
    """A 2-rank gang whose ranks are signalled a step apart: both stop at
    the same step (no rank enters the collective final save alone), exit
    75, the supervisor relaunches without spending budget, the marker is
    cleared, and the result is the uninterrupted run's, bit for bit."""
    script = tmp_path / "worker.py"
    script.write_text(PREEMPT_WORKER)
    sig_dir = tmp_path / "sig"
    sig_dir.mkdir()
    log = pres.EventLog(tmp_path / "ev.jsonl")
    sup = pres.Supervisor(
        [sys.executable, str(script), str(tmp_path / "ckpt"), str(sig_dir)],
        2, launcher=dtt.launch.LocalLauncher(env_extra=ENV),
        policy=pres.RestartPolicy(max_restarts=0),
        checkpoint_dir=tmp_path / "ckpt", event_log=log)
    out = sup.run(timeout=180, grace=5)
    assert out.ok, [(r.index, r.error, r.log_tail[-800:])
                    for r in out.results]
    assert (out.attempts, out.preemptions, out.restarts_used) == (2, 1, 0)
    events = log.read()
    first_end = next(e for e in events if e["event"] == "attempt_end")
    assert first_end["exit_codes"] == [75, 75]
    preempted = [e for e in events if e["event"] == "preempted"]
    assert [e["step"] for e in preempted] == [3]  # the vote: both at 3
    restart = next(e for e in events if e["event"] == "restart")
    assert restart["reason"] == "preempted" and restart["marker_step"] == 3
    assert pres.read_resume_marker(tmp_path / "ckpt") is None
    assert not any(e["event"] == "corrupt_checkpoint_skipped"
                   for e in events)
    ref = dtt.launch.LocalLauncher(env_extra=ENV).run(
        [sys.executable, str(script), str(tmp_path / "ref"),
         str(sig_dir)], 2, timeout=180)
    assert all(r.ok for r in ref), [(r.index, r.error, r.log_tail[-800:])
                                    for r in ref]
    got = {r.index: r.value for r in out.results}
    want = {r.index: r.value for r in ref}
    assert got == want and got[0]["step"] == 8
