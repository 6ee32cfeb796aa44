"""The rest of the port's ``obs/`` against the JAX package's.

- ``obs.flight``: the ring, its dump file (each package reads the
  other's), the dump location from ``DTPU_FLIGHT_DIR`` or the event log's
  directory, the ``flight_dump`` event, and the registry switch.
- ``obs.aggregate``, ``obs.export`` and ``obs.cli`` (``summarize``,
  ``render``, ``event_line``, ``follow``, ``main --json``) on the same
  event lists and registries: the same outputs.
- The fit loop: one flight record a dispatch with the JAX record's keys,
  ``metrics_snapshot`` events with the JAX fit's fields, a dump when the
  step loop dies, and ``report["redundancy"]`` only with the buddy tier.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.obs import aggregate as jagg
from distributed_tpu.obs import cli as jcli
from distributed_tpu.obs import export as jexport
from distributed_tpu.obs import flight as jflight
from distributed_tpu.obs import registry as jreg
from distributed_tpu_torch.obs import aggregate as pagg
from distributed_tpu_torch.obs import cli as pcli
from distributed_tpu_torch.obs import export as pexport
from distributed_tpu_torch.obs import flight as pflight
from distributed_tpu_torch.obs import registry as preg
from torch_parity import no_cluster_env  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("DTPU_FLIGHT_DIR", "DTPU_EVENT_LOG", "DTPU_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ------------------------------------------------------------------ flight --
def _fill(mod, n=5, capacity=3):
    rec = mod.FlightRecorder(capacity=capacity)
    for i in range(n):
        rec.record("step", step=i, seconds=0.5 * i)
    return rec


def test_ring_keeps_the_newest_records():
    for mod in (pflight, jflight):
        rec = _fill(mod)
        assert len(rec) == 3
        assert [r["step"] for r in rec.snapshot()] == [2, 3, 4]
        rec.clear()
        assert rec.snapshot() == []
    assert pflight.DEFAULT_CAPACITY == jflight.DEFAULT_CAPACITY


def test_registry_switch_gates_records():
    for mod, reg in ((pflight, preg), (jflight, jreg)):
        prev = reg.set_enabled(False)
        try:
            rec = mod.FlightRecorder()
            rec.record("step", step=1)
            assert len(rec) == 0
        finally:
            reg.set_enabled(prev)


@pytest.mark.parametrize("writer,reader", [(pflight, jflight),
                                           (jflight, pflight)],
                         ids=["port_to_jax", "jax_to_port"])
def test_dumps_cross_read(tmp_path, clean_env, writer, reader):
    clean_env.setenv("DTPU_EVENT_LOG", str(tmp_path / "ev.jsonl"))
    clean_env.setenv("DTPU_ATTEMPT", "2")
    path = _fill(writer).dump(tmp_path / "f.jsonl", reason="fault:kill",
                              extra={"step": 4})
    records = reader.read_dump(path)
    header = records[0]
    assert {k: header[k] for k in ("kind", "reason", "rank", "world",
                                   "records", "capacity", "step")} == {
        "kind": "flight_header", "reason": "fault:kill", "rank": 0,
        "world": 1, "records": 3, "capacity": 3, "step": 4}
    assert [r["step"] for r in records[1:]] == [2, 3, 4]
    # A torn final line is skipped, not fatal.
    with open(path, "a") as f:
        f.write('{"kind": "step", "st')
    assert len(reader.read_dump(path)) == 4
    (event,) = [e for e in dtt.resilience.read_events(tmp_path / "ev.jsonl")]
    assert {k: event[k] for k in ("event", "path", "reason", "rank",
                                  "records", "attempt")} == {
        "event": "flight_dump", "path": str(path), "reason": "fault:kill",
        "rank": 0, "records": 3, "attempt": 2}


def test_dump_location_matches_jax(tmp_path, clean_env):
    assert pflight.default_dump_path() is None is jflight.default_dump_path()
    assert pflight.dump(reason="x") is None is jflight.dump(reason="x")
    clean_env.setenv("DTPU_EVENT_LOG", str(tmp_path / "logs" / "ev.jsonl"))
    assert pflight.default_dump_path() == jflight.default_dump_path() == (
        tmp_path / "logs" / f"flight-rank0-pid{os.getpid()}.jsonl")
    clean_env.setenv("DTPU_FLIGHT_DIR", str(tmp_path / "fl"))
    assert pflight.default_dump_path() == jflight.default_dump_path()
    path = pflight.dump(reason="preempted", step=9)
    assert path.parent == tmp_path / "fl"
    assert jflight.read_dump(path)[0]["step"] == 9


def test_dump_never_raises(tmp_path, clean_env):
    (tmp_path / "file").write_text("")
    clean_env.setenv("DTPU_FLIGHT_DIR", str(tmp_path / "file" / "sub"))
    assert pflight.dump(reason="x") is None


# --------------------------------------------------------------- aggregate --
def _snap(rank, seconds, own=None, **kw):
    rec = {"event": "metrics_snapshot", "ts": 1.0, "pid": 1, "rank": rank,
           "step_seconds": seconds, **kw}
    if own is not None:
        rec["self_seconds"] = own
    return rec


STREAMS = {
    "empty": [],
    "one_rank": [_snap(0, [0.1, 0.2])],
    "straggler": [_snap(0, [0.1] * 4, [0.05] * 4),
                  _snap(1, [0.1] * 4, [0.2] * 4),
                  _snap(2, [0.1] * 4, [0.06] * 4)],
    "even": [_snap(r, [0.1, 0.11]) for r in range(4)],
    "no_rank_and_others": [
        {"event": "metrics_snapshot", "ts": 1.0, "step_seconds": [1.0]},
        {"event": "attempt_start", "ts": 0.5, "attempt": 1,
         "world_size": 2},
        _snap(0, [0.2, 0.4, 0.3]), _snap(1, []), _snap(1, [0.9, 0.5])],
    "zero_median": [_snap(0, [0.0]), _snap(1, [0.0])],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("threshold", [1.5, 3.0])
def test_aggregate_matches_jax(name, threshold):
    ev = STREAMS[name]
    for fn in ("snapshots", "rank_step_seconds", "skew_report"):
        assert getattr(pagg, fn)(ev) == getattr(jagg, fn)(ev), fn
    assert pagg.straggler(ev, threshold) == jagg.straggler(ev, threshold)
    assert pagg.DEFAULT_THRESHOLD == jagg.DEFAULT_THRESHOLD


# ------------------------------------------------------------------ export --
def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("fit/steps", 12)
    reg.counter("supervisor/restarts", 1)
    reg.gauge("fit/steps.per-sec", 3.5)
    for v in (0.002, 0.04, 0.3, 70.0):
        reg.observe("serve/ttft_s", v)
    return reg


def test_prometheus_text_matches_jax(tmp_path):
    got = pexport.prometheus_text(registry=_registry(preg))
    assert got == jexport.prometheus_text(registry=_registry(jreg))
    assert 'dtpu_serve_ttft_s_bucket{le="+Inf"} 4' in got
    assert pexport.prometheus_text({}) == jexport.prometheus_text({}) == ""
    snap = _registry(preg).snapshot()
    assert pexport.prometheus_text(snap) == jexport.prometheus_text(snap)
    p = pexport.write_prometheus(tmp_path / "m" / "x.prom",
                                 registry=_registry(preg))
    assert p.read_text() == got and not (tmp_path / "m" / "x.prom.tmp"
                                         ).exists()


def test_append_snapshot_matches_jax(tmp_path):
    for mod, reg in (("port", pexport.append_snapshot),
                     ("jax", jexport.append_snapshot)):
        registry = _registry(preg if mod == "port" else jreg)
        for step in (1, 2):
            reg(tmp_path / f"{mod}.jsonl", registry=registry, step=step)
    rows = {m: [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in (tmp_path / f"{m}.jsonl").read_text()
                .splitlines()] for m in ("port", "jax")}
    assert rows["port"] == rows["jax"] and rows["port"][1]["step"] == 2


# --------------------------------------------------------------------- cli --
def _run_events(tmp_path):
    """A supervised run's event log and one flight dump it references."""
    dump = tmp_path / "flight-rank1-pid7.jsonl"
    rec = pflight.FlightRecorder()
    for i in range(1, 13):
        rec.record("step", step=i, seconds=0.1, self_s=0.05)
    rec.dump(dump, reason="fault:kill", extra={"step": 12})
    events = [
        {"event": "attempt_start", "ts": 10.0, "pid": 1, "attempt": 1,
         "world_size": 2},
        _snap(0, [0.1] * 5), _snap(1, [0.3] * 5),
        {"event": "fault_injected", "ts": 11.0, "pid": 2, "mode": "kill",
         "step": 12},
        {"event": "flight_dump", "ts": 11.1, "pid": 2, "path": str(dump),
         "reason": "fault:kill", "rank": 1, "records": 12, "attempt": 1},
        {"event": "attempt_end", "ts": 12.0, "pid": 1, "attempt": 1,
         "ok": False, "world_size": 2, "failed_ranks": [0, 1]},
        {"event": "gang_resize", "ts": 12.1, "pid": 1, "from_world": 2,
         "to_world": 1, "reason": "shrink", "trigger": "attribution"},
        {"event": "attempt_start", "ts": 12.5, "pid": 1, "attempt": 2,
         "world_size": 1},
        {"event": "pipeline_schedule_selected", "ts": 13.0, "pid": 3,
         "schedule": "gpipe", "interleave": 1, "num_stages": 2,
         "num_microbatches": 4},
        {"event": "bubble_report", "ts": 13.0, "pid": 3,
         "bubble_fraction": 0.2, "ticks": 5},
        {"event": "spec_verify", "ts": 13.0, "pid": 3, "rounds": 4,
         "proposed": 16, "accepted": 9, "accept_rate": 0.5625},
        {"event": "draft_sync", "ts": 13.0, "pid": 3, "weights_version": 2},
        {"event": "spec_k_adjust", "ts": 13.0, "pid": 3, "tenant": "a",
         "old_k": 4, "new_k": 2},
        {"event": "prefix_gossip_advertise", "ts": 13.0, "pid": 3,
         "replica": "d0", "blocks": 3},
        {"event": "prefix_gossip_adopt", "ts": 13.0, "pid": 3,
         "replica": "d1", "source": "d0", "blocks": 3},
        {"event": "attempt_end", "ts": 15.0, "pid": 1, "attempt": 2,
         "ok": True, "world_size": 1},
        {"event": "recovery", "ts": 15.1, "pid": 1, "failed_attempt": 1,
         "recovered_attempt": 2, "detect_s": 1.0, "gang_reform_s": 2.0,
         "restore_s": 0.5, "recompile_s": 1.5, "restore_tier": "buddy",
         "flight_dumps": [str(dump)]},
        {"event": "straggler", "ts": 15.2, "pid": 1, "rank": 1, "skew": 1.5,
         "median_step_s": 0.3, "gang_median_step_s": 0.2, "threshold": 1.5,
         "world": 2},
        {"event": "run_complete", "ts": 15.3, "pid": 1, "attempts": 2},
    ]
    log = tmp_path / "ev.jsonl"
    log.write_text("".join(json.dumps(e) + "\n" for e in events))
    extra = tmp_path / "extra.jsonl"
    _fill(pflight).dump(extra, reason="by hand")
    return log, events, extra


@pytest.mark.parametrize("threshold", [1.5, 9.0])
def test_summarize_and_render_match_jax(tmp_path, clean_env, threshold):
    log, events, extra = _run_events(tmp_path)
    kw = dict(flight_paths=[extra, tmp_path / "missing.jsonl"],
              straggler_threshold=threshold)
    got = pcli.summarize(events, **kw)
    assert got == jcli.summarize(events, **kw)
    assert pcli.render(got, tail=4) == jcli.render(got, tail=4)
    assert got["recoveries"][0]["restore_tier"] == "buddy"
    assert [d["readable"] for d in got["flight_dumps"]] == [True, True, False]
    for e in events:
        assert pcli.event_line(e) == jcli.event_line(e)


def test_main_json_and_text_match_jax(tmp_path, clean_env, capsys):
    log, _, extra = _run_events(tmp_path)
    out = {}
    for name, mod in (("port", pcli), ("jax", jcli)):
        assert mod.main([str(log), "--json", "--flight", str(extra)]) == 0
        out[name] = json.loads(capsys.readouterr().out)
        assert mod.main([str(log), "--tail", "2"]) == 0
        out[name + "_text"] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert out["port_text"] == out["jax_text"]
    assert "recovery (attempt 1 -> 2)" in out["port_text"]
    assert pcli.main([str(tmp_path / "nope.jsonl")]) == 2


def test_follow_survives_rotation_and_torn_tail(tmp_path):
    path = tmp_path / "live.jsonl"
    seen, done = [], threading.Event()
    stop_after = 3

    def reader():
        for e in pcli.follow(path, poll_s=0.01,
                             stop=lambda: len(seen) >= stop_after):
            seen.append(e["n"])
        done.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    path.write_text('{"event": "a", "n": 1}\n{"event": "a", "n"')
    import time

    time.sleep(0.1)
    with open(path, "a") as f:
        f.write(': 2}\n')
    time.sleep(0.1)
    os.replace(tmp_path / "live.jsonl", tmp_path / "old.jsonl")
    path.write_text('{"event": "a", "n": 3}\n')
    assert done.wait(10)
    assert seen == [1, 2, 3]


# ---------------------------------------------------------------- fit loop --
def _fit(pkg, tmp_path, callbacks=(), steps=4):
    x = np.random.default_rng(0).integers(0, 32, (32, 8)).astype(np.int32)
    kw = {"device": "cpu"} if pkg is dtt else {}
    m = pkg.Model(pkg.models.transformer_lm(32, num_layers=1, d_model=16,
                                            num_heads=2, max_len=8), **kw)
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    m.fit(x, x, batch_size=4, epochs=1, steps_per_epoch=steps, verbose=0,
          callbacks=list(callbacks))
    return m


def test_fit_records_and_snapshots_match_jax(tmp_path, clean_env):
    clean_env.setenv("DTPU_OBS_FLUSH_EVERY", "3")
    out = {}
    for name, pkg, fl in (("port", dtt, pflight), ("jax", dtpu, jflight)):
        log = tmp_path / f"{name}.jsonl"
        clean_env.setenv("DTPU_EVENT_LOG", str(log))
        fl.default_recorder().clear()
        m = _fit(pkg, tmp_path, steps=4)
        records = fl.default_recorder().snapshot()
        snaps = [e for e in dtt.resilience.read_events(log)
                 if e["event"] == "metrics_snapshot"]
        out[name] = (
            [(r["kind"], r.get("step", r.get("epoch")), sorted(r))
             for r in records],
            [(s["rank"], s["world"], s["step"], len(s["step_seconds"]),
              len(s["self_seconds"]), sorted(s)) for s in snaps],
            "redundancy" in m.last_fit_telemetry)
    assert out["port"] == out["jax"]
    assert [r[:2] for r in out["port"][0]] == [
        ("step", 1), ("step", 2), ("step", 3), ("step", 4), ("epoch_end", 0)]
    assert [s[2] for s in out["port"][1]] == [3, 4]
    assert out["port"][2] is False


def test_fit_dumps_the_flight_ring_when_the_step_loop_dies(tmp_path,
                                                           clean_env):
    clean_env.setenv("DTPU_FLIGHT_DIR", str(tmp_path))

    class Boom(dtt.callbacks.Callback):
        def on_batch_end(self, model, step, logs):
            if step == 3:
                raise ValueError("boom")

    pflight.default_recorder().clear()
    with pytest.raises(ValueError, match="boom"):
        _fit(dtt, tmp_path, callbacks=[Boom()])
    (dump,) = tmp_path.glob("flight-rank0-pid*.jsonl")
    records = jflight.read_dump(dump)
    assert records[0]["reason"] == "exception:ValueError"
    assert [r["step"] for r in records[1:]] == [1, 2]

    class Leave(dtt.callbacks.Callback):
        def on_batch_end(self, model, step, logs):
            raise SystemExit(3)

    dump.unlink()
    with pytest.raises(SystemExit):
        _fit(dtt, tmp_path, callbacks=[Leave()])
    assert not list(tmp_path.glob("flight-*.jsonl"))
