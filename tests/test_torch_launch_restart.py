"""The port's gang launcher beyond a plain local run: the heartbeat and
its liveness probe, ``run_with_restart``, ``SSHLauncher`` (through a
fake-ssh shim that runs the "remote" command locally), the elastic world
override, ``initialize(coordinator=...)``, ``reset_for_relaunch`` and the
CLI's new flags: the behaviours of the JAX package's
``tests/test_launch.py``, ``tests/test_ssh_launcher.py`` and
``tests/test_elastic.py`` (its cluster-init seams), on the port.

The restart test is the port's copy of ``test_launch.py``'s
``test_auto_restart_resumes_from_checkpoint``: ``mnist_cnn`` on 2 gloo
ranks, worker 1 exits at step 5 on the first attempt, the gang resumes
from ``ModelCheckpoint(restore=True)``, and its losses, accuracy and
parameters are bit-identical to an uninterrupted run.
"""

import json
import os
import re
import signal
import stat
import sys
import textwrap
import time

import pytest
import torch

import distributed_tpu_torch as dtt
from distributed_tpu_torch.cluster import config as cluster_config
from distributed_tpu_torch.cluster import init as cluster_init
from distributed_tpu_torch.launch import __main__ as launch_cli
from distributed_tpu_torch.launch import core
from distributed_tpu_torch.launch.core import (
    HEARTBEAT_MARK,
    PID_MARK,
    STDOUT_MARK,
    LocalLauncher,
    SSHLauncher,
    run_with_restart,
)

from torch_parity import ROOT

torch.set_num_threads(1)

ENV = {"PYTHONPATH": str(ROOT)}


def write_worker(tmp_path, body, name="worker.py"):
    script = tmp_path / name
    script.write_text(textwrap.dedent(body))
    return str(script)


# ---------------------------------------------------------------- heartbeat --
def test_heartbeat_is_a_noop_outside_a_gang(monkeypatch, capsys):
    monkeypatch.delenv(core.HEARTBEAT_ENV, raising=False)
    monkeypatch.delenv(core.HEARTBEAT_STDOUT_ENV, raising=False)
    monkeypatch.setattr(core, "_last_heartbeat", 0.0)
    core.heartbeat(min_interval=0.0)
    assert capsys.readouterr().out == ""


def test_heartbeat_file_transport_and_throttle(tmp_path, monkeypatch):
    path = tmp_path / "hb"
    monkeypatch.setenv(core.HEARTBEAT_ENV, str(path))
    monkeypatch.delenv(core.HEARTBEAT_STDOUT_ENV, raising=False)
    monkeypatch.setattr(core, "_last_heartbeat", 0.0)
    core.heartbeat(min_interval=60.0)
    assert path.exists()
    os.utime(path, (1.0, 1.0))
    core.heartbeat(min_interval=60.0)  # throttled: no touch
    assert os.path.getmtime(path) == 1.0
    monkeypatch.setattr(core, "_last_heartbeat", 0.0)
    core.heartbeat(min_interval=60.0)
    assert os.path.getmtime(path) > 1.0


def test_heartbeat_stdout_transport(monkeypatch, capsys):
    monkeypatch.delenv(core.HEARTBEAT_ENV, raising=False)
    monkeypatch.setenv(core.HEARTBEAT_STDOUT_ENV, "1")
    monkeypatch.setattr(core, "_last_heartbeat", 0.0)
    core.heartbeat(min_interval=0.0)
    assert capsys.readouterr().out.strip() == HEARTBEAT_MARK


def test_fit_beats(monkeypatch):
    """Model.fit beats once a dispatch and at the epoch's end."""
    beats = []
    monkeypatch.setattr("distributed_tpu_torch.training.model."
                        "_gang_heartbeat", lambda: beats.append(1))
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    m.compile(optimizer=dtt.optim.SGD(0.01))
    x, y = dtt.data.synthetic_images(64, (28, 28), 10, 0)
    x = x[..., None].astype("float32") / 255.0
    m.fit(x, y.astype("int32"), batch_size=16, epochs=1, steps_per_epoch=3,
          verbose=0)
    assert len(beats) == 3 + 1
    m.evaluate(x, y.astype("int32"), batch_size=32, verbose=0)
    assert len(beats) == 3 + 1 + 2


# ----------------------------------------------------------------- liveness --
def test_liveness_timeout_kills_stopped_worker(tmp_path):
    """A worker that SIGSTOPs itself after beating is killed with a
    'liveness timeout' row after liveness_timeout, and its peer is
    gang-killed after grace, long before the run's timeout."""
    script = write_worker(tmp_path, """
        import signal, time
        from distributed_tpu_torch.cluster.config import from_env
        from distributed_tpu_torch.launch import heartbeat, report_result

        spec = from_env()
        for i in range(400):
            heartbeat(min_interval=0.0)
            time.sleep(0.05)
            if spec.index == 1 and i == 8:
                signal.raise_signal(signal.SIGSTOP)
        report_result({"rank": spec.index})
        """)
    t0 = time.time()
    results = LocalLauncher(env_extra=ENV).run(
        [sys.executable, script], 2, timeout=300, grace=1.0,
        liveness_timeout=1.5)
    elapsed = time.time() - t0
    by_rank = {r.index: r for r in results}
    assert not by_rank[1].ok and by_rank[1].disposition == "liveness_killed"
    assert "liveness timeout" in by_rank[1].error
    assert not by_rank[0].ok and by_rank[0].disposition == "gang_killed"
    assert "peer failure" in by_rank[0].error
    assert elapsed < 60, elapsed


def test_liveness_is_armed_only_after_the_first_beat(tmp_path):
    """A worker that never beats (a slow start, a kernel build) is not
    killed by the probe."""
    script = write_worker(tmp_path, """
        import time
        from distributed_tpu_torch.launch import report_result
        time.sleep(2.0)
        report_result("done")
        """)
    (r,) = LocalLauncher(env_extra=ENV).run(
        [sys.executable, script], 1, timeout=60, liveness_timeout=0.5)
    assert r.ok and r.value == "done"


# ------------------------------------------------------------------ restart --
RESTART = """
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.launch import report_result
    from distributed_tpu_torch.training.callbacks import (Callback,
                                                          ModelCheckpoint)

    spec = dtt.cluster.initialize(device="cpu", timeout=60)
    x, y = dtt.data.synthetic_images(512, (28, 28), 10, 0)
    x = x[..., None].astype(np.float32) / 255.0
    CKPT, MARKER = sys.argv[1], sys.argv[2]

    class DieOnce(Callback):
        # Worker 1 hard-exits mid-epoch-2 on the first attempt only.
        def on_batch_end(self, model, step, logs):
            if (spec.index == 1 and step == 5
                    and not os.path.exists(MARKER)):
                open(MARKER, "w").close()
                os._exit(17)

    with dtt.DataParallel(device="cpu").scope():
        m = dtt.Model(dtt.models.mnist_cnn())
        m.compile(optimizer=dtt.optim.SGD(0.05), metrics=["accuracy"])
    cbs = [ModelCheckpoint(CKPT, save_freq=3, restore=True), DieOnce()]
    hist = m.fit(x, y.astype(np.int32), batch_size=64, epochs=3,
                 steps_per_epoch=4, verbose=0, seed=0, callbacks=cbs)
    leaf = next(iter(m.params.values())).detach().reshape(-1)[:4]
    report_result({"rank": spec.index, "loss": hist.history["loss"],
                   "acc": hist.history["accuracy"],
                   "leaf": [float(v) for v in leaf],
                   "params": float(sum(float(p.double().sum())
                                       for p in m.params.values()))})
    dtt.cluster.shutdown()
"""


def test_restart_resumes_bit_identical(tmp_path):
    """Worker 1 dies at step 5 on the first attempt; run_with_restart
    relaunches the gang, which resumes from the last checkpoint and ends
    bit-identical to an uninterrupted run."""
    script = write_worker(tmp_path, RESTART)
    marker = tmp_path / "died_once"
    results = run_with_restart(
        LocalLauncher(env_extra=ENV),
        [sys.executable, script, str(tmp_path / "ckpt"), str(marker)], 2,
        max_restarts=2, restart_backoff=0.1, timeout=240, grace=5)
    assert all(r.ok for r in results), [(r.index, r.error, r.log_tail[-600:])
                                        for r in results]
    assert marker.exists()  # the failure happened
    ref = LocalLauncher(env_extra=ENV).run(
        [sys.executable, script, str(tmp_path / "ckpt_ref"), str(marker)], 2,
        timeout=240)
    assert all(r.ok for r in ref), [(r.index, r.error, r.log_tail[-600:])
                                    for r in ref]
    got = {r.index: r.value for r in results}
    want = {r.index: r.value for r in ref}
    for rank in (0, 1):
        for key in ("acc", "leaf", "params"):
            assert got[rank][key] == want[rank][key], (rank, key)
        # The resumed run's history holds the epochs it ran: the last.
        assert got[rank]["loss"][-1] == want[rank]["loss"][-1]


def test_restart_budget_exhausted_returns_failed_rows(tmp_path):
    script = write_worker(tmp_path, "import sys\nsys.exit(3)\n")
    results = run_with_restart(LocalLauncher(), [sys.executable, script], 2,
                               max_restarts=1, restart_backoff=0.0,
                               timeout=60, grace=1)
    assert [r.index for r in results] == [0, 1]
    assert not any(r.ok for r in results)


def test_restart_synthesizes_a_row_per_worker_when_launch_raises():
    class Unreachable:
        hosts = ["a", "b", "c"]

        def run(self, argv, **kw):
            raise RuntimeError("Preflight failed for: ['a:8476']")

    results = run_with_restart(Unreachable(), ["x"], max_restarts=0)
    assert [r.index for r in results] == [0, 1, 2]
    assert all(not r.ok and "Preflight" in r.error for r in results)


def test_place_takes_tensors_that_numpy_cannot_read():
    """A multi-rank restore hands ``interop.place`` the leaves it
    broadcast, tensors on the card, which ``np.asarray`` cannot read;
    here a tensor that requires grad stands in for them."""
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    m.compile(optimizer=dtt.optim.SGD(0.01))
    m.build((28, 28, 1))
    want = {k: (v.detach() + 1.0).requires_grad_()
            for k, v in m.params.items()}
    dtt.interop.place(m, params=want)
    for k, v in m.params.items():
        assert torch.equal(v, want[k].detach()), k


# ---------------------------------------------------------------------- ssh --
@pytest.fixture()
def fake_ssh(tmp_path):
    """An ssh stand-in: drops the host argument and runs the command
    locally; every command it runs is appended to fake-ssh.log."""
    path = tmp_path / "fake-ssh"
    log = tmp_path / "fake-ssh.log"
    path.write_text(
        "#!/bin/sh\n"
        "shift\n"
        f'printf \'%s\\n\' "$1" >> {log}\n'
        'exec bash -c "$1"\n'
    )
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_ssh_result_framing_and_config_injection(tmp_path, fake_ssh):
    script = write_worker(tmp_path, """
        from distributed_tpu_torch.cluster import from_env
        from distributed_tpu_torch.launch import report_result
        spec = from_env()
        print('log line before')
        report_result({'rank': spec.index, 'peers': spec.workers})
        print('log line after')
        """)
    launcher = SSHLauncher(["127.0.0.1", "127.0.0.1"], ssh_cmd=fake_ssh)
    results = launcher.run([sys.executable, script], timeout=60,
                           env_extra=ENV)
    assert [r.index for r in results] == [0, 1]
    assert all(r.ok for r in results), results
    assert sorted(r.value["rank"] for r in results) == [0, 1]
    assert len({tuple(r.value["peers"]) for r in results}) == 1
    assert all(len(r.value["peers"]) == 2 for r in results)


def test_ssh_malformed_frame_is_ignored(tmp_path, fake_ssh):
    script = write_worker(tmp_path, f"print({STDOUT_MARK!r} + 'not json')\n")
    (r,) = SSHLauncher(["127.0.0.1"], ssh_cmd=fake_ssh).run(
        [sys.executable, script], timeout=60)
    assert r.ok and r.value is None


def test_ssh_peer_failure_gang_kill(tmp_path, fake_ssh):
    script = write_worker(tmp_path, """
        import json, os, sys, time
        spec = json.loads(os.environ['DTPU_CONFIG'])
        if spec['task']['index'] == 1:
            sys.exit(3)
        time.sleep(300)
        """)
    launcher = SSHLauncher(["127.0.0.1", "127.0.0.1"], ssh_cmd=fake_ssh)
    t0 = time.time()
    results = launcher.run([sys.executable, script], timeout=240, grace=2)
    assert time.time() - t0 < 60, "gang kill must not wait out the timeout"
    by_rank = {r.index: r for r in results}
    assert not by_rank[1].ok and "exit code 3" in by_rank[1].error
    assert not by_rank[0].ok and "peer failure" in by_rank[0].error
    assert by_rank[0].disposition == "gang_killed"


def test_ssh_timeout_labeling(tmp_path, fake_ssh):
    script = write_worker(tmp_path, "import time\ntime.sleep(300)\n")
    t0 = time.time()
    (r,) = SSHLauncher(["127.0.0.1"], ssh_cmd=fake_ssh).run(
        [sys.executable, script], timeout=3, grace=2)
    assert time.time() - t0 < 60
    assert not r.ok and r.error == "timeout" and r.disposition == "timeout"


def test_ssh_liveness_kills_the_remote_pid(tmp_path, fake_ssh):
    """Heartbeats ride stdout marks; a SIGSTOPped worker is detected, its
    announced remote pid is killed (`kill -9 <pid>` over ssh) and its peer
    is gang-killed."""
    script = write_worker(tmp_path, """
        import json, os, signal, time
        from distributed_tpu_torch.launch import heartbeat, report_result
        spec = json.loads(os.environ['DTPU_CONFIG'])
        for i in range(400):
            heartbeat(min_interval=0.0)
            time.sleep(0.05)
            if spec['task']['index'] == 1 and i == 8:
                signal.raise_signal(signal.SIGSTOP)
        report_result({'rank': spec['task']['index']})
        """)
    launcher = SSHLauncher(["127.0.0.1", "127.0.0.1"], ssh_cmd=fake_ssh)
    t0 = time.time()
    results = launcher.run([sys.executable, script], timeout=300, grace=2.0,
                           liveness_timeout=3.0, env_extra=ENV)
    by_rank = {r.index: r for r in results}
    assert "liveness timeout" in by_rank[1].error
    assert by_rank[1].disposition == "liveness_killed"
    assert "peer failure" in by_rank[0].error
    assert time.time() - t0 < 90
    log_text = (tmp_path / "fake-ssh.log").read_text()
    assert re.search(r"^kill -9 \d+$", log_text, re.M), log_text[-500:]


def test_ssh_marks_do_not_pollute_output(tmp_path, fake_ssh):
    script = write_worker(tmp_path, """
        from distributed_tpu_torch.launch import heartbeat, report_result
        heartbeat(min_interval=0.0)
        print('real log line')
        heartbeat(min_interval=0.0)
        report_result({'ok': True})
        raise SystemExit(5)
        """)
    (r,) = SSHLauncher(["127.0.0.1"], ssh_cmd=fake_ssh).run(
        [sys.executable, script], timeout=60, env_extra=ENV)
    assert r.value == {"ok": True}
    assert HEARTBEAT_MARK not in r.log_tail and PID_MARK not in r.log_tail
    assert "real log line" in r.log_tail


# ------------------------------------------------------------- cluster init --
def _spec4():
    return cluster_config.ClusterSpec(
        workers=[f"10.0.0.{i}:8476" for i in range(4)], index=1)


def test_elastic_world_truncates_inherited_spec(monkeypatch):
    monkeypatch.setenv(cluster_init.ELASTIC_WORLD_ENV, "2")
    out = cluster_init._apply_elastic_world(_spec4())
    assert out.num_processes == 2 and out.index == 1
    assert out.workers == ["10.0.0.0:8476", "10.0.0.1:8476"]


def test_elastic_world_errors(monkeypatch):
    monkeypatch.setenv(cluster_init.ELASTIC_WORLD_ENV, "1")
    with pytest.raises(ValueError, match="outside the elastic world"):
        cluster_init._apply_elastic_world(_spec4())
    monkeypatch.setenv(cluster_init.ELASTIC_WORLD_ENV, "zero")
    with pytest.raises(ValueError, match="integer"):
        cluster_init._apply_elastic_world(_spec4())
    monkeypatch.setenv(cluster_init.ELASTIC_WORLD_ENV, "0")
    with pytest.raises(ValueError, match=">= 1"):
        cluster_init._apply_elastic_world(_spec4())


def test_elastic_grow_keeps_spec_and_no_override_is_identity(monkeypatch):
    monkeypatch.setenv(cluster_init.ELASTIC_WORLD_ENV, "8")
    assert cluster_init._apply_elastic_world(_spec4()).num_processes == 4
    monkeypatch.delenv(cluster_init.ELASTIC_WORLD_ENV)
    spec = _spec4()
    assert cluster_init._apply_elastic_world(spec) is spec


def test_initialize_honors_elastic_world_before_joining(monkeypatch):
    """An inherited 4-worker DTPU_CONFIG with DTPU_ELASTIC_WORLD=1 forms
    a group of 1 (applied before init_process_group); an explicit spec is
    never rewritten."""
    port = dtt.cluster.free_port()
    spec = cluster_config.ClusterSpec(
        workers=[f"127.0.0.1:{port}"] + [f"127.0.0.1:{port + i}"
                                         for i in range(1, 4)], index=0)
    monkeypatch.setenv(cluster_config.ENV_VAR, spec.to_json())
    monkeypatch.setenv(cluster_init.ELASTIC_WORLD_ENV, "1")
    try:
        out = dtt.cluster.initialize(device="cpu", timeout=30)
        assert out.num_processes == 1
        assert torch.distributed.get_world_size() == 1
    finally:
        dtt.cluster.shutdown()
    monkeypatch.setattr(cluster_init, "_form_group",
                        lambda *a, **k: "gloo")
    try:
        assert cluster_init.initialize(spec, device="cpu").num_processes == 4
    finally:
        cluster_init.reset_for_relaunch()


def test_reset_for_relaunch_clears_the_coordinator_cache():
    """The n = 1 coordinator path caches without forming a group, so it
    proves the reset in-process."""
    cluster_init.reset_for_relaunch()
    first = dtt.cluster.initialize(coordinator="127.0.0.1:12345",
                                   num_processes=1, process_id=0)
    assert first.workers == ["127.0.0.1:12345"]
    again = dtt.cluster.initialize(coordinator="127.0.0.1:54321",
                                   num_processes=1, process_id=0)
    assert again is first
    dtt.cluster.reset_for_relaunch()
    assert not dtt.cluster.is_initialized()
    fresh = dtt.cluster.initialize(coordinator="127.0.0.1:54321",
                                   num_processes=1, process_id=0)
    assert fresh.workers == ["127.0.0.1:54321"]
    dtt.cluster.shutdown()
    assert cluster_init._gathered_cache is None


def test_explicit_coordinator_gathers_real_worker_list(tmp_path):
    script = write_worker(tmp_path, """
        import distributed_tpu_torch as dtt
        from distributed_tpu_torch.cluster import from_env
        from distributed_tpu_torch.launch import report_result
        env = from_env()
        spec = dtt.cluster.initialize(
            coordinator=env.coordinator, num_processes=env.num_processes,
            process_id=env.index, device="cpu", timeout=60)
        again = dtt.cluster.initialize(coordinator="ignored:1",
                                       num_processes=2, process_id=0)
        report_result({"rank": spec.index, "workers": spec.workers,
                       "world": dtt.cluster.process_count(),
                       "cached": again is spec})
        dtt.cluster.shutdown()
        """)
    results = LocalLauncher(env_extra=ENV).run([sys.executable, script], 2,
                                               timeout=120)
    assert all(r.ok for r in results), [(r.error, r.log_tail[-500:])
                                        for r in results]
    workers = results[0].value["workers"]
    assert results[1].value["workers"] == workers and len(workers) == 2
    assert workers[0].endswith(":" + workers[0].rsplit(":", 1)[1])
    assert workers[1].endswith(":0") and workers[1].split(":")[0]
    assert all(r.value["world"] == 2 and r.value["cached"] for r in results)


# ---------------------------------------------------------------------- cli --
def test_cli_max_restarts_and_liveness(tmp_path, capsys, monkeypatch):
    """--max-restarts relaunches a gang that failed once; the rows and the
    exit code are as before; --liveness-timeout is accepted."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    marker = tmp_path / "failed_once"
    script = write_worker(tmp_path, f"""
        import os, sys
        from distributed_tpu_torch.launch import report_result
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            sys.exit(4)
        report_result("second")
        """)
    out_json = tmp_path / "rows.json"
    rc = launch_cli.main(["--num-workers", "1", "--max-restarts", "1",
                          "--liveness-timeout", "30", "--timeout", "60",
                          "--results-json", str(out_json), script])
    assert rc == 0
    rows = json.loads(out_json.read_text())
    assert rows == [{"index": 0, "ok": True, "value": "second",
                     "error": None, "exit_code": 0}]
    assert "worker 0: ok" in capsys.readouterr().out


def test_cli_hosts_runs_over_ssh(tmp_path, fake_ssh, monkeypatch, capsys):
    script = write_worker(tmp_path, """
        from distributed_tpu_torch.launch import report_result
        report_result("remote")
        """)
    real = SSHLauncher.__init__

    def with_fake(self, hosts, **kw):
        real(self, hosts, ssh_cmd=fake_ssh, **kw)

    monkeypatch.setattr(SSHLauncher, "__init__", with_fake)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    assert launch_cli.main(["--hosts", "127.0.0.1", "--timeout", "60",
                            script]) == 0
    assert "worker 0: ok  value='remote'" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--supervise"], ["--checkpoint-dir", "c"], ["--elastic-min-workers", "1"],
    ["--elastic-max-workers", "2"], ["--elastic-divisor", "8"],
    ["--buddy-store-dir", "b"], ["--event-log", "e"]])
def test_cli_resilience_flags_not_yet_ported(flags, tmp_path, capsys):
    """The JAX CLI's resilience flags were not ported until ``resilience/``
    was; now each is taken (paths under ``tmp_path``) and a one-worker
    gang of a trivial script runs to the end, under the supervisor with
    ``--supervise`` (tests/test_torch_resilience.py and
    tests/test_torch_redundancy.py drive it with faults)."""
    flags = [str(tmp_path / f) if f in ("c", "b", "e") else f for f in flags]
    script = write_worker(tmp_path, "print('fine')\n")
    assert launch_cli.main(flags + ["--timeout", "60", script]) == 0
    out = capsys.readouterr().out
    assert "worker 0: ok" in out
    assert ("supervisor: attempts=1" in out) == ("--supervise" in flags)


def test_lost_peer_exits_become_collateral():
    """On gloo a survivor's collective raises when a peer dies and the
    survivor exits on its own: the launcher marks it gang_killed, as the
    same worker blocked in NCCL would be, unless no worker failed first.
    A failure whose log holds the same words outside gloo's transport
    (an NCCL gang's own error) keeps its blame."""
    gloo = "RuntimeError: [/src/gloo/transport/tcp/pair.cc:553]"

    def row(i, tail, ok=False):
        return core.WorkerResult(index=i, ok=ok, error=None if ok else
                                 "exit code 1", exit_code=0 if ok else 1,
                                 log_tail=tail, disposition="exited")

    rows = [row(0, f"{gloo} Connection closed by peer [x]:1. GLHF!"),
            row(1, f"Traceback ...\n{gloo} Read error [x]:2: Connection "
                   "reset by peer\n"),
            row(2, "Traceback ... ValueError: bad"),
            row(3, "", ok=True),
            row(4, "OSError: [Errno 32] Broken pipe")]
    out = core._mark_lost_peers(rows)
    assert [r.disposition for r in out] == [
        "gang_killed", "gang_killed", "exited", "exited", "exited"]
    assert "a peer failed" in out[0].error
    alone = [row(0, f"{gloo} Connection closed by peer"),
             row(1, f"{gloo} Write error: Broken pipe")]
    assert [r.disposition for r in core._mark_lost_peers(alone)] == [
        "exited", "exited"]
