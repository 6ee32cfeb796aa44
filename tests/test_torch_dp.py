"""The port's data-parallel trainer: 2 ranks over gloo on the CPU.

The JAX package's ``mnist_cnn`` is built once and its parameters go to an
npz. Two worker processes, started by the port's own launcher, each call
``cluster.initialize(device="cpu")`` (a gloo group from the DTPU_CONFIG
the launcher gives them), load the npz under ``DataParallel`` and fit 3
steps of global batch 64 (32 rows each). The same fit runs in JAX under
``DataParallel(jax.devices()[:2])`` and in the port under
``SingleDevice`` on the whole batch. Then the workers check that their
replicas are bit-identical, that a divergence injected on rank 1 is
reported by name, and that a global batch of 63 raises. A second pair of
workers fits the tiny ResNet (BatchNorm in every block) over 2 ranks of 8
rows, against JAX's 2-device DataParallel and the port's SingleDevice:
sync-BN.

Tolerances, f32: losses rtol 1e-5 (the data-parallel gate; the ranks average
two 32-row means where JAX and SingleDevice take one 64-row mean);
parameters atol 1e-5. Every spawned process has a timeout of at most 120
s, so a hang fails one test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GLOBAL_BATCH, STEPS, LR = 64, 3, 0.01
FIT = dict(batch_size=GLOBAL_BATCH, epochs=STEPS, steps_per_epoch=1,
           shuffle=True, seed=0, verbose=0)
COMPILE = dict(loss="sparse_categorical_crossentropy", metrics=["accuracy"])

WORKER = '''
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.utils import sync_check

spec = dtt.cluster.initialize(device="cpu", timeout=60)
data = np.load(sys.argv[1])
strategy = dtt.DataParallel(device="cpu")
with strategy.scope():
    model = dtt.Model(dtt.models.mnist_cnn())
    model.compile(optimizer=dtt.optim.SGD(%(lr)r), **%(compile)r)
model.build((28, 28, 1))
model.load_params({k[2:]: torch.from_numpy(data[k]) for k in data.files
                   if k.startswith("p:")})
x, y = data["x"], data["y"]
hist = model.fit(x, y, **%(fit)r)
sync_check.assert_replicas_identical(model.params)
if spec.is_chief:
    np.savez(sys.argv[2], **dtt.interop.params_to_numpy(model.params))
evaluated = model.evaluate(x[:40], y[:40], batch_size=16, verbose=0)
try:
    model.fit(x, y, batch_size=63, epochs=1, steps_per_epoch=1, verbose=0)
    batch_error = None
except ValueError as e:
    batch_error = str(e)
if spec.index == 1:
    with torch.no_grad():
        model.params["dense/bias"].add_(1e-3)
try:
    sync_check.assert_replicas_identical(model.params)
    diverged = None
except AssertionError as e:
    diverged = str(e)
drift = sync_check.replica_drift(model.params)
dtt.launch.report_result({
    "rank": spec.index, "world": spec.num_processes,
    "replicas": strategy.num_replicas_in_sync, "history": hist.history,
    "evaluate": evaluated, "batch_error": batch_error,
    "diverged": diverged, "drift": drift,
})
dtt.cluster.shutdown()
'''


def _data():
    x, y = dtt.data.synthetic_images(4 * GLOBAL_BATCH, (28, 28), 10, 0)
    return x[..., None].astype(np.float32) / 255.0, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX DataParallel, port SingleDevice and the 2-rank port run, all
    from the same JAX-built parameters and batches."""
    tmp = tmp_path_factory.mktemp("dp")
    x, y = _data()
    with dtpu.DataParallel(jax.devices()[:2]).scope():
        jm = dtpu.Model(dtpu.models.mnist_cnn())
        jm.compile(optimizer=dtpu.optim.SGD(LR), **COMPILE)
    jm.build((28, 28, 1), seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    np.savez(tmp / "in.npz", x=x, y=y,
             **{f"p:{k}": v for k, v in start.items()})
    script = tmp / "worker.py"
    script.write_text(WORKER % dict(lr=LR, compile=COMPILE, fit=FIT))
    launcher = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": str(ROOT)})
    rows = launcher.run([sys.executable, str(script), str(tmp / "in.npz"),
                         str(tmp / "out.npz")], 2, timeout=120)
    for r in rows:
        assert r.ok, f"worker {r.index}: {r.error}\n{r.log_tail}"
    port_dp = {r.index: r.value for r in rows}
    with np.load(tmp / "out.npz") as z:
        dp_params = {k: z[k] for k in z.files}

    jax_hist = jm.fit(x, y, **FIT).history
    jax_eval = jm.evaluate(x[:40], y[:40], batch_size=16, verbose=0)
    jax_params = dtt.interop.flatten_tree(jax.device_get(jm.params))

    sm = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    sm.compile(optimizer=dtt.optim.SGD(LR), **COMPILE)
    sm.build((28, 28, 1))
    sm.load_params({k: torch.tensor(v) for k, v in start.items()})
    single_hist = sm.fit(x, y, **FIT).history
    single_eval = sm.evaluate(x[:40], y[:40], batch_size=16, verbose=0)
    single_params = dtt.interop.params_to_numpy(sm.params)
    return dict(port_dp=port_dp, dp_params=dp_params, jax_hist=jax_hist,
                jax_eval=jax_eval, jax_params=jax_params,
                single_hist=single_hist, single_eval=single_eval,
                single_params=single_params)


def test_two_rank_losses_match_jax_dp_and_single_device(runs):
    for rank, row in runs["port_dp"].items():
        assert (row["rank"], row["world"], row["replicas"]) == (rank, 2, 2)
        losses = row["history"]["loss"]
        assert len(losses) == STEPS
        np.testing.assert_allclose(losses, runs["jax_hist"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(losses, runs["single_hist"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(row["history"]["accuracy"],
                                   runs["jax_hist"]["accuracy"],
                                   atol=1 / GLOBAL_BATCH)
    assert runs["port_dp"][0]["history"] == runs["port_dp"][1]["history"]


def test_two_rank_params_match_jax_dp_and_single_device(runs):
    got = runs["dp_params"]
    for want in (runs["jax_params"], runs["single_params"]):
        assert set(got) == set(want)
        for path in got:
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-5, err_msg=path)


def test_two_rank_evaluate_matches(runs):
    """40 rows at batch 16: the last batch's 8 rows all fall to rank 0."""
    for row in runs["port_dp"].values():
        for want in (runs["jax_eval"], runs["single_eval"]):
            assert set(row["evaluate"]) == set(want) == {"loss", "accuracy"}
            np.testing.assert_allclose(row["evaluate"]["loss"], want["loss"],
                                       rtol=1e-5)
            assert row["evaluate"]["accuracy"] == pytest.approx(
                want["accuracy"], abs=1e-6)


def test_replicas_identical_and_injected_divergence_named(runs):
    for row in runs["port_dp"].values():
        # assert_replicas_identical passed after training (the worker
        # would have failed otherwise); the injected one is named on both.
        assert row["diverged"] is not None
        assert "dense/bias" in row["diverged"] and "rank 1" in row["diverged"]
        drift = row["drift"]
        assert drift["dense/bias"] == pytest.approx(1e-3, rel=1e-3)
        assert all(v == 0.0 for k, v in drift.items() if k != "dense/bias")


def test_global_batch_not_divisible_raises_naming_both(runs):
    for row in runs["port_dp"].values():
        assert row["batch_error"] == (
            "Global batch 63 not divisible by 2 replicas")


# ------------------------------------------------------------ sync-BN ResNet
RESNET_WORKER = '''
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.utils import sync_check

spec = dtt.cluster.initialize(device="cpu", timeout=60)
data = np.load(sys.argv[1])
with dtt.DataParallel(device="cpu").scope():
    model = dtt.Model(dtt.models.resnet(50, 10, **%(tiny)r))
    model.compile(optimizer=dtt.optim.SGD(%(lr)r, momentum=0.9), **%(compile)r)
model.build((16, 16, 3))
model.load_params({k[2:]: torch.from_numpy(data[k]) for k in data.files
                   if k.startswith("p:")})
model.load_state({k[2:]: torch.from_numpy(data[k]) for k in data.files
                  if k.startswith("s:")})
hist = model.fit(data["x"], data["y"], **%(fit)r)
sync_check.assert_model_replicas_identical(model)
if spec.is_chief:
    np.savez(sys.argv[2], **dtt.interop.state_to_numpy(model.state))
dtt.launch.report_result({"rank": spec.index, "history": hist.history})
dtt.cluster.shutdown()
'''
RESNET_TINY = dict(small_inputs=True, stage_blocks=(1, 1, 1, 1), width=16)
RESNET_FIT = dict(batch_size=16, epochs=3, steps_per_epoch=1, shuffle=True,
                  seed=0, verbose=0)
RESNET_LR = 0.05


def test_two_rank_sync_batchnorm_resnet_matches_jax_dp_and_single_device(
        tmp_path):
    """The tiny ResNet (BatchNorm in every block) over 2 gloo ranks of 8
    rows each: sync-BN makes each step's batch statistics those of the
    global 16 rows, as GSPMD makes JAX's ``DataParallel`` and as one
    device computes them; the running statistics end equal to JAX's and
    to SingleDevice's (atol 1e-4, as parameters in
    ``test_torch_resnet.py``), losses at rtol 1e-5, and the replicas and
    their buffers bit-identical.

    Data seed 4, as in ``test_torch_resnet.py`` and for the same reason:
    over data seeds 0-7 the port's SingleDevice against JAX's 2-device
    DataParallel holds at 0, 2 and 4; JAX against itself with its
    parameters moved by 2e-7 (``tests/resnet_seed_sweep.py
    --config dp``) parts at 1, 2, 3 and 5, and at seed 4 under 2 of 11
    such perturbations."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    with dtpu.DataParallel(jax.devices()[:2]).scope():
        jm = dtpu.Model(dtpu.models.resnet(50, 10, **RESNET_TINY))
        jm.compile(optimizer=dtpu.optim.SGD(RESNET_LR, momentum=0.9),
                   **COMPILE)
    jm.build((16, 16, 3), seed=0)
    params = dtt.interop.flatten_tree(jax.device_get(jm.params))
    state = dtt.interop.flatten_tree(jax.device_get(jm.state))
    np.savez(tmp_path / "in.npz", x=x, y=y,
             **{f"p:{k}": v for k, v in params.items()},
             **{f"s:{k}": v for k, v in state.items()})
    script = tmp_path / "worker.py"
    script.write_text(RESNET_WORKER % dict(
        tiny=RESNET_TINY, lr=RESNET_LR, compile=COMPILE, fit=RESNET_FIT))
    launcher = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": str(ROOT)})
    rows = launcher.run([sys.executable, str(script), str(tmp_path / "in.npz"),
                         str(tmp_path / "out.npz")], 2, timeout=120)
    for r in rows:
        assert r.ok, f"worker {r.index}: {r.error}\n{r.log_tail}"
    with np.load(tmp_path / "out.npz") as z:
        dp_state = {k: z[k] for k in z.files}

    jax_hist = jm.fit(x, y, **RESNET_FIT).history
    sm = dtt.Model(dtt.models.resnet(50, 10, **RESNET_TINY), device="cpu")
    sm.compile(optimizer=dtt.optim.SGD(RESNET_LR, momentum=0.9), **COMPILE)
    sm.build((16, 16, 3))
    sm.load_params({k: torch.tensor(v) for k, v in params.items()})
    sm.load_state({k: torch.tensor(v) for k, v in state.items()})
    single_hist = sm.fit(x, y, **RESNET_FIT).history

    assert rows[0].value["history"] == rows[1].value["history"]
    for want in (jax_hist["loss"], single_hist["loss"]):
        np.testing.assert_allclose(rows[0].value["history"]["loss"], want,
                                   rtol=1e-5)
    for want in (dtt.interop.flatten_tree(jax.device_get(jm.state)),
                 dtt.interop.state_to_numpy(sm.state)):
        assert set(dp_state) == set(want)
        for path in dp_state:
            np.testing.assert_allclose(dp_state[path], want[path], rtol=0,
                                       atol=1e-4, err_msg=path)


def test_world_one_data_parallel_equals_single_device():
    """``DataParallel()`` outside a group forms a world-1 gloo group: the
    all-reduce over one rank is exact, so it trains bit for bit as
    ``SingleDevice``."""
    x, y = _data()

    def fit(strategy):
        with strategy.scope():
            m = dtt.Model(dtt.models.mnist_cnn())
            m.compile(optimizer=dtt.optim.fused_adam(1e-3), **COMPILE)
        m.build((28, 28, 1), seed=3)
        hist = m.fit(x, y, batch_size=16, epochs=2, steps_per_epoch=1,
                     verbose=0).history
        return hist, dtt.interop.params_to_numpy(m.params)

    try:
        dp = dtt.DataParallel(device="cpu")
        assert torch.distributed.get_world_size() == 1
        assert dp.num_replicas_in_sync == 1 and dp.local_batch_size(7) == 7
        assert (dtt.cluster.process_index(), dtt.cluster.process_count()) == (
            0, 1) and dtt.cluster.is_chief()
        dtt.cluster.barrier()
        with dp.scope():
            assert dtt.Model(dtt.models.mnist_cnn(), device="cpu").strategy is dp
            with pytest.raises(ValueError, match="places the model"):
                dtt.Model(dtt.models.mnist_cnn(), device="meta")
        got = fit(dp)
    finally:
        dtt.cluster.shutdown()
    want = fit(dtt.SingleDevice("cpu"))
    assert got[0] == want[0]
    for path in want[1]:
        assert np.array_equal(got[1][path], want[1][path]), path


def test_compile_strategy_overrides_the_captured_one():
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    assert isinstance(m.strategy, dtt.SingleDevice)
    other = dtt.SingleDevice("cpu")
    m.compile(optimizer="sgd", strategy=other)
    assert m.strategy is other
    with pytest.raises(ValueError, match="parallel.Strategy"):
        m.compile(optimizer="sgd", strategy="data")
    assert dtt.MultiWorkerMirroredStrategy is dtt.DataParallel


def test_cluster_spec_from_env(monkeypatch):
    spec = {"cluster": {"worker": ["10.0.0.1:10087", "10.0.0.2:10088"]},
            "task": {"type": "worker", "index": 1}}
    for var in ("DTPU_CONFIG", "TF_CONFIG"):
        monkeypatch.delenv("DTPU_CONFIG", raising=False)
        monkeypatch.delenv("TF_CONFIG", raising=False)
        monkeypatch.setenv(var, json.dumps(spec))
        got = dtt.cluster.from_env()
        assert got.workers == spec["cluster"]["worker"] and got.index == 1
        assert got.coordinator == "10.0.0.1:10087" and not got.is_chief
        assert dtt.cluster.ClusterSpec.from_json(got.to_json()) == got
    ps = dict(spec, task={"type": "ps", "index": 0})
    with pytest.raises(ValueError, match="Only 'worker' tasks"):
        dtt.cluster.ClusterSpec.from_json(json.dumps(ps))
    with pytest.raises(ValueError, match="'worker' job"):
        dtt.cluster.ClusterSpec.from_json(json.dumps(
            {"cluster": {"ps": ["a:1"]}}))
    with pytest.raises(ValueError, match="out of range"):
        dtt.cluster.ClusterSpec(workers=["a:1"], index=1).validate()
    monkeypatch.delenv("TF_CONFIG")
    # No spec: a single process, no group formed.
    assert dtt.cluster.initialize(device="cpu").workers == ["localhost:0"]
    assert not torch.distributed.is_initialized()
    assert dtt.cluster.from_barrier(["h1:5", "h2:6"], 1).workers == [
        "h1:8001", "h2:8002"]


LAUNCHED = '''
import torch
import torch.distributed as dist

import distributed_tpu_torch as dtt

spec = dtt.cluster.initialize(device="cpu", timeout=60)
t = torch.tensor([float(spec.index + 1)])
dist.all_reduce(t)
dtt.launch.report_result({"rank": dist.get_rank(), "sum": t.item()})
dtt.cluster.shutdown()
'''


def test_launch_cli_runs_two_workers_and_collects_rows(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(LAUNCHED)
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tpu_torch.launch",
         "--num-workers", "2", "--timeout", "100", "--results-json",
         str(out), str(script)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads(out.read_text())
    assert [r["index"] for r in rows] == [0, 1]
    assert all(r["ok"] and r["exit_code"] == 0 for r in rows)
    assert [r["value"] for r in rows] == [{"rank": 0, "sum": 3.0},
                                          {"rank": 1, "sum": 3.0}]
    assert "worker 1: ok" in proc.stdout


@pytest.mark.parametrize("script,timeout,want", [
    # Rank 1 fails at once: rank 0, stuck, is killed after the grace.
    ("import os, sys, time\n"
     "if os.environ['DTPU_CONFIG'].endswith('\"index\": 1}}'): sys.exit(3)\n"
     "time.sleep(60)\n", 60, [("gang_killed", None), ("exited", 3)]),
    # Both hang: the deadline kills both.
    ("import time\ntime.sleep(60)\n", 2, [("timeout", None)] * 2),
])
def test_launcher_gang_semantics(tmp_path, script, timeout, want):
    path = tmp_path / "job.py"
    path.write_text(script)
    rows = dtt.launch.LocalLauncher().run([sys.executable, str(path)], 2,
                                          timeout=timeout, grace=1.0)
    assert [(r.disposition, r.exit_code) for r in rows] == want
    assert not any(r.ok for r in rows)


def test_net_helpers_on_localhost():
    import socket

    ports = dtt.cluster.net.free_ports(3)
    assert len(set(ports)) == 3 and all(p > 0 for p in ports)
    assert dtt.cluster.net.backoff_schedule(4, 0.5, 1.5) == [0.5, 1.0, 1.5]
    with socket.socket() as listener:
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        up = f"127.0.0.1:{listener.getsockname()[1]}"
        # A refused connection still means the host answered.
        refused = f"127.0.0.1:{dtt.cluster.free_port()}"
        assert dtt.cluster.preflight([up, refused], timeout=1.0,
                                     attempts=1) == {up: True, refused: True}
