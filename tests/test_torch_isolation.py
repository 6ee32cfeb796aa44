"""The port stands alone: no JAX, nothing of distributed_tpu, no quiet CPU.

- Importing every port module works in a process where ``jax`` and
  ``distributed_tpu`` cannot be imported.
- No port source (nor ``chip_smoke.py`` or the port's profiling script)
  names ``jax`` or a ``distributed_tpu.`` module in an import.
- ``device=None`` means the card: on a box without one it raises.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distributed_tpu_torch as dtt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_tpu_torch"


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)],
                                              prefix="distributed_tpu_torch.")
    )


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['distributed_tpu'] = None\n"
        "import importlib\n"
        f"for name in {['distributed_tpu_torch'] + _port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+distributed_tpu\b(?!_torch)"
    r"|from\s+distributed_tpu\b(?!_torch))"
    r"|distributed_tpu\.(?!_torch)[a-z_]+\s+import",
    re.M,
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py", "tests/torch_r_sim.py"]
    + sorted(str(p.relative_to(ROOT))
             for p in (ROOT / "scripts").glob("torch_*.py")),
)
def test_no_jax_or_reference_import_in_source(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path} imports {hits}"


def test_sharded_strategy_modules_are_checked():
    """The sharded strategies' modules and the scaling script that runs
    them on 4 cards are among the sources checked above and the modules
    imported with JAX blocked."""
    checked = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")} | {
        str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
            "torch_*.py")}
    for path in ("distributed_tpu_torch/parallel/mesh.py",
                 "distributed_tpu_torch/parallel/collectives.py",
                 "distributed_tpu_torch/parallel/strategy.py",
                 "distributed_tpu_torch/checkpoint/sharded.py",
                 "distributed_tpu_torch/ops/ring_attention.py",
                 "scripts/torch_dp_scaling.py"):
        assert path in checked, path
    for name in ("distributed_tpu_torch.parallel.mesh",
                 "distributed_tpu_torch.parallel.collectives",
                 "distributed_tpu_torch.checkpoint.sharded",
                 "distributed_tpu_torch.ops.ring_attention"):
        assert name in _port_modules(), name


def test_resilience_and_obs_modules_are_checked():
    """resilience/, the new obs/ modules and the restart script that drives
    them on the cards are among the sources checked above and the modules
    imported with JAX blocked."""
    checked = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")} | {
        str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
            "torch_*.py")}
    names = ["resilience", "resilience.policy", "resilience.markers",
             "resilience.elastic", "resilience.faults",
             "resilience.preemption", "resilience.supervisor",
             "resilience.redundancy", "obs.flight", "obs.aggregate",
             "obs.export", "obs.cli"]
    for name in names:
        path = "distributed_tpu_torch/" + name.replace(".", "/")
        path += "/__init__.py" if name == "resilience" else ".py"
        assert path in checked, path
        assert f"distributed_tpu_torch.{name}" in _port_modules(), name
    assert "scripts/torch_restart.py" in checked



def test_rl_and_data_tier_modules_are_checked():
    """rl/, the data tiers, the augmentation layers and the ImageNet
    recipe are among the sources checked above and the modules imported
    with JAX blocked; the native ring's source is the port's own copy."""
    checked = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")} | {
        str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
            "torch_*.py")}
    names = ["rl", "rl.loop", "rl.distill", "rl.rewards", "data.records",
             "data.filesource", "data.pipeline", "data.datasets",
             "nn.augment"]
    for name in names:
        path = "distributed_tpu_torch/" + name.replace(".", "/")
        path += "/__init__.py" if name == "rl" else ".py"
        assert path in checked, path
        assert f"distributed_tpu_torch.{name}" in _port_modules(), name
    assert "scripts/torch_imagenet_resnet.py" in checked
    assert (PKG / "data" / "native" / "pipeline.cc").is_file()

def test_r_runtime_and_linter_of_phase_z9_run_without_jax():
    """chip_smoke.py's phase z9 builds the R session of
    ``tests/torch_r_sim.py`` (the port's R package on the simulated R
    runtime) and runs the port's linter: both work where ``jax`` and
    ``distributed_tpu`` cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['distributed_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import torch_r_sim\n"
        "from distributed_tpu_torch.analysis import cli\n"
        "interp = torch_r_sim.TorchInterp(device='cpu')\n"
        "interp.run_source('library(distributedtputorch)\\n"
        "v <- dtpu_version()\\nm <- dtpu_model(mnist_cnn(10L), "
        "device = \"cpu\")')\n"
        "print(interp.global_env.lookup('v').values[0])\n"
        "print(cli.main(['--rules', 'thread-hygiene']))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == dtt.__version__ and lines[-1] == "0", lines


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.Model(dtt.models.transformer_lm(16, num_layers=1, d_model=8,
                                            num_heads=2, max_len=8))
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.resolve_device(None)
    for strategy in (dtt.ZeroDataParallel, dtt.FullyShardedDataParallel,
                     dtt.FSDP):
        with pytest.raises(RuntimeError, match="cuda"):
            strategy()
    assert dtt.resolve_device("cpu") == torch.device("cpu")


def test_unported_variants_raise():
    # The MoE and pipelined variants are ported: the LM builds them.
    moe = dtt.models.transformer_lm(16, moe_experts=2, moe_every=1)
    assert isinstance(moe.layers[3].main.layers[1], dtt.nn.MoE)
    assert isinstance(dtt.models.transformer_lm(16, pipeline=True).layers[2],
                      dtt.nn.PipelinedBlocks)
    # The buddy tier is ported: it needs the sharded layout, as in JAX.
    with pytest.raises(ValueError, match="sharded=True"):
        dtt.callbacks.ModelCheckpoint("ckpt", buddy=True)
    # The auto-shard planner is ported: compile(strategy="auto") keeps a
    # pending plan for build.
    auto = dtt.Model(dtt.models.transformer_lm(16), device="cpu").compile(
        strategy="auto")
    assert auto._auto_shard is not None and auto.last_plan is None
    # scan is ported: the blocks stack in one ScannedBlocks.
    assert isinstance(dtt.models.transformer_lm(16, scan=True).layers[2],
                      dtt.nn.ScannedBlocks)
    # remat is ported: the LM builds with it.
    assert isinstance(dtt.models.transformer_lm(16, remat=True).layers[2],
                      dtt.nn.Remat)
