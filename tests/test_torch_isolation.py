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
    + ["chip_smoke.py"]
    + sorted(str(p.relative_to(ROOT))
             for p in (ROOT / "scripts").glob("torch_*.py")),
)
def test_no_jax_or_reference_import_in_source(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path} imports {hits}"


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.Model(dtt.models.transformer_lm(16, num_layers=1, d_model=8,
                                            num_heads=2, max_len=8))
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.resolve_device(None)
    assert dtt.resolve_device("cpu") == torch.device("cpu")


def test_unported_variants_raise():
    for flag in ("moe_experts", "pipeline", "scan", "remat"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            dtt.models.transformer_lm(16, **{flag: 1})
