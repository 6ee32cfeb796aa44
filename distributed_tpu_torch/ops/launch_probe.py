"""The launch-cost probe (kernel K15): ``x * 1.0001`` on one small tile.

The JAX package's ``examples/profile_op_floor.py`` launches the smallest
Pallas kernel it can, ``k`` (``o = x * 1.0001`` on an (8, 128) f32 tile),
to measure what one kernel launch costs on its runtime. The port's probe
is ``csrc/launch_probe.cu``: one block, one rounded multiply per entry, so
it equals :func:`launch_probe_ref` bit for bit. No training or serving
path calls it; ``scripts/torch_op_floor.py`` and ``chip_smoke.py`` time
it.

Dispatch is by the device of the tensor, with no fallback: a CUDA tensor
launches the kernel (a failed build or launch raises), a CPU tensor runs
the plain version. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import _I, _P

#: Launches of the CUDA kernel; incremented only where it is launched.
launches = {"launch_probe": 0}

#: The probe's tile, as the JAX package's: (8, 128) f32.
SHAPE = (8, 128)


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def launch_probe_ref(x):
    """``x * 1.0001`` in f32 (one rounded multiply per entry)."""
    return x * 1.0001


_LIB = _build.Library("launch_probe", {
    "dtt_launch_probe": [_P, _P, _I, _P],
})


def _launch_probe_cuda(x):
    _build.require(x, "x", x.device, torch.float32)
    out = torch.empty_like(x)
    rc = _LIB.get().dtt_launch_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                                     _build.stream(x.device))
    _build.check_launch(rc, "launch_probe")
    launches["launch_probe"] += 1
    return out


def launch_probe(x):
    """:func:`launch_probe_ref`'s result: the kernel for a CUDA tensor,
    the plain version for a CPU one."""
    return _build.dispatch(x, _launch_probe_cuda, launch_probe_ref,
                           "launch_probe")(x)


__all__ = [
    "SHAPE", "launch_probe", "launch_probe_ref", "launches",
    "reset_launch_counts",
]
