"""Replica-synchronization checking across the ranks of a process group.

The counterpart of the JAX package's ``utils/sync_check.py``. Under
synchronous data parallelism every rank's parameters must stay
BIT-identical; any drift means non-deterministic math or a broken
collective. There a JAX array's replicas sit on the devices of one
process; here each rank holds one replica, so the checks compare across
the default process group.

``assert_replicas_identical`` is exact and raises on every rank, naming
the first parameter that differs (``assert_model_replicas_identical``
checks a model's parameters and its state buffers); ``replica_drift`` reports the worst
difference per parameter (0.0 everywhere on a healthy run). Every rank
must call them (they are collectives). Without a group, or in a group of
one, there is nothing to compare.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t``, in rank order."""
    t = t.to(_comm_device())
    out = [torch.empty_like(t) for _ in range(_world())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu()


def _crc(t: torch.Tensor) -> int:
    data = t.detach().contiguous().cpu().numpy().tobytes()
    return zlib.crc32(data)


def assert_replicas_identical(params: Dict[str, torch.Tensor],
                              what: str = "params") -> None:
    """Raise AssertionError naming the first parameter whose replicas have
    diverged: each rank takes a CRC32 fingerprint of each parameter's
    bytes, and the ranks all-gather them (names first, so that a rank
    holding other parameters is reported, not gathered out of order)."""
    if _world() < 2:
        return
    names = sorted(params)
    names_crc = zlib.crc32("\x00".join(names).encode())
    header = torch.tensor([len(names), names_crc], dtype=torch.int64)
    headers = _all_gather(header)
    if (headers != headers[0]).any():
        bad = int((headers != headers[0]).any(dim=1).int().argmax())
        raise AssertionError(
            f"Replica placement asymmetry in {what}: rank 0 has "
            f"{int(headers[0, 0])} parameters (names crc "
            f"{int(headers[0, 1]):#x}), rank {bad} has "
            f"{int(headers[bad, 0])} (crc {int(headers[bad, 1]):#x})"
        )
    local = torch.tensor([_crc(params[n]) for n in names], dtype=torch.int64)
    gathered = _all_gather(local)
    for col, name in enumerate(names):
        vals = gathered[:, col]
        if (vals != vals[0]).any():
            bad = int((vals != vals[0]).int().argmax())
            raise AssertionError(
                f"Replica divergence in {what} at {name}: rank 0 "
                f"fingerprint {int(vals[0]):#x} != rank {bad} fingerprint "
                f"{int(vals[bad]):#x}"
            )


def assert_model_replicas_identical(model) -> None:
    """:func:`assert_replicas_identical` over a ``Model``'s parameters and
    then its state buffers (BatchNorm's running statistics, which sync-BN
    keeps identical across the ranks)."""
    assert_replicas_identical(model.params, "params")
    assert_replicas_identical(model.state, "state")


def replica_drift(params: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``{name: max |difference| from rank 0's replica over all ranks}``,
    on every rank; 0.0 when bit-identical (matching NaN/inf pairs count as
    in sync, a mismatch involving them as inf). Empty without replicas to
    compare."""
    if _world() < 2:
        return {}
    dev = _comm_device()
    out = {}
    for name in sorted(params):
        mine = params[name].detach().to(dev, torch.float64)
        ref = mine.clone()
        dist.broadcast(ref, src=0)
        same = (mine == ref) | (torch.isnan(mine) & torch.isnan(ref))
        diff = torch.nan_to_num((mine - ref).abs(), nan=np.inf)
        gap = torch.where(same, 0.0, diff).reshape(-1)
        worst = torch.cat([gap, gap.new_zeros(1)]).amax().reshape(1)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        out[name] = float(worst.item())
    return out


__all__ = [
    "assert_model_replicas_identical", "assert_replicas_identical",
    "replica_drift",
]
