"""Multi-process bootstrap: the ``torch.distributed`` process group.

The counterpart of the JAX package's ``cluster/init.py``. There every
host runs one SPMD program and ``jax.distributed`` joins them; here every
card has its own process, and ``initialize()`` joins them into the default
``torch.distributed`` process group: NCCL when the device is a card, gloo
on the CPU, with worker 0's address (the ``ClusterSpec`` coordinator) as
the TCP rendezvous.

``initialize()`` resolves the spec in the JAX package's order (explicit
spec > DTPU_CONFIG/TF_CONFIG env > single process), is idempotent, and is
a no-op for a single process without a spec. A spec, even of one worker,
forms a group. The group's ``timeout`` bounds the rendezvous and every
collective, so a rank that never joins raises instead of hanging.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils import logging as dlog
from . import config as config_lib

_spec: Optional[config_lib.ClusterSpec] = None  # the spec that formed the group


def initialize(
    spec: Optional[config_lib.ClusterSpec] = None,
    *,
    device=None,
    timeout: float = 300.0,
) -> config_lib.ClusterSpec:
    """Join (or form) the cluster; call once per process, before any
    collective. ``device=None`` is this rank's card (cuda:<rank modulo the
    card count>, made the current device); it raises without one, and
    ``device="cpu"`` forms a gloo group. ``timeout`` (seconds) bounds the
    rendezvous and each collective. Returns the resolved ``ClusterSpec``."""
    global _spec
    if _spec is not None:
        return _spec
    spec = config_lib.resolve(spec)
    if spec is None:
        return config_lib.ClusterSpec(workers=["localhost:0"], index=0)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else spec.index % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    host, port = spec.coordinator.rsplit(":", 1)
    dist.init_process_group(
        backend, init_method=f"tcp://{host}:{port}",
        world_size=spec.num_processes, rank=spec.index,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _spec = spec
    if spec.is_chief:
        dlog.info(f"cluster up: {spec.num_processes} processes, {backend}, "
                  f"coordinator {spec.coordinator}")
    return spec


def is_initialized() -> bool:
    return _spec is not None


def shutdown() -> None:
    """Leave the cluster: destroy the default process group (whoever
    formed it, ``initialize`` or a world-1 ``DataParallel``), making
    ``initialize()`` callable again."""
    global _spec
    if dist.is_initialized():
        dist.destroy_process_group()
    _spec = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Host-level sync point across the group (no-op without one)."""
    if dist.is_initialized():
        dist.barrier()


__all__ = [
    "barrier", "initialize", "is_chief", "is_initialized", "process_count",
    "process_index", "shutdown",
]
