"""Multi-process bootstrap: the ``torch.distributed`` process group.

The counterpart of the JAX package's ``cluster/init.py``. There every
host runs one SPMD program and ``jax.distributed`` joins them; here every
card has its own process, and ``initialize()`` joins them into the default
``torch.distributed`` process group: NCCL when the device is a card, gloo
on the CPU, with worker 0's address (the ``ClusterSpec`` coordinator) as
the TCP rendezvous.

``initialize()`` resolves in the JAX package's order (explicit
coordinator arguments > explicit spec > DTPU_CONFIG/TF_CONFIG env >
single process), is idempotent, and is a no-op for a single process
without a spec. A spec, even of one worker, forms a group. An
env-inherited spec honours ``DTPU_ELASTIC_WORLD`` (a resized gang's
world). The group's ``timeout`` bounds the rendezvous and every
collective, so a rank that never joins raises instead of hanging.

The JAX package's TPU-pod detection (``_tpu_pod_spec``,
``_should_auto_init``) and its XLA:CPU collectives switch have no
counterpart: a card's process learns its rank from the spec, and gloo
needs no switch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils import logging as dlog
from . import config as config_lib

_spec: Optional[config_lib.ClusterSpec] = None  # the spec that formed the group
_gathered_cache = None  # explicit-coordinator spec, cached after the gather

# Elastic world-size override, exported by a resizing supervisor: the
# relaunched gang must form a clean N'-process group even when the
# inherited DTPU_CONFIG/TF_CONFIG still names the old N workers.
ELASTIC_WORLD_ENV = "DTPU_ELASTIC_WORLD"


def _form_group(coordinator: str, n: int, index: int, device,
                timeout: float) -> str:
    """Join the default process group of ``n`` ranks as rank ``index``,
    rendezvous at ``coordinator``; returns the backend."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else index % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    host, port = coordinator.rsplit(":", 1)
    dist.init_process_group(
        backend, init_method=f"tcp://{host}:{port}", world_size=n,
        rank=index, timeout=datetime.timedelta(seconds=timeout))
    return backend


def _gathered_workers(coordinator: str, n: int, index: int) -> list:
    """Real rank-ordered worker list for an explicit-coordinator init:
    every process contributes its own address through an all-gather over
    the formed group (a collective: every rank calls it). Rank 0's entry
    keeps the coordinator's port; the others report port 0 (an
    informational address: a worker runs no server of its own)."""
    from . import net

    mine = coordinator if index == 0 else f"{net.my_ip()}:0"
    if n <= 1:
        return [mine]
    cap = 256
    raw = mine.encode()
    if len(raw) > cap:
        raise ValueError(f"worker address {mine!r} exceeds {cap} bytes")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = torch.zeros(cap, dtype=torch.uint8)
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    out = torch.empty(n * cap, dtype=torch.uint8, device=dev)
    dist.all_gather_into_tensor(out, buf.to(dev))
    rows = out.cpu().view(n, cap).numpy()
    return [bytes(row).rstrip(b"\x00").decode(errors="replace")
            for row in rows]


def _apply_elastic_world(
    spec: config_lib.ClusterSpec,
) -> config_lib.ClusterSpec:
    """Honor ``DTPU_ELASTIC_WORLD`` over an env-inherited spec: truncate
    the worker list to the elastic world's first N' entries (rank order is
    the supervisor's contract — surviving workers keep a dense rank
    prefix). A rank outside the new world must not join at all: raising
    here beats N' workers hanging at a collective waiting for a ghost.
    Growing past the inherited list is impossible from this side (the
    override carries no addresses) — the launcher regenerates the spec on
    a real grow, so warn and keep the spec."""
    raw = os.environ.get(ELASTIC_WORLD_ENV)
    if not raw:
        return spec
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{ELASTIC_WORLD_ENV} must be an integer, got {raw!r}"
        ) from None
    if n < 1:
        raise ValueError(f"{ELASTIC_WORLD_ENV} must be >= 1, got {n}")
    if n == spec.num_processes:
        return spec
    if n > spec.num_processes:
        dlog.warning(
            f"{ELASTIC_WORLD_ENV}={n} exceeds the inherited spec's "
            f"{spec.num_processes} workers; an elastic grow needs a "
            "regenerated spec (the override carries no addresses) — "
            "keeping the inherited spec"
        )
        return spec
    if spec.index >= n:
        raise ValueError(
            f"rank {spec.index} is outside the elastic world of {n} "
            f"(inherited spec had {spec.num_processes} workers); this "
            "process should not have been launched"
        )
    return config_lib.ClusterSpec(
        workers=list(spec.workers[:n]), index=spec.index
    ).validate()


def initialize(
    spec: Optional[config_lib.ClusterSpec] = None,
    *,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: float = 300.0,
) -> config_lib.ClusterSpec:
    """Join (or form) the cluster; call once per process, before any
    collective. ``device=None`` is this rank's card (cuda:<rank modulo the
    card count>, made the current device); it raises without one, and
    ``device="cpu"`` forms a gloo group. ``timeout`` (seconds) bounds the
    rendezvous and each collective.

    Resolution order: explicit ``coordinator``/``num_processes``/
    ``process_id`` (a group of ``num_processes`` > 1 ranks, whose real
    worker list is gathered from every rank and cached, so a repeated
    call does not re-enter the gather) > explicit spec > DTPU_CONFIG/
    TF_CONFIG (truncated by ``DTPU_ELASTIC_WORLD``) > single process.
    Returns the resolved ``ClusterSpec``."""
    global _spec, _gathered_cache
    if coordinator is not None:
        if _gathered_cache is not None:
            # A repeat call: the gather below is a collective and would
            # hang if the peers don't re-enter it.
            return _gathered_cache
        n = int(num_processes or 1)
        idx = int(process_id or 0)
        if n > 1 and not dist.is_initialized():
            _form_group(coordinator, n, idx, device, timeout)
        _gathered_cache = config_lib.ClusterSpec(
            workers=_gathered_workers(coordinator, n, idx), index=idx)
        if n > 1:
            _spec = _gathered_cache
        return _gathered_cache
    if _spec is not None:
        return _spec
    explicit = spec is not None
    spec = config_lib.resolve(spec)
    if spec is None:
        return config_lib.ClusterSpec(workers=["localhost:0"], index=0)
    if not explicit:
        # An env-inherited spec can be stale across an elastic resize; an
        # explicitly passed spec is the caller's authority.
        spec = _apply_elastic_world(spec)
    backend = _form_group(spec.coordinator, spec.num_processes, spec.index,
                          device, timeout)
    _spec = spec
    if spec.is_chief:
        dlog.info(f"cluster up: {spec.num_processes} processes, {backend}, "
                  f"coordinator {spec.coordinator}")
    return spec


def is_initialized() -> bool:
    return _spec is not None


def reset_for_relaunch() -> None:
    """Clear the module's memo state (the spec that formed the group and
    the explicit-coordinator cache) so a re-formed — possibly resized —
    gang can ``initialize()`` cleanly in the same process; without it an
    in-process relaunch silently reuses the stale spec: the old world
    size, the old coordinator, the old rank. Bookkeeping only: it does
    not destroy a live process group (use :func:`shutdown` when this
    process joined one)."""
    global _spec, _gathered_cache
    _spec = None
    _gathered_cache = None


def shutdown() -> None:
    """Leave the cluster: destroy the default process group (whoever
    formed it, ``initialize`` or a world-1 ``DataParallel``) and every
    group formed over it, and clear the memo state, making
    ``initialize()`` callable again. Every rank of the gang calls it.

    The ranks first meet at a barrier, so no rank leaves (rank 0 with the
    rendezvous store) while a peer still connects or runs a collective.
    The port holds its groups weakly (``parallel.collectives``) and the
    meshes drop theirs here, so destroying them ends each gloo group's
    worker threads now, while the interpreter is whole: a worker that
    outlived it, releasing a finished collective's tensors as the
    interpreter finalized, would abort the rank (``std::terminate``); a
    group the caller still holds keeps its workers so. A barrier that
    fails (a peer gone) raises after the teardown."""
    if dist.is_initialized():
        from ..parallel import mesh

        try:
            dist.barrier()
        finally:
            dist.destroy_process_group()
            mesh.release_groups()
    reset_for_relaunch()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier", timeout_s: int = 600) -> None:
    """Host-level sync point across the group (no-op without one). The
    JAX package's signature; as there, ``name`` and ``timeout_s`` only
    label the call: the group's own timeout bounds the wait."""
    if dist.is_initialized():
        dist.barrier()


__all__ = [
    "ELASTIC_WORLD_ENV", "barrier", "initialize", "is_chief",
    "is_initialized", "process_count", "process_index",
    "reset_for_relaunch", "shutdown",
]
