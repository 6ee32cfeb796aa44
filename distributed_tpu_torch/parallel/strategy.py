"""Distribution strategies: ``SingleDevice`` and ``DataParallel``.

The counterpart of the JAX package's ``parallel/strategy.py``, with its
contract: a ``Model`` built inside ``strategy.scope()`` is distributed
(scope-wraps-construction), ``DataParallel()`` with no arguments takes the
topology from the environment, and ``MultiWorkerMirroredStrategy`` is its
alias.

The mechanism is PyTorch's, not GSPMD's: one process per card, joined by a
``torch.distributed`` process group (``cluster.initialize`` forms it from
``DTPU_CONFIG``/``TF_CONFIG``; NCCL on the card, gloo on the CPU). Every
rank builds the same parameters from the same seed, takes the same global
batch indices and keeps its own rows of them (the JAX package's row
sharding), and averages the gradients with one all-reduce per dtype
before the optimizer, so the replicas stay bit-identical.
BatchNorm is sync-BN, as GSPMD makes it in the JAX package: a layer that
needs statistics over the global batch finds the strategy its train step
runs under (``current_strategy()``; ``Model.fit`` enters the model's
``scope()`` for each step) and calls ``all_reduce_sum``/``broadcast``,
which are collectives under ``DataParallel`` and do nothing under
``SingleDevice``.
``torch.nn.parallel.DistributedDataParallel`` is not used: its reducer
hooks ``.grad`` accumulation, which the port's ``torch.autograd.grad``
step never does. ``DataParallel()`` outside a process group forms a
world-1 group on its device, so the all-reduce is one code path whatever
the number of ranks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

_local = threading.local()


def current_strategy() -> Optional["Strategy"]:
    return getattr(_local, "strategy", None)


def _comm_row(gathered=0, grad=0) -> dict:
    """The JAX package's ``comm_bytes_estimate`` schema: the parameter
    gather, the gradient reduce, and the per-token activation and
    pipeline traffic that no port strategy has yet."""
    return {
        "gathered_param_bytes_per_device": int(gathered),
        "grad_reduce_bytes_per_device": int(grad),
        "activation_reduce_bytes_per_token_per_device": 0,
        "pipeline_hop_bytes_per_token_per_device": 0,
    }


class Strategy:
    """Base strategy: one replica on ``self.device``, nothing to reduce."""

    device: torch.device

    @property
    def num_replicas_in_sync(self) -> int:
        return 1

    @contextlib.contextmanager
    def scope(self):
        prev = current_strategy()
        _local.strategy = self
        try:
            yield self
        finally:
            _local.strategy = prev

    def local_batch_size(self, global_batch: int) -> int:
        return global_batch

    def row_range(self, global_batch: int):
        """(start, stop): this replica's rows of a global batch, rows
        ``[r*b/P, (r+1)*b/P)`` for rank r of P, the JAX package's row
        sharding."""
        lb = self.local_batch_size(global_batch)
        start = self._rank() * lb
        return start, start + lb

    def _rank(self) -> int:
        return 0

    def reduce_gradients(self, grads: Sequence[torch.Tensor]):
        """The gradients averaged over the replicas (as they are here)."""
        return grads

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the replicas, in place (as it is here)."""
        return t

    def comm_bytes_estimate(self, params) -> dict:
        """The JAX strategies' per-step, per-device collective estimate
        (``last_fit_telemetry["comm_bytes_estimate"]``), with the same
        keys: one replica moves nothing."""
        return _comm_row()

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` replaced in place by replica ``src``'s (as it is here)."""
        return t


class SingleDevice(Strategy):
    """No distribution: the model on one device (``None``: the card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)


def _cuda_for_rank(device: torch.device) -> torch.device:
    """A CUDA device with an index: the current device, which
    ``cluster.initialize`` sets to this rank's card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DataParallel(Strategy):
    """Synchronous all-reduce data parallelism over the default process
    group: parameters replicated, the global batch split across the
    ranks, the gradients averaged every step.

    ``device=None`` is this rank's card (it raises without one); pass
    ``device="cpu"`` for a gloo group on the CPU. Without a process group
    it forms one of world size 1 on ``device`` (NCCL on the card, gloo on
    the CPU)."""

    def __init__(self, device=None):
        self.device = _cuda_for_rank(resolve_device(device))
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if not dist.is_initialized():
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        elif dist.get_backend() != backend:
            raise ValueError(
                f"DataParallel on {self.device} needs a {backend} process "
                f"group; the default group is {dist.get_backend()}")

    @property
    def num_replicas_in_sync(self) -> int:
        return dist.get_world_size()

    def _rank(self) -> int:
        return dist.get_rank()

    def local_batch_size(self, global_batch: int) -> int:
        n = self.num_replicas_in_sync
        if global_batch % n:
            raise ValueError(
                f"Global batch {global_batch} not divisible by {n} replicas"
            )
        return global_batch // n

    def reduce_gradients(self, grads: Sequence[torch.Tensor]):
        """Sum over the ranks, divided by their number: one flat bucket per
        dtype, one all-reduce each; the gradients come back as views of
        the buckets."""
        n = self.num_replicas_in_sync
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            groups.setdefault(g.dtype, []).append(i)
        for idxs in groups.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idxs])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat.div_(n)
            pieces = flat.split([grads[i].numel() for i in idxs])
            for i, piece in zip(idxs, pieces):
                out[i] = piece.view(grads[i].shape)
        return out

    def comm_bytes_estimate(self, params) -> dict:
        # One gradient all-reduce of the whole parameter tree a step.
        return _comm_row(grad=sum(p.numel() * p.element_size()
                                  for p in params.values()))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src)
        return t


# The reference's name for the same strategy.
MultiWorkerMirroredStrategy = DataParallel


__all__ = [
    "DataParallel", "MultiWorkerMirroredStrategy", "SingleDevice", "Strategy",
    "current_strategy",
]
