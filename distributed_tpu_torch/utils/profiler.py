"""Stall accounting and model-state bytes: the port's copies of the JAX
package's ``StepTimer``, ``tree_bytes_per_device`` and
``redundancy_report``
(``distributed_tpu/utils/profiler.py``; that module imports JAX, so only
these are copied here, and of the timer what the serving engine uses).

``tree_bytes_per_device`` measures live tensors: each rank counts the
bytes it holds (a sharded leaf's block, a replicated leaf whole), and the
ranks' counts are gathered, one per card.

Stall accounting: ``attribute(category, seconds)`` accrues wall time into
named buckets (the serving engine's ``queue_wait``, ``prefill``,
``decode`` and ``draft`` spans) and forwards each to the metrics registry
as a ``stall_seconds/<category>`` counter; ``stall_report()`` turns the
buckets into seconds and fractions of the timer's lifetime, with the
same keys as the JAX timer's. The seconds are the host clock's: a caller
that wants device work inside a bucket ends the timed block with a
synchronization.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from ..obs import registry as obs_registry


def _held_bytes(tree) -> int:
    """Bytes of the tensors in a nested dict/list/tuple tree (or an
    object with ``__slots__``, as the loss scale's state)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_held_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_held_bytes(v) for v in tree)
    slots = getattr(type(tree), "__slots__", None)
    if slots:
        return sum(_held_bytes(getattr(tree, k)) for k in slots)
    return 0


def tree_bytes_per_device(*trees) -> dict:
    """Per-card resident bytes of trees of live tensors, as the JAX
    ``tree_bytes_per_device``: this rank's bytes (a sharded leaf's block,
    a replicated leaf whole; host numbers skipped), gathered from every
    rank of the default process group when one is formed. Returns
    ``{"max_bytes_per_device", "total_bytes", "devices"}``."""
    mine = sum(_held_bytes(t) for t in trees)
    if not dist.is_initialized():
        return {"max_bytes_per_device": mine, "total_bytes": mine,
                "devices": 1}
    n = dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    per = torch.zeros(n, dtype=torch.int64, device=dev)
    per[dist.get_rank()] = mine
    dist.all_reduce(per, op=dist.ReduceOp.SUM)
    per = per.tolist()
    return {"max_bytes_per_device": int(max(per)),
            "total_bytes": int(sum(per)), "devices": n}


def redundancy_report(state_bytes: int, mirror_host_bytes: int,
                      world: Optional[int] = None) -> dict:
    """Price the buddy-redundancy tier's memory, measured not asserted:
    ``state_bytes`` is the model state this rank holds (its blocks where
    sharded) and ``mirror_host_bytes`` the bytes its store segment holds
    (its own shard's RAM copy + the ring buddy's mirror).
    ``overhead_ratio`` is (state + mirror) / state: about 1 + 1/N for 1/N
    ZeRO/FSDP shards, more for replicated strategies. Rides in
    ``model.last_fit_telemetry["redundancy"]`` when the tier is armed."""
    state = int(state_bytes)
    mirror = int(mirror_host_bytes)
    return {
        "state_bytes": state,
        "mirror_host_bytes": mirror,
        "overhead_ratio": (
            round((state + mirror) / state, 4) if state > 0 else None
        ),
        "world": int(world) if world is not None else None,
    }


class StepTimer:
    """Wall time attributed to named stall categories over the timer's
    lifetime."""

    def __init__(self):
        self.stalls = {}  # category -> accumulated seconds
        self._wall0 = time.perf_counter()

    def attribute(self, category: str, seconds: float):
        """Accrue ``seconds`` of wall time to ``category``, and to the
        registry's ``stall_seconds/<category>`` counter."""
        self.stalls[category] = self.stalls.get(category, 0.0) + float(seconds)
        if obs_registry.enabled():
            obs_registry.default_registry().counter(
                f"stall_seconds/{category}", seconds
            )

    def stall_report(self) -> dict:
        """Attributed seconds per category (``input_wait``, ``dispatch``
        and ``checkpoint_wait`` always present), the ``unattributed``
        remainder, each one's ``<category>_fraction`` of the timer's
        lifetime, ``total_seconds`` and ``input_stall_fraction``."""
        elapsed = max(time.perf_counter() - self._wall0, 1e-9)
        out = {}
        for cat in ("input_wait", "dispatch", "checkpoint_wait"):
            out[cat] = round(self.stalls.get(cat, 0.0), 6)
        for cat, secs in self.stalls.items():
            out[cat] = round(secs, 6)
        attributed = sum(out.values())
        out["unattributed"] = round(max(elapsed - attributed, 0.0), 6)
        for cat in list(out):
            out[f"{cat}_fraction"] = round(
                min(out[cat] / elapsed, 1.0), 6
            )
        out["total_seconds"] = round(elapsed, 6)
        out["input_stall_fraction"] = round(out["input_wait"] / elapsed, 6)
        return out


__all__ = ["StepTimer", "redundancy_report", "tree_bytes_per_device"]
