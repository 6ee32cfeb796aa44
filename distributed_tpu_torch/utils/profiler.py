"""Profiling hooks, the step timer and model-state bytes: the port's
counterparts of the JAX package's ``utils/profiler.py``.

``trace`` captures a ``torch.profiler`` trace of a block (the card's
kernels beside the host's calls, written for TensorBoard), ``annotate``
names a region on it (``record_function``), and ``device_memory_stats``
reads the card's allocator (None on the CPU, as JAX returns None on a
backend without an instrumented allocator).

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

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..obs import registry as obs_registry
from . import logging as dlog


@contextlib.contextmanager
def trace(logdir: str, *, chief_only: bool = True):
    """Capture a profiler trace for the duration of the block, into
    ``logdir`` (one ``*.pt.trace.json`` a capture; TensorBoard's profile
    plugin and chrome://tracing read it). With ``chief_only``, ranks
    other than 0 run the block untraced, so a gang writes one trace.

        with dtt.utils.profiler.trace("/tmp/trace"):
            model.fit(...)
    """
    if chief_only and dlog.rank_world()[0] != 0:
        yield
        return
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))):
        yield
        if cuda:
            # The card's work launched in the block ends inside the capture.
            torch.cuda.synchronize()


def annotate(name: str):
    """Named region that shows on the trace's timeline (host, and the
    card's work launched inside it)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None):
    """Allocator stats of one card as ``{bytes_in_use, peak_bytes_in_use,
    bytes_limit}``: how close to the card's memory a ZeRO/FSDP run sits.
    ``device``: a CUDA device (default: the current one). None for a CPU
    device or without a card: the CPU has no instrumented allocator (use
    :func:`tree_bytes_per_device` for the model-state share there)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
    }


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
    """Steps/sec with the warmup steps excluded, and wall time attributed
    to named stall categories over the timer's lifetime."""

    def __init__(self, warmup: int = 1):
        self.warmup = int(warmup)
        self.steps = 0
        self._t0 = None
        self._measured_from = 0  # step count when the clock started
        self.stalls = {}  # category -> accumulated seconds
        self._wall0 = time.perf_counter()

    def tick(self, steps: int = 1):
        """Count ``steps`` completed optimizer steps (``steps=K`` for one
        dispatch of K steps). The clock starts at the first tick that
        reaches ``warmup``; the steps up to it are not in the rate."""
        self.steps += int(steps)
        if self._t0 is None and self.steps >= self.warmup:
            self._t0 = time.perf_counter()
            self._measured_from = self.steps

    @property
    def steps_per_sec(self) -> float:
        counted = self.steps - self._measured_from
        if self._t0 is None or counted <= 0:
            return 0.0
        return counted / (time.perf_counter() - self._t0)

    def report(self, **extra):
        """The rate; on rank 0 also a ``step_rate`` event and a log line."""
        rate = self.steps_per_sec
        if dlog.rank_world()[0] == 0:
            dlog.event("step_rate", steps_per_sec=rate, steps=self.steps,
                       **extra)
            dlog.info(f"{rate:.2f} steps/s over "
                      f"{self.steps - self._measured_from} steps")
        return rate

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


__all__ = ["StepTimer", "annotate", "device_memory_stats",
           "redundancy_report", "trace", "tree_bytes_per_device"]
