"""Stall accounting: the port's copy of the JAX package's ``StepTimer``
(``distributed_tpu/utils/profiler.py``; that module imports JAX, so only
the class is copied here, and of it what the serving engine uses).

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

from ..obs import registry as obs_registry


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


__all__ = ["StepTimer"]
