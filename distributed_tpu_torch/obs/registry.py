"""Metrics registry: counters, gauges, histograms, per-step rings.

One process-global :class:`MetricsRegistry` (``default_registry()``) that
the serving engine publishes into, as the JAX package's
``obs/registry.py``: the ``last_run_telemetry`` dict is a view stored here
(:meth:`MetricsRegistry.set_report`), the same object the engine hands
back. Every mutator is a dict update under one lock, and
``set_enabled(False)`` (or ``DTPU_OBS=0``) turns them into no-ops;
reports are stored either way. :meth:`snapshot` sorts every section, so
the same run gives the same key sequence.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

ENABLE_ENV = "DTPU_OBS"

# Seconds-scale latency buckets, the JAX package's: from a ~1 ms dispatch
# to a ~10 s restore.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0)

DEFAULT_RING_SIZE = 256

_enabled = os.environ.get(ENABLE_ENV, "1") != "0"


def enabled() -> bool:
    """Whether the registry (and with it the spans) records anything."""
    return _enabled


def set_enabled(value: bool) -> bool:
    """Turn recording on or off; returns the previous setting."""
    global _enabled
    prev = _enabled
    _enabled = bool(value)
    return prev


class Histogram:
    """Fixed-bucket histogram: counts per upper bound plus an overflow
    bucket, a running sum and a count."""

    __slots__ = ("buckets", "counts", "overflow", "sum", "count")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * len(self.buckets)
        self.overflow = 0
        self.sum = 0.0
        self.count = 0

    def record(self, value: float):
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.overflow += 1

    def snapshot(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "overflow": self.overflow,
            "sum": round(self.sum, 6),
            "count": self.count,
        }


class MetricsRegistry:
    """Counters, gauges, fixed-bucket histograms, bounded per-step rings,
    and stored structured reports. Thread-safe."""

    def __init__(self, ring_size: int = DEFAULT_RING_SIZE):
        self.ring_size = int(ring_size)
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._rings: Dict[str, collections.deque] = {}
        self._reports: Dict[str, dict] = {}

    # ------------------------------------------------------------- mutators
    def counter(self, name: str, inc: float = 1.0) -> None:
        """Monotonic accumulator (counts, seconds, bytes)."""
        if not _enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + float(inc)

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins reading (queue depth, utilization)."""
        if not _enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float, buckets=None) -> None:
        """Record one sample into the named fixed-bucket histogram."""
        if not _enabled:
            return
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = Histogram(buckets or DEFAULT_BUCKETS)
                self._histograms[name] = hist
            hist.record(value)

    def ring_append(self, name: str, record: dict) -> None:
        """Append to the named bounded ring (newest last; the oldest
        record falls off past ``ring_size``)."""
        if not _enabled:
            return
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                ring = collections.deque(maxlen=self.ring_size)
                self._rings[name] = ring
            ring.append(dict(record))

    def set_report(self, name: str, report: dict) -> dict:
        """Store a structured telemetry view and return the STORED object,
        so the caller's attribute and the registry hold the same dict.
        Stored even when disabled."""
        with self._lock:
            self._reports[name] = report
        return report

    # -------------------------------------------------------------- readers
    def get_report(self, name: str) -> Optional[dict]:
        with self._lock:
            return self._reports.get(name)

    def ring(self, name: str) -> List[dict]:
        with self._lock:
            ring = self._rings.get(name)
            return [dict(r) for r in ring] if ring is not None else []

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge_value(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def snapshot(self) -> dict:
        """Every section, sorted by name."""
        with self._lock:
            return {
                "ts": time.time(),
                "counters": {
                    k: round(self._counters[k], 6)
                    for k in sorted(self._counters)
                },
                "gauges": {
                    k: round(self._gauges[k], 6) for k in sorted(self._gauges)
                },
                "histograms": {
                    k: self._histograms[k].snapshot()
                    for k in sorted(self._histograms)
                },
                "rings": {
                    k: [dict(r) for r in self._rings[k]]
                    for k in sorted(self._rings)
                },
                "reports": {k: self._reports[k] for k in sorted(self._reports)},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._rings.clear()
            self._reports.clear()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry every producer publishes to."""
    return _default


__all__ = [
    "DEFAULT_BUCKETS", "Histogram", "MetricsRegistry", "default_registry",
    "enabled", "set_enabled",
]
