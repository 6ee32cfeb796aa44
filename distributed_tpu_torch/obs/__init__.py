"""Observability of the port.

The port's copies of the JAX package's JAX-free ``obs/`` modules:

- :mod:`~distributed_tpu_torch.obs.registry`: counters, gauges,
  fixed-bucket histograms, bounded per-step rings, and the stored
  ``last_*_telemetry`` reports (``set_report``/``get_report``).
- :mod:`~distributed_tpu_torch.obs.spans`: nested host-side spans
  (``obs.span("prefill")``) that accrue into the registry and forward to
  ``torch.profiler.record_function``, with the ``StepTimer`` stall
  attribution.
- :mod:`~distributed_tpu_torch.obs.flight`: a bounded ring of the last N
  per-step records, dumped (fsynced JSONL) on preemption, injected
  kills and unhandled exceptions of the fit loop.
- :mod:`~distributed_tpu_torch.obs.aggregate`: cross-rank skew and the
  straggler, from the ``metrics_snapshot`` events the workers flush into
  ``DTPU_EVENT_LOG``; the supervisor names the slowest rank.
- :mod:`~distributed_tpu_torch.obs.export`: Prometheus text format and
  JSONL snapshot files.
- :mod:`~distributed_tpu_torch.obs.cli`: the postmortem CLI
  (``python -m distributed_tpu_torch.obs.cli``, ``dtt-events``).
"""

from __future__ import annotations

from . import aggregate, export, flight, registry, spans
from .flight import FlightRecorder, default_recorder, dump as dump_flight
from .registry import MetricsRegistry, default_registry, enabled, set_enabled
from .spans import Span, current_span, span

__all__ = [
    "FlightRecorder", "MetricsRegistry", "Span", "aggregate",
    "current_span", "default_recorder", "default_registry", "dump_flight",
    "enabled", "export", "flight", "registry", "set_enabled", "span",
    "spans",
]
