"""Observability of the port: the metrics registry and host-side spans.

The port's own copies of the JAX package's JAX-free ``obs/registry.py``
and ``obs/spans.py``, cut to what the serving engine and its tests use:
``default_registry`` (counters, gauges, histograms, per-step rings and the
stored ``last_run_telemetry`` report) and ``span(name, timer=)``. The JAX
package's flight recorder, exporters, cross-rank aggregation and CLI are
not ported yet.
"""

from __future__ import annotations

from . import registry, spans
from .registry import MetricsRegistry, default_registry, enabled, set_enabled
from .spans import Span, current_span, span

__all__ = [
    "MetricsRegistry", "Span", "current_span", "default_registry",
    "enabled", "registry", "set_enabled", "span", "spans",
]
