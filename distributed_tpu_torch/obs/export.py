"""Exporters: Prometheus text format + JSONL snapshot files.

The port's copy of the JAX package's ``obs/export.py``, over the port's
registry.

Two ways out of the registry, both built on the deterministic
:meth:`MetricsRegistry.snapshot`:

- :func:`prometheus_text` renders the standard text exposition format
  (``dtpu_``-prefixed, histograms as cumulative ``_bucket{le=...}`` +
  ``_sum``/``_count``) — paste behind any HTTP handler or textfile
  collector; :func:`write_prometheus` drops it to a file atomically
  enough for the node-exporter textfile pattern (tmp + rename).
- :func:`append_snapshot` appends ONE JSON line holding the full
  snapshot to a JSONL file — the same one-line-per-record shape as the
  event log, so ``read_events`` parses snapshot files too.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

from . import registry as registry_mod

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Registry names use ``/`` for nesting and ``.`` freely; Prometheus
    metric names allow ``[a-zA-Z0-9_:]`` — everything else becomes ``_``."""
    return "dtpu_" + _NAME_RE.sub("_", name)


def prometheus_text(snapshot: Optional[dict] = None, *, registry=None) -> str:
    """Render a snapshot (default: the global registry's, taken now) in
    the Prometheus text exposition format. Deterministic: sorted names,
    stable bucket order."""
    if snapshot is None:
        reg = registry or registry_mod.default_registry()
        snapshot = reg.snapshot()
    lines = []
    for name, value in snapshot.get("counters", {}).items():
        p = _prom_name(name)
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {value}")
    for name, value in snapshot.get("gauges", {}).items():
        p = _prom_name(name)
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {value}")
    for name, hist in snapshot.get("histograms", {}).items():
        p = _prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        cum = 0
        for bound, count in zip(hist["buckets"], hist["counts"]):
            cum += count
            lines.append(f'{p}_bucket{{le="{bound}"}} {cum}')
        cum += hist.get("overflow", 0)
        lines.append(f'{p}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{p}_sum {hist['sum']}")
        lines.append(f"{p}_count {hist['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path, *, registry=None) -> Path:
    """Write the current exposition to ``path`` via tmp+rename (the
    textfile-collector contract: scrapers never see a half-written
    file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(prometheus_text(registry=registry))
    os.replace(tmp, path)
    return path


def append_snapshot(path, *, registry=None, **extra) -> Path:
    """Append one full-snapshot JSON line (plus ``extra`` fields, e.g.
    ``step=``) to a JSONL file."""
    reg = registry or registry_mod.default_registry()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rec = {**reg.snapshot(), **extra}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


__all__ = ["append_snapshot", "prometheus_text", "write_prometheus"]
