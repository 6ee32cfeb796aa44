"""Host-side span tracer: nested named regions.

``with obs.span("decode"):`` times a block, as the JAX package's
``obs/spans.py`` does, and

- accrues the elapsed seconds into the registry as a
  ``span_seconds/<path>`` histogram (``<path>`` is the slash-joined
  nesting, e.g. ``decode/sample``) plus a ``span_calls/<path>`` counter,
- opens a ``torch.profiler.record_function`` of the same name, so the
  span shows on a torch profiler trace beside the card's kernels, and
- optionally attributes the seconds into a ``StepTimer``
  (``span(name, timer=t)`` calls ``t.attribute(name, seconds)``).

The seconds are the host clock's around the block: a block that enqueues
work on the card covers that work only if it ends in a synchronization
(the engine's decode span ends after the tokens are on the host). With
the registry disabled a span still times and attributes to its timer; the
registry and the trace record are skipped.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Optional

from . import registry as registry_mod

_tls = threading.local()


def span_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span() -> Optional[str]:
    """Slash-joined path of the innermost open span on this thread."""
    stack = span_stack()
    return "/".join(stack) if stack else None


class Span:
    """Yielded handle: ``seconds`` is filled when the block exits."""

    __slots__ = ("name", "path", "seconds")

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.seconds = 0.0


@contextlib.contextmanager
def span(name: str, *, timer=None, registry=None):
    """Time a named, nestable region (see the module docstring).

    ``timer``: a ``utils.profiler.StepTimer`` to attribute the seconds to
    (category ``name``, not the nested path). ``registry``: the target
    registry (default: the process-global one)."""
    stack = span_stack()
    stack.append(name)
    path = "/".join(stack)
    handle = Span(name, path)
    on = registry_mod.enabled()
    # torch is not imported here: a process without it (a controller)
    # runs no profiler for the record to show in.
    torch = sys.modules.get("torch")
    ctx = (torch.profiler.record_function(name) if on and torch is not None
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with ctx:
            yield handle
    finally:
        dt = time.perf_counter() - t0
        handle.seconds = dt
        stack.pop()
        if timer is not None:
            timer.attribute(name, dt)
        if on:
            reg = registry or registry_mod.default_registry()
            reg.observe(f"span_seconds/{path}", dt)
            reg.counter(f"span_calls/{path}")


__all__ = ["Span", "current_span", "span", "span_stack"]
