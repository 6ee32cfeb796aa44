"""Host utilities of the port: rank-stamped logging, replica checks, the
event log and its schema, the step timer, and JAX's Threefry random bits."""

from . import event_schema, events, logging, profiler, sync_check, threefry

__all__ = ["event_schema", "events", "logging", "profiler", "sync_check",
           "threefry"]
