"""Host utilities of the port: rank-stamped logging, replica checks, the
event log and its schema, and the step timer."""

from . import event_schema, events, logging, profiler, sync_check

__all__ = ["event_schema", "events", "logging", "profiler", "sync_check"]
