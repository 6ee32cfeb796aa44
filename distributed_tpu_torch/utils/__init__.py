"""Host utilities of the port: rank-stamped logging, replica checks, the
event log and its schema, the step timer and profiler hooks, tree sizes,
and JAX's Threefry random bits."""

from . import event_schema, events, logging, profiler, sync_check, threefry, tree
from .sync_check import assert_replicas_identical, replica_drift

__all__ = ["assert_replicas_identical", "event_schema", "events", "logging",
           "profiler", "replica_drift", "sync_check", "threefry", "tree"]
