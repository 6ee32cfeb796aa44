"""Host utilities of the port: rank-stamped logging, replica checks."""

from . import logging, sync_check

__all__ = ["logging", "sync_check"]
