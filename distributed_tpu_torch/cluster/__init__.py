"""Cluster spec (``DTPU_CONFIG``/``TF_CONFIG``) and the process group."""

from .config import ClusterSpec, from_barrier, from_env, resolve
from .init import (
    ELASTIC_WORLD_ENV,
    barrier,
    initialize,
    is_chief,
    is_initialized,
    process_count,
    process_index,
    reset_for_relaunch,
    shutdown,
)
from .net import check_reachable, free_port, my_ip, preflight

__all__ = [
    "ClusterSpec",
    "ELASTIC_WORLD_ENV",
    "from_env",
    "from_barrier",
    "resolve",
    "initialize",
    "is_initialized",
    "shutdown",
    "reset_for_relaunch",
    "is_chief",
    "barrier",
    "process_index",
    "process_count",
    "my_ip",
    "free_port",
    "check_reachable",
    "preflight",
]
