"""Checkpoints and model export, file-compatible with the JAX package."""

from .core import (
    Checkpointer,
    artifact_decode,
    artifact_encode,
    export_hdf5,
    import_hdf5,
    load_npz,
    save_npz,
    wait_all_async,
)
from .sharded import ShardCorruptionError, ShardedCheckpointer

__all__ = [
    "Checkpointer",
    "ShardCorruptionError",
    "ShardedCheckpointer",
    "artifact_decode",
    "artifact_encode",
    "export_hdf5",
    "import_hdf5",
    "load_npz",
    "save_npz",
    "wait_all_async",
]
