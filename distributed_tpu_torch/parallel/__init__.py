"""Distribution strategies of the port (``strategy.py``), the collectives
of a sharded leaf (``collectives.py``) and device meshes (``mesh.py``)."""

from . import collectives, mesh
from .mesh import batch_sharding, make_mesh, replicated
from .strategy import (
    FSDP,
    CompositeParallel,
    DataExpertParallel,
    DataParallel,
    DataPipelineParallel,
    DataSeqParallel,
    DataTensorParallel,
    FullyShardedDataParallel,
    MultiWorkerMirroredStrategy,
    SingleDevice,
    Strategy,
    ZeroDataParallel,
    current_strategy,
)

__all__ = [
    "CompositeParallel",
    "DataExpertParallel",
    "DataParallel",
    "DataPipelineParallel",
    "DataSeqParallel",
    "DataTensorParallel",
    "FSDP",
    "FullyShardedDataParallel",
    "MultiWorkerMirroredStrategy",
    "SingleDevice",
    "Strategy",
    "ZeroDataParallel",
    "batch_sharding",
    "collectives",
    "current_strategy",
    "make_mesh",
    "mesh",
    "replicated",
]
