"""Distribution strategies of the port (``strategy.py``), the collectives
of a sharded leaf (``collectives.py``), device meshes (``mesh.py``) and
the auto-shard planner (``auto_shard.py``)."""

from . import auto_shard, collectives, mesh
from .auto_shard import Candidate, Feasibility, Plan, plan_sharding
from .mesh import AXES, batch_sharding, make_mesh, replicated
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
    "AXES",
    "Candidate",
    "CompositeParallel",
    "DataExpertParallel",
    "DataParallel",
    "DataPipelineParallel",
    "DataSeqParallel",
    "DataTensorParallel",
    "FSDP",
    "Feasibility",
    "FullyShardedDataParallel",
    "MultiWorkerMirroredStrategy",
    "Plan",
    "SingleDevice",
    "Strategy",
    "ZeroDataParallel",
    "auto_shard",
    "batch_sharding",
    "collectives",
    "current_strategy",
    "make_mesh",
    "mesh",
    "plan_sharding",
    "replicated",
]
