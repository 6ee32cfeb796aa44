"""Distribution strategies of the port (``strategy.py``)."""

from .strategy import (
    DataParallel,
    MultiWorkerMirroredStrategy,
    SingleDevice,
    Strategy,
    current_strategy,
)

__all__ = [
    "DataParallel",
    "MultiWorkerMirroredStrategy",
    "SingleDevice",
    "Strategy",
    "current_strategy",
]
