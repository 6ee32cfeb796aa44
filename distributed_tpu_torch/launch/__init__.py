"""Local gang launcher (``python -m distributed_tpu_torch.launch``)."""

from .core import (
    LocalLauncher,
    WorkerResult,
    launch_local,
    report_result,
)

__all__ = [
    "LocalLauncher",
    "WorkerResult",
    "launch_local",
    "report_result",
]
