"""Gang launcher (``python -m distributed_tpu_torch.launch``): local and
ssh workers, heartbeat liveness and the restart loop."""

from .core import (
    LocalLauncher,
    SSHLauncher,
    WorkerResult,
    heartbeat,
    launch_local,
    report_result,
    run_with_restart,
)

__all__ = [
    "LocalLauncher",
    "SSHLauncher",
    "WorkerResult",
    "heartbeat",
    "launch_local",
    "report_result",
    "run_with_restart",
]
