"""Resume markers + the preemption exit code: the supervisor's half of the
preemption contract.

The port's copy of the JAX package's ``resilience/markers.py``, with its
file format (either package reads the other's marker). Split out of
``preemption.py`` so the supervisor's controller process needs only
:data:`PREEMPTED_EXIT_CODE` and the marker I/O, not the worker side's
callback and checkpointer.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

# EX_TEMPFAIL: "try again later" — distinct from any crash code, so the
# supervisor can tell a clean preemption from a real failure.
PREEMPTED_EXIT_CODE = 75

RESUME_MARKER = "resume-marker.json"


def marker_path(directory) -> Path:
    return Path(directory) / RESUME_MARKER


def _atomic_write_text(path: Path, payload: str) -> None:
    # A twin of checkpoint.core._atomic_write that writes text: fsync
    # BEFORE the rename — os.replace is atomic
    # in the namespace but not durable, and a torn marker surfacing under
    # the real name would cost the restart a corrupt-skip.
    tmp_fd, tmp_name = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(tmp_fd, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_name, path)
    finally:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)


def write_resume_marker(directory, step: int,
                        reason: str = "preempted") -> Path:
    """Atomically record "this run stopped resumably at ``step``"."""
    path = marker_path(directory)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = json.dumps(
        {"step": int(step), "reason": reason, "ts": time.time()}
    )
    _atomic_write_text(path, payload)
    return path


def read_resume_marker(directory) -> Optional[dict]:
    """The marker dict, or None when absent/corrupt (a torn marker must
    never block a restart — the checkpoint latest-pointer is the real
    resume source; the marker is intent metadata)."""
    try:
        rec = json.loads(marker_path(directory).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) and "step" in rec else None


def clear_resume_marker(directory) -> None:
    try:
        marker_path(directory).unlink()
    except OSError:
        pass


__all__ = [
    "PREEMPTED_EXIT_CODE",
    "RESUME_MARKER",
    "clear_resume_marker",
    "marker_path",
    "read_resume_marker",
    "write_resume_marker",
]
