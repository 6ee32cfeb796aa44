"""Flight recorder: the last N per-step records, dumped at death.

The port's copy of the JAX package's ``obs/flight.py`` (which imports no
JAX), with the same dump format, so either package's reader reads the
other's dumps.

The JSONL event log (``utils.events``) records LIFECYCLE facts — restarts,
preemptions, restores. What a postmortem actually needs first is the
seconds *before* death: was the step rate degrading, was input stalling,
which step was in flight. The flight recorder is that black box — a
bounded in-memory ring of small per-step records (``Model.fit`` appends
one per dispatch; custom loops can append their own) that costs one deque
append per step while alive, and is dumped to a fsync'd JSONL file on the
paths where a process is about to die:

- ``PreemptionHandler`` before its exit-75,
- ``FaultInjector`` kills before their ``os._exit`` (every injected crash
  leaves a readable dump),
- ``Model.fit``'s unhandled-exception path.

Dumps land next to the supervisor's event log (``$DTPU_FLIGHT_DIR``, or
the ``DTPU_EVENT_LOG`` directory) as ``flight-rank<r>-pid<p>.jsonl``, and
every dump emits a ``flight_dump`` event into the event log so
``Supervisor.recovery_rows`` / ``dtpu-events`` can reference the file
from the recovery postmortem. The dump file reuses the event-log
durability idiom: whole JSON lines, flushed and fsync'd, with a torn
final line skipped on read (``utils.events.read_events`` reads dumps
too — same skip-torn-tail property).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils.logging import rank_world
from . import registry as registry_mod

ENV_DIR = "DTPU_FLIGHT_DIR"

DEFAULT_CAPACITY = 128


class FlightRecorder:
    """Bounded ring of per-step records; ``dump()`` writes them durably."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, kind: str, **fields) -> None:
        """Append one record (no-op when observability is disabled). Keep
        records small and host-side only — never fetch a device value to
        record it (that would put a sync on the step path)."""
        if not registry_mod.enabled():
            return
        rec = {"ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, path=None, *, reason: str = "", extra: Optional[dict] = None
             ) -> Optional[Path]:
        """Write a header line + every ring record to ``path`` (default:
        :func:`default_dump_path`), fsync'd, then emit a ``flight_dump``
        event referencing it. Returns the path, or None when no dump
        location is configured (unsupervised, no ``DTPU_FLIGHT_DIR``).
        Overwrites a previous dump at the same path — the latest death
        wins, and the per-rank-per-pid filename keeps gangs separate."""
        if path is None:
            path = default_dump_path()
            if path is None:
                return None
        path = Path(path)
        rank, world = rank_world()
        records = self.snapshot()
        header = {
            "ts": time.time(),
            "kind": "flight_header",
            "reason": reason,
            "pid": os.getpid(),
            "rank": rank,
            "world": world,
            "records": len(records),
            "capacity": self.capacity,
            **(extra or {}),
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in [header] + records))
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        events_lib.emit(
            evs.FLIGHT_DUMP, path=str(path), reason=reason, rank=rank,
            records=len(records),
            attempt=_int_env("DTPU_ATTEMPT"),
        )
        return path


def _int_env(name: str) -> Optional[int]:
    val = os.environ.get(name)
    try:
        return int(val) if val else None
    except ValueError:
        return None


def default_dump_path() -> Optional[Path]:
    """``$DTPU_FLIGHT_DIR/flight-rank<r>-pid<p>.jsonl``, falling back to
    the ``DTPU_EVENT_LOG`` directory (the supervisor's transport — so a
    supervised gang gets flight dumps with zero extra configuration), or
    None when neither is set (unsupervised runs pay nothing)."""
    base = os.environ.get(ENV_DIR)
    if not base:
        log = os.environ.get(events_lib.ENV_VAR)
        if not log:
            return None
        base = str(Path(log).parent)
    rank, _ = rank_world()
    return Path(base) / f"flight-rank{rank}-pid{os.getpid()}.jsonl"


def read_dump(path) -> List[dict]:
    """All well-formed records of a dump, torn final line skipped — the
    same read the event log uses (a crash mid-dump must never make the
    postmortem unreadable)."""
    return events_lib.read_events(path)


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-global recorder ``Model.fit`` and the death paths use."""
    return _default


def dump(reason: str = "", **extra) -> Optional[Path]:
    """Dump the global recorder; never raises (a failed dump must not
    change how a process dies)."""
    try:
        return _default.dump(reason=reason, extra=extra or None)
    except Exception:
        return None


__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "default_dump_path",
    "default_recorder",
    "dump",
    "read_dump",
]
