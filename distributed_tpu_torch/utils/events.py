"""Structured event log (JSONL, crash-visible), as the JAX package's
``utils/events.py``.

Events go to one append-only JSONL file named by ``DTPU_EVENT_LOG`` (the
same variable the JAX package reads, so both packages' events can land in
one file); without it ``emit`` does nothing. Every record is one
``write()`` on a cached ``O_APPEND`` handle, then flush and ``fsync``; the
handle is reopened when the file was rotated or removed. A torn final line
is skipped on read. Record fields follow ``utils.event_schema``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

ENV_VAR = "DTPU_EVENT_LOG"


class EventLog:
    """Append-only JSONL event sink with durability per record."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = None
        self._ino = None
        self._lock = threading.Lock()

    def _file(self):
        """The cached append handle, reopened when the path was rotated
        away or removed."""
        if self._f is not None:
            try:
                if os.stat(self.path).st_ino == self._ino:
                    return self._f
            except OSError:
                pass  # ENOENT: unlinked or renamed, reopen below
            self._close_handle()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._ino = os.fstat(self._f.fileno()).st_ino
        return self._f

    def _close_handle(self):
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
            self._ino = None

    def emit(self, kind: str, **fields) -> dict:
        rec = {"ts": time.time(), "event": kind, "pid": os.getpid(), **fields}
        with self._lock:
            f = self._file()
            f.write(json.dumps(rec) + "\n")  # one write: whole lines only
            f.flush()
            os.fsync(f.fileno())
        return rec

    def close(self):
        with self._lock:
            self._close_handle()

    def read(self) -> List[dict]:
        return read_events(self.path)


def read_events(path) -> List[dict]:
    """All well-formed records, in order; a torn trailing line is
    dropped."""
    out: List[dict] = []
    try:
        text = Path(path).read_text()
    except OSError:
        return out
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


_ambient: Optional[EventLog] = None


def default_log() -> Optional[EventLog]:
    """The ambient event log: ``$DTPU_EVENT_LOG``, else None. The variable
    is read on each call; the ``EventLog`` is kept while the path is the
    same."""
    global _ambient
    path = os.environ.get(ENV_VAR)
    if not path:
        return None
    if _ambient is None or str(_ambient.path) != path:
        if _ambient is not None:
            _ambient.close()
        _ambient = EventLog(path)
    return _ambient


def emit(kind: str, **fields) -> Optional[dict]:
    """Emit to the ambient log; None when there is none. An I/O error is
    swallowed: the event log is observability, not control flow."""
    log = default_log()
    if log is None:
        return None
    try:
        return log.emit(kind, **fields)
    except OSError:
        return None


__all__ = ["ENV_VAR", "EventLog", "default_log", "emit", "read_events"]
