"""Chief-aware logging with a rank stamp, as the JAX package's
``utils/logging.py``: a standard ``logging`` logger whose stderr lines
carry `` r<i>/<n>`` in a gang of processes (nothing for a single
process), and an optional JSONL sink for structured events
(``set_jsonl``, ``event``). The rank comes from a live
``torch.distributed`` group, else the DTPU_CONFIG/TF_CONFIG cluster spec,
else (0, 1).

Free of ``torch`` at import (the supervisor and the launcher log through
it): a process group can be live only where ``torch.distributed`` was
imported, so the rank reads it from ``sys.modules``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional, Tuple


def rank_world() -> Tuple[int, int]:
    """(process_index, world_size): a live process group wins, else the
    env spec, else (0, 1). Cheap enough for per-log calls; never raises."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    for var in ("DTPU_CONFIG", "TF_CONFIG"):
        text = os.environ.get(var)
        if not text:
            continue
        try:
            obj = json.loads(text)
            workers = obj["cluster"]["worker"]
            return int(obj.get("task", {}).get("index", 0)), len(workers)
        except (ValueError, KeyError, TypeError, AttributeError):
            continue
    return 0, 1


class _RankFilter(logging.Filter):
    def filter(self, record):
        rank, world = rank_world()
        record.rankstamp = f" r{rank}/{world}" if world > 1 else ""
        return True


_logger = logging.getLogger(__name__)  # no parent of the other modules' loggers
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("[dtt %(asctime)s%(rankstamp)s] %(message)s",
                          "%H:%M:%S")
    )
    _h.addFilter(_RankFilter())
    _logger.addHandler(_h)
    _level = os.environ.get("DTPU_LOG_LEVEL", "INFO").upper()
    _logger.setLevel(_level if _level in logging._nameToLevel else "INFO")
    _logger.propagate = False


def info(msg: str):
    _logger.info(msg)


def warning(msg: str):
    _logger.warning(msg)


_jsonl_path: Optional[str] = None


def set_jsonl(path: Optional[str]):
    """Mirror events to a JSONL file (one object per event)."""
    global _jsonl_path
    _jsonl_path = path


def event(kind: str, **fields):
    """Emit a structured event (chief decides whether to call)."""
    if _jsonl_path:
        rank, world = rank_world()
        rec = {"ts": time.time(), "event": kind, "process_index": rank,
               "world_size": world, **fields}
        with open(_jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


__all__ = ["event", "info", "rank_world", "set_jsonl", "warning"]
