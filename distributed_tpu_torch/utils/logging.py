"""Chief-aware logging with a rank stamp.

From the JAX package's ``utils/logging.py``, cut to what the port's
bootstrap uses: a standard ``logging`` logger whose stderr
lines carry `` r<i>/<n>`` in a gang of processes (nothing for a single
process). The rank comes from a live ``torch.distributed`` group, else the
DTPU_CONFIG/TF_CONFIG cluster spec, else (0, 1).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Tuple

import torch.distributed as dist


def rank_world() -> Tuple[int, int]:
    """(process_index, world_size): a live process group wins, else the
    env spec, else (0, 1). Cheap enough for per-log calls; never raises."""
    if dist.is_initialized():
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


__all__ = ["info", "rank_world"]
