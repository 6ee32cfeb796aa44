"""Cross-rank aggregation + straggler attribution.

The port's copy of the JAX package's ``obs/aggregate.py`` (plain event
math), so a supervisor of either package names the same straggler from
the same event stream.

A synchronous gang runs at the speed of its SLOWEST rank: one worker on a
degraded host drags every peer's step time up, and per-process telemetry
cannot see it — every rank reports the same (slow) rate, because the
collective serializes them. What CAN see it is the per-rank *host-side*
step timings before the collective equalizes them.

Transport: workers flush compact ``metrics_snapshot`` events into the
existing ``DTPU_EVENT_LOG`` file (``Model.fit`` does this every
``DTPU_OBS_FLUSH_EVERY`` steps — the event log is already the
supervisor<->worker channel, and ``emit`` is a no-op unsupervised). Each
snapshot carries the rank's recent per-step wall seconds.

Which signal: per-step *wall* time is equalized across a synchronous gang
by the collectives themselves — the victims spend the skew WAITING (their
``dispatch`` stall bucket), the straggler spends it WORKING — so the
aggregation keys on ``self_seconds`` (wall minus dispatch/input waits,
the rank's own host time; ``Model.fit`` flushes both) and falls back to
``step_seconds`` for streams that predate the field.

Chief side: :func:`skew_report` computes per-rank step-time stats and the
max/median skew; :func:`straggler` names the slowest rank when its median
step time exceeds the gang median by a threshold. The supervisor runs
both at every terminal boundary and emits ``rank_skew`` (always, when
snapshots exist) and ``straggler`` (when one is detected) events.

Aggregation runs on the supervisor's controller process; it reads
events only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..utils import event_schema as evs

DEFAULT_THRESHOLD = 1.5


def _median(values: Sequence[float]) -> Optional[float]:
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return float(vals[mid])
    return float((vals[mid - 1] + vals[mid]) / 2.0)


def snapshots(events: Sequence[dict]) -> List[dict]:
    """The ``metrics_snapshot`` records of an event stream, in order."""
    return [e for e in events if e.get("event") == evs.METRICS_SNAPSHOT]


def rank_step_seconds(events: Sequence[dict]) -> dict:
    """Per-rank concatenated per-step samples from every snapshot flush:
    ``{rank: [seconds, ...]}``. Prefers each snapshot's ``self_seconds``
    (host self time — see module docstring) over ``step_seconds``."""
    per: dict = {}
    for snap in snapshots(events):
        rank = snap.get("rank")
        if rank is None:
            continue
        samples = snap.get("self_seconds") or snap.get("step_seconds", ())
        per.setdefault(int(rank), []).extend(float(s) for s in samples)
    return per


def skew_report(events: Sequence[dict]) -> Optional[dict]:
    """Per-rank min/median/max step seconds plus the cross-rank skew:
    ``skew = rank_median / gang_median`` (gang median = median of the
    per-rank medians — robust to one bad rank, which is the point).
    None when the stream holds no snapshots (unsupervised or pre-obs
    logs)."""
    per = rank_step_seconds(events)
    per = {r: v for r, v in per.items() if v}
    if not per:
        return None
    rank_rows = []
    medians = {}
    for rank in sorted(per):
        vals = per[rank]
        med = _median(vals)
        medians[rank] = med
        rank_rows.append({
            "rank": rank,
            "samples": len(vals),
            "min_step_s": round(min(vals), 6),
            "median_step_s": round(med, 6),
            "max_step_s": round(max(vals), 6),
        })
    gang_median = _median(list(medians.values()))
    for row in rank_rows:
        row["skew"] = (
            round(row["median_step_s"] / gang_median, 4)
            if gang_median else None
        )
    slowest = max(rank_rows, key=lambda r: r["median_step_s"])
    return {
        "ranks": rank_rows,
        "world": len(rank_rows),
        "gang_median_step_s": round(gang_median, 6) if gang_median else None,
        "max_skew": slowest["skew"],
        "slowest_rank": slowest["rank"],
    }


def straggler(events: Sequence[dict],
              threshold: float = DEFAULT_THRESHOLD) -> Optional[dict]:
    """The straggler verdict: the slowest rank, when its median step time
    exceeds the gang median by ``threshold`` AND there are >= 2 ranks to
    compare (a single process cannot straggle relative to itself).
    Returns the row the supervisor emits as a ``straggler`` event, or
    None."""
    report = skew_report(events)
    if report is None or report["world"] < 2:
        return None
    if report["max_skew"] is None or report["max_skew"] < float(threshold):
        return None
    row = next(r for r in report["ranks"]
               if r["rank"] == report["slowest_rank"])
    return {
        "rank": report["slowest_rank"],
        "skew": report["max_skew"],
        "median_step_s": row["median_step_s"],
        "gang_median_step_s": report["gang_median_step_s"],
        "threshold": float(threshold),
        "world": report["world"],
    }


__all__ = [
    "DEFAULT_THRESHOLD",
    "rank_step_seconds",
    "skew_report",
    "snapshots",
    "straggler",
]
