"""Declared schema of the events the port emits (``utils.events``).

The port's copy of the rows of the JAX package's ``utils/event_schema.py``
for the events it emits (the serving engine and its KV pool, the
checkpointer, the fit loop and its callbacks, the supervisor, the fault
injector, the preemption handler, the buddy-redundancy tier, the flight
recorder, the serving fleet and the serving service), with the same names
and the same field sets, so one event file reads the same with either
package's tools.
The transport adds ``ts``, ``event`` and ``pid`` to every record; those
never appear here. :func:`check` holds a record to its row.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Supervisor lifecycle (resilience/supervisor.py).
ATTEMPT_START = "attempt_start"
ATTEMPT_END = "attempt_end"
RESTART = "restart"
RUN_COMPLETE = "run_complete"
BUDGET_EXHAUSTED = "budget_exhausted"
PREEMPTION_CAP_EXHAUSTED = "preemption_cap_exhausted"
RESIZE_CAP_EXHAUSTED = "resize_cap_exhausted"
GANG_RESIZE = "gang_resize"
RECOVERY = "recovery"
RANK_SKEW = "rank_skew"
STRAGGLER = "straggler"
BUDDY_SEGMENTS_INVALIDATED = "buddy_segments_invalidated"

# The workers' side of it (callbacks, faults, preemption, redundancy).
FAULT_INJECTED = "fault_injected"
PREEMPTED = "preempted"
RESTORE_BEGIN = "restore_begin"
RESTORE_END = "restore_end"
POST_RESTORE_STEP = "post_restore_step"
FIRST_STEP = "first_step"
BUDDY_REFRESH = "buddy_refresh"
BUDDY_REFRESH_FAILED = "buddy_refresh_failed"

# The flight recorder (obs/flight.py).
FLIGHT_DUMP = "flight_dump"

# Serving (serving/engine.py).
PREFIX_CACHE_HIT = "prefix_cache_hit"
SPEC_VERIFY = "spec_verify"
DRAFT_SYNC = "draft_sync"
SPEC_K_ADJUST = "spec_k_adjust"
DECODE_KERNEL_SELECTED = "decode_kernel_selected"
PREFIX_EVICT = "prefix_evict"

# The serving fleet (fleet/core.py) and its prefix gossip.
FLEET_REPLICA_KILLED = "fleet_replica_killed"
PREFIX_GOSSIP_ADVERTISE = "prefix_gossip_advertise"
PREFIX_GOSSIP_ADOPT = "prefix_gossip_adopt"

# The multi-process serving service (serve_service/).
SERVICE_START = "service_start"
REPLICA_SPAWN = "replica_spawn"
STREAM_OPEN = "stream_open"
QUOTA_REJECT = "quota_reject"
TRANSPORT_FALLBACK = "transport_fallback"

# Checkpoints and callbacks (checkpoint/core.py, training/callbacks.py).
CORRUPT_CHECKPOINT_SKIPPED = "corrupt_checkpoint_skipped"
SYNC_CHECK_FAILED = "sync_check_failed"

# The fit loop (training/model.py): its periodic flush, and the
# scanned-overlap record at its end.
METRICS_SNAPSHOT = "metrics_snapshot"
OVERLAP_REPORT = "overlap_report"
PIPELINE_SCHEDULE_SELECTED = "pipeline_schedule_selected"
BUBBLE_REPORT = "bubble_report"

# compile(strategy="auto") (training/model.py).
AUTO_SHARD_PLAN = "auto_shard_plan"

# required: keys every emit site passes; optional: keys it may attach;
# extra: True for an open payload (the producer spreads a whole record).
EVENTS: Dict[str, dict] = {
    ATTEMPT_START: {
        "required": ("attempt", "world_size"),
        "optional": ("restarts_used", "preemptions", "resizes"),
    },
    ATTEMPT_END: {
        "required": ("attempt", "ok", "world_size"),
        "optional": ("duration", "failed_ranks", "exit_codes"),
    },
    RESTART: {
        "required": ("attempt", "reason"),
        "optional": ("world_size", "delay", "restarts_used", "preemptions",
                     "resizes", "resume_step", "marker_step"),
    },
    RUN_COMPLETE: {
        "required": ("attempts",),
        "optional": ("restarts_used", "preemptions", "resizes",
                     "world_size"),
    },
    BUDGET_EXHAUSTED: {
        "required": ("restarts_used",),
        "optional": ("max_restarts",),
    },
    PREEMPTION_CAP_EXHAUSTED: {
        "required": ("preemptions",),
        "optional": (),
    },
    RESIZE_CAP_EXHAUSTED: {
        "required": ("resizes",),
        "optional": ("wanted_world",),
    },
    GANG_RESIZE: {
        "required": ("from_world", "to_world", "reason", "trigger"),
        "optional": ("lost_ranks", "attempt"),
    },
    # One per restart boundary: the time to recover, split.
    RECOVERY: {
        "required": ("failed_attempt", "recovered_attempt"),
        "optional": ("flight_dumps", "detect_s", "gang_reform_s",
                     "restore_s", "recompile_s", "restore_tier",
                     "restore_step", "disk_block_reads",
                     "total_to_first_step_s"),
    },
    RANK_SKEW: {
        "required": ("ranks", "world", "gang_median_step_s", "max_skew",
                     "slowest_rank"),
        "optional": (),
    },
    STRAGGLER: {
        "required": ("rank", "skew", "median_step_s", "gang_median_step_s",
                     "threshold", "world"),
        "optional": (),
    },
    BUDDY_SEGMENTS_INVALIDATED: {
        "required": ("ranks",),
        "optional": (),
    },
    FAULT_INJECTED: {
        "required": ("mode", "step"),
        "optional": ("replica", "slow_seconds"),
    },
    PREEMPTED: {
        "required": ("step",),
        "optional": ("exit_code",),
    },
    RESTORE_BEGIN: {
        "required": ("tier", "rank"),
        "optional": ("attempt",),
    },
    RESTORE_END: {
        "required": ("tier", "step", "rank", "seconds"),
        "optional": ("disk_block_reads", "disk_block_bytes", "attempt"),
    },
    POST_RESTORE_STEP: {
        "required": ("step", "rank"),
        "optional": (),
    },
    # Read by recovery_rows for streams without post_restore_step; no
    # producer in either package.
    FIRST_STEP: {
        "required": (),
        "optional": ("step", "rank"),
    },
    BUDDY_REFRESH: {
        "required": ("step", "rank"),
        "optional": ("world",),
    },
    BUDDY_REFRESH_FAILED: {
        "required": ("step", "rank"),
        "optional": ("error",),
    },
    FLIGHT_DUMP: {
        "required": ("path",),
        "optional": ("reason", "rank", "records", "attempt"),
    },
    PREFIX_CACHE_HIT: {
        "required": ("request_id", "cached_tokens"),
        "optional": ("blocks", "cow"),
    },
    # Per-RUN aggregate (the transport fsyncs per record, so the verify
    # loop does not emit per dispatch).
    SPEC_VERIFY: {
        "required": ("rounds", "proposed", "accepted"),
        "optional": ("accept_rate", "tokens_per_dispatch"),
    },
    # Draft weights swapped in; staleness = target swaps the draft missed.
    DRAFT_SYNC: {
        "required": ("weights_version",),
        "optional": ("staleness", "source", "distill_loss"),
    },
    # A tenant's speculative depth moved between rungs of the ladder
    # {0, 2, 4, 8}: one record per adjustment.
    SPEC_K_ADJUST: {
        "required": ("tenant", "old_k", "new_k"),
        "optional": ("accept_ema", "rounds"),
    },
    # Once per Engine construction: the decode read path.
    DECODE_KERNEL_SELECTED: {
        "required": ("kernel",),
        "optional": ("backend", "interpret"),
    },
    # The prefix store gave up refcount-1 blocks to serve an allocation.
    PREFIX_EVICT: {
        "required": ("blocks",),
        "optional": ("reason",),
    },
    FLEET_REPLICA_KILLED: {
        "required": ("replica",),
        "optional": ("requeued",),
    },
    # A replica's newly advertised prefix keys: one record per replica a
    # run, stamped with the weights version.
    PREFIX_GOSSIP_ADVERTISE: {
        "required": ("replica", "blocks"),
        "optional": ("weights_version", "runs"),
    },
    # A cold replica installed a peer's prefix run instead of prefilling.
    PREFIX_GOSSIP_ADOPT: {
        "required": ("replica", "source", "blocks"),
        "optional": ("tokens", "weights_version", "transport"),
    },
    SERVICE_START: {
        "required": ("decode_replicas", "prefill_replicas"),
        "optional": ("transport", "port"),
    },
    REPLICA_SPAWN: {
        "required": ("replica",),
        "optional": ("role", "pid", "port", "spinup_s"),
    },
    STREAM_OPEN: {
        "required": ("request_id",),
        "optional": ("tenant",),
    },
    QUOTA_REJECT: {
        "required": ("tenant",),
        "optional": ("request_id", "retry_after_s"),
    },
    # A KV payload could not ride its transport (missing shm directory,
    # torn frame, incompatible pool): the receiver prefills instead.
    TRANSPORT_FALLBACK: {
        "required": ("request_id",),
        "optional": ("reason", "replica"),
    },
    # The restore scan skipped a file that does not load.
    CORRUPT_CHECKPOINT_SKIPPED: {
        "required": ("step", "path"),
        "optional": ("error",),
    },
    # SyncCheck found replicas that differ, just before it re-raises.
    SYNC_CHECK_FAILED: {
        "required": ("epoch", "step"),
        "optional": ("error",),
    },
    # Per-step wall and own host seconds since the last flush.
    METRICS_SNAPSHOT: {
        "required": ("rank", "step_seconds"),
        "optional": ("world", "step", "self_seconds"),
    },
    # Once per fit: whether a scanned stack overlapped its gathers.
    OVERLAP_REPORT: {
        "required": ("overlap", "exposed_comm_fraction"),
        "optional": ("layers", "strategy"),
    },
    # Per-FIT: which pipeline microbatch schedule the PipelinedBlocks
    # stack ran (gpipe | interleaved) and its static shape.
    PIPELINE_SCHEDULE_SELECTED: {
        "required": ("schedule", "interleave"),
        "optional": ("num_stages", "num_microbatches", "strategy"),
    },
    # Per-FIT: the schedule's analytic idle fraction, (n-1)/ticks.
    BUBBLE_REPORT: {
        "required": ("bubble_fraction", "ticks"),
        "optional": ("schedule", "interleave", "num_stages",
                     "num_microbatches"),
    },
    AUTO_SHARD_PLAN: {
        # The whole Plan.summary() dict: the planner's own schema.
        "required": (),
        "optional": (),
        "extra": True,
    },
}

TRANSPORT_KEYS = ("ts", "event", "pid")


def required_keys(name: str) -> Tuple[str, ...]:
    return tuple(EVENTS[name]["required"])


def optional_keys(name: str) -> Tuple[str, ...]:
    return tuple(EVENTS[name].get("optional", ()))


def allows_extra(name: str) -> bool:
    return bool(EVENTS[name].get("extra", False))


def check(record: dict) -> List[str]:
    """What is wrong with one event record against its row: an undeclared
    event, a missing required key, an undeclared key. Empty when it
    conforms."""
    kind = record.get("event")
    if kind not in EVENTS:
        return [f"undeclared event {kind!r}"]
    keys = set(record) - set(TRANSPORT_KEYS)
    req, opt = set(required_keys(kind)), set(optional_keys(kind))
    undeclared = [] if allows_extra(kind) else sorted(keys - req - opt)
    return ([f"{kind}: missing {k!r}" for k in sorted(req - keys)]
            + [f"{kind}: undeclared {k!r}" for k in undeclared])


__all__ = [
    "ATTEMPT_END", "ATTEMPT_START", "BUDDY_REFRESH", "BUDDY_REFRESH_FAILED",
    "BUDDY_SEGMENTS_INVALIDATED", "BUDGET_EXHAUSTED", "FAULT_INJECTED",
    "FIRST_STEP", "FLIGHT_DUMP", "GANG_RESIZE", "POST_RESTORE_STEP",
    "PREEMPTED", "PREEMPTION_CAP_EXHAUSTED", "RANK_SKEW", "RECOVERY",
    "RESIZE_CAP_EXHAUSTED", "RESTART", "RESTORE_BEGIN", "RESTORE_END",
    "RUN_COMPLETE", "STRAGGLER",
    "AUTO_SHARD_PLAN", "CORRUPT_CHECKPOINT_SKIPPED", "DECODE_KERNEL_SELECTED", "DRAFT_SYNC",
    "BUBBLE_REPORT", "EVENTS", "FLEET_REPLICA_KILLED", "METRICS_SNAPSHOT",
    "OVERLAP_REPORT", "PIPELINE_SCHEDULE_SELECTED", "PREFIX_CACHE_HIT",
    "PREFIX_EVICT", "PREFIX_GOSSIP_ADOPT", "PREFIX_GOSSIP_ADVERTISE",
    "QUOTA_REJECT", "REPLICA_SPAWN", "SERVICE_START", "STREAM_OPEN",
    "TRANSPORT_FALLBACK",
    "SPEC_K_ADJUST", "SPEC_VERIFY", "SYNC_CHECK_FAILED", "check",
    "allows_extra", "optional_keys", "required_keys",
]
