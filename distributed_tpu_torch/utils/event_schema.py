"""Declared schema of the events the port emits (``utils.events``).

The port's copy of the rows of the JAX package's ``utils/event_schema.py``
for the events its serving engine emits, with the same names and the same
field sets, so one event file reads the same with either package's tools.
The transport adds ``ts``, ``event`` and ``pid`` to every record; those
never appear here. :func:`check` holds a record to its row.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# Serving (serving/engine.py).
PREFIX_CACHE_HIT = "prefix_cache_hit"
SPEC_VERIFY = "spec_verify"
DRAFT_SYNC = "draft_sync"
SPEC_K_ADJUST = "spec_k_adjust"
DECODE_KERNEL_SELECTED = "decode_kernel_selected"

# required: keys every emit site passes; optional: keys it may attach.
EVENTS: Dict[str, dict] = {
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
}

TRANSPORT_KEYS = ("ts", "event", "pid")


def required_keys(name: str) -> Tuple[str, ...]:
    return tuple(EVENTS[name]["required"])


def optional_keys(name: str) -> Tuple[str, ...]:
    return tuple(EVENTS[name].get("optional", ()))


def check(record: dict) -> List[str]:
    """What is wrong with one event record against its row: an undeclared
    event, a missing required key, an undeclared key. Empty when it
    conforms."""
    kind = record.get("event")
    if kind not in EVENTS:
        return [f"undeclared event {kind!r}"]
    keys = set(record) - set(TRANSPORT_KEYS)
    req, opt = set(required_keys(kind)), set(optional_keys(kind))
    return ([f"{kind}: missing {k!r}" for k in sorted(req - keys)]
            + [f"{kind}: undeclared {k!r}" for k in sorted(keys - req - opt)])


__all__ = [
    "DECODE_KERNEL_SELECTED", "DRAFT_SYNC", "EVENTS", "PREFIX_CACHE_HIT",
    "SPEC_K_ADJUST", "SPEC_VERIFY", "check", "optional_keys",
    "required_keys",
]
