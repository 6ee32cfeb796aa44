"""Continuous-batching request scheduler (iteration-level, Orca-style).

The static-batch serving loop (``Model.generate``) admits a batch, then
decodes until the LAST member finishes — early finishers keep burning a
decode slot as padding, and nothing new can start until the whole batch
drains. The scheduler here re-plans at every decode step instead:

- **admit**: the moment a slot is free AND the paged KV pool can hold a
  waiting request's context, that request joins the running batch
  (prefill happens on admission; see ``serving.engine``).
- **evict**: a finished sequence releases its slot and KV blocks at the
  step it finishes — the next step can already be decoding its
  replacement.
- **preempt**: when the pool runs dry mid-decode (a running sequence
  needs its next block and none is free), the YOUNGEST running sequence
  is evicted back to the FRONT of the queue, carrying the tokens it has
  generated so far — on re-admission its context (prompt + generated) is
  re-prefilled, so no work is lost beyond the recompute, and older
  sequences (closest to finishing) never starve.

The scheduler is pure host-side bookkeeping over fixed device shapes:
it decides WHICH slots are live and what their block tables/positions
say; the decode dispatch itself never changes shape.

A copy of the JAX package's ``serving/scheduler.py`` (which imports no
JAX), kept here so the port stands alone.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_ids = itertools.count()


@dataclass
class Request:
    """One generation request: ``prompt`` (1-D int tokens, >= 1) and the
    number of tokens to generate. ``request_id`` is assigned on
    construction when not given.

    ``seed``: per-request sampling seed. A request's sampled (non-greedy)
    token stream is a pure function of (engine seed, this seed, generated-
    token index) — NOT of the slot it lands in, the decode step it runs
    at, ``max_slots``, or preemptions around it — so rollouts with pinned
    seeds are bit-reproducible across runs and engine shapes (the serving
    analogue of the greedy token-exact discipline). ``None`` falls back to
    ``request_id`` (deterministic within a process, where ids start at 0,
    but shared-counter order-dependent across engines)."""

    prompt: np.ndarray
    max_new_tokens: int
    seed: Optional[int] = None
    request_id: int = field(default_factory=lambda: next(_ids))

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class Sequence:
    """Runtime state of an admitted request: its decode slot, the full
    token list (prompt + generated), and scheduling timestamps. On
    preemption the generated tokens are KEPT — re-admission re-prefills
    prompt+generated as one context, so the recompute is the only cost."""

    def __init__(self, request: Request):
        self.request = request
        self.slot: Optional[int] = None
        self.tokens: List[int] = [int(t) for t in request.prompt]
        self.num_generated = 0
        self.submitted_at: Optional[float] = None
        self.enqueued_at: Optional[float] = None  # last (re-)queue time
        # Lifecycle timestamps (first occurrence each; the driving loop's
        # clock): admission into a decode slot, first generated token,
        # completion. Telemetry consumers (the serving engine's per-request
        # rows, the fleet router's SLO accounting) read these instead of
        # re-deriving lifecycle from event ordering.
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.preemptions = 0
        # Per-generated-token capture, index-aligned with the generated
        # suffix of ``tokens`` (preemption keeps generated tokens, so
        # these survive requeues too): sampling logprobs (filled when the
        # engine runs with return_logprobs=True) and the engine
        # weights_version that produced each token (always filled — the
        # hot-swap staleness contract is read off the version boundary).
        self.logprobs: List[float] = []
        self.token_versions: List[int] = []
        self.sample_seed: int = 0  # mixed (engine, request) seed; set by run()
        # Leading positions already resident in the paged cache when the
        # slot was admitted (prefix-store adoption, or a fleet KV
        # handoff): prefill starts here instead of 0. Reset on every
        # admission — a preempted sequence re-negotiates its cached span.
        self.cached_len: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.request.prompt.size)

    @property
    def context_len(self) -> int:
        """Positions that must be cached before the next decode step."""
        return len(self.tokens)

    @property
    def last_token(self) -> int:
        return self.tokens[-1]

    @property
    def finished(self) -> bool:
        return self.num_generated >= self.request.max_new_tokens

    def output(self) -> np.ndarray:
        """prompt + generated, the ``generate()``-shaped result row."""
        return np.asarray(
            self.tokens[: self.prompt_len + self.request.max_new_tokens],
            np.int32,
        )


class Scheduler:
    """FIFO admission over ``max_slots`` decode slots + preemption order.

    The engine drives it: ``submit`` enqueues, ``next_admittable`` pops
    the head request when a slot and its KV blocks are both available,
    ``preempt_youngest`` reclaims blocks under pool pressure, ``finish``
    retires. Eviction (finish/preempt) always releases the paged cache
    through the SAME ``kv.release`` path, so block accounting cannot
    leak."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self.waiting: deque = deque()
        self.running: List[Sequence] = []  # admission order, oldest first
        self._free_slots = list(range(max_slots - 1, -1, -1))

    def submit(self, request: Request, now: float) -> Sequence:
        seq = Sequence(request)
        seq.submitted_at = now
        seq.enqueued_at = now
        self.waiting.append(seq)
        return seq

    def enqueue(self, seq: Sequence, now: float) -> Sequence:
        """Queue an EXISTING sequence — the fleet path, where sequences
        outlive any one scheduler (a router hands them between replicas
        and re-queues them when a replica dies mid-request)."""
        seq.enqueued_at = now
        if seq.submitted_at is None:
            seq.submitted_at = now
        self.waiting.append(seq)
        return seq

    @property
    def has_free_slot(self) -> bool:
        return bool(self._free_slots)

    def next_admittable(self, kv) -> Optional[Sequence]:
        """Admit the queue head if a slot is free and the pool can back
        its whole current context (prompt, plus any tokens generated
        before a preemption); None otherwise. FIFO head-of-line: skipping
        ahead would starve big-context requests forever.

        When the cache exposes prefix-sharing admission (``kv.admit``),
        it is used instead of a plain reservation: cached leading blocks
        are adopted and ``seq.cached_len`` records how many positions the
        engine may skip in prefill."""
        if not self.waiting or not self._free_slots:
            return None
        seq = self.waiting[0]
        slot = self._free_slots[-1]
        admit = getattr(kv, "admit", None)
        if admit is not None:
            cached = admit(slot, seq.tokens)
            if cached is None:
                return None
            seq.cached_len = int(cached)
        else:
            if not kv.reserve(slot, seq.context_len):
                return None
            seq.cached_len = 0
        self.waiting.popleft()
        self._free_slots.pop()
        seq.slot = slot
        self.running.append(seq)
        return seq

    def preempt_youngest(self, kv, protect: Sequence) -> Optional[Sequence]:
        """Evict the most recently admitted running sequence (other than
        ``protect``, the one that needs the block) back to the FRONT of
        the queue, releasing its blocks. None when no victim exists.

        Release goes through ``kv.release`` (a DECREF per block), never
        ``allocator.free``: a preempted sequence may hold prefix-store or
        peer-shared blocks (refcount > 1), and freeing those would hand
        storage still being read to the next allocation."""
        for seq in reversed(self.running):
            if seq is not protect:
                self.running.remove(seq)
                kv.release(seq.slot)
                self._free_slots.append(seq.slot)
                seq.slot = None
                seq.preemptions += 1
                self.waiting.appendleft(seq)
                return seq
        return None

    def finish(self, seq: Sequence, kv) -> None:
        self.running.remove(seq)
        kv.release(seq.slot)
        self._free_slots.append(seq.slot)
        seq.slot = None

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running


__all__ = ["Request", "Sequence", "Scheduler"]
