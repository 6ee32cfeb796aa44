"""Fleet front door: bounded queues, SLO-aware admission, tenant fairness.

A copy of the JAX package's ``fleet/router.py`` (host arithmetic only),
kept here so the port stands alone.

The router is pure host-side arithmetic (no device work, no threads), the
same discipline as ``serving.Scheduler`` — which makes every decision
testable from a synthetic trace:

- **Bounded queue**: ``max_queue`` caps waiting requests; beyond it,
  arrivals are REJECTED at submit time (reason ``"queue_full"``). An
  unbounded queue turns overload into unbounded latency for everyone;
  a bounded one turns it into fast feedback for the excess.
- **SLO-aware admission**: with ``slo_ttft_s`` set, an arrival is
  rejected (reason ``"slo"``) when the router's own estimate of its
  time-to-first-token — queue ahead of it divided by the fleet's
  observed service rate — already exceeds the SLO. The estimate uses a
  sliding window of recent completions (``observe_finish``); until
  enough completions exist there is no evidence to reject on, so cold
  starts admit freely.
- **Weighted fair queuing**: each tenant owns a FIFO; dequeue order is
  by virtual finish time (arrival's token cost divided by tenant
  weight, accumulated per tenant) — the classic WFQ discipline, so a
  tenant flooding the queue cannot starve the others, and a weight-2
  tenant gets 2x the service of a weight-1 tenant under contention.
- **Requeue**: when a decode replica dies, its in-flight sequences come
  back through ``requeue()`` — they re-enter at their ORIGINAL virtual
  finish time (the work was already charged), so recovered requests go
  to the head of the line rather than paying for the replica's death
  twice.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

from ..serving.scheduler import Request, Sequence

__all__ = ["Admission", "Router"]


class Admission(NamedTuple):
    accepted: bool
    reason: Optional[str] = None  # "queue_full" | "slo" when rejected


class _Tenant:
    def __init__(self, name: str, weight: float):
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.name = name
        self.weight = float(weight)
        self.queue: Deque[Sequence] = deque()
        self.last_vft = 0.0  # virtual finish time of the newest arrival
        self.submitted = 0
        self.dequeued = 0


class Router:
    """See module docstring. ``tenant_weights`` maps tenant name ->
    weight; unknown tenants default to weight 1.0. ``service_window``
    is how many recent completions the TTFT estimate is averaged over."""

    def __init__(self, *, max_queue: Optional[int] = None,
                 slo_ttft_s: Optional[float] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 service_window: int = 32):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.slo_ttft_s = slo_ttft_s
        self._weights = dict(tenant_weights or {})
        self._tenants: Dict[str, _Tenant] = {}
        self._vt = 0.0  # global virtual time (monotone over dequeues)
        self._finishes: Deque[float] = deque(maxlen=max(2, service_window))
        self.rejected: List[dict] = []
        self.requeues = 0

    # ------------------------------------------------------------- signals
    @property
    def queue_depth(self) -> int:
        return sum(len(t.queue) for t in self._tenants.values())

    def service_rate(self) -> Optional[float]:
        """Observed fleet completions/second over the sliding window;
        None until two completions exist (no evidence, no estimate)."""
        if len(self._finishes) < 2:
            return None
        span = self._finishes[-1] - self._finishes[0]
        if span <= 0:
            return None
        return (len(self._finishes) - 1) / span

    def predicted_ttft(self) -> Optional[float]:
        """What a NEW arrival should expect to wait for its first token:
        the queue it joins behind, drained at the observed service rate.
        None when there is no rate estimate yet."""
        rate = self.service_rate()
        if rate is None:
            return None
        return (self.queue_depth + 1) / rate

    def observe_finish(self, now: float) -> None:
        """Feed the admission estimator: called once per completed
        request with the fleet clock."""
        self._finishes.append(float(now))

    # ------------------------------------------------------------- tenants
    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = _Tenant(name, self._weights.get(name, 1.0))
            self._tenants[name] = t
        return t

    # -------------------------------------------------------------- submit
    def submit(self, request: Request, *, tenant: str = "default",
               now: float = 0.0) -> Tuple[Admission, Optional[Sequence]]:
        """Admission-check ``request`` and, if accepted, wrap it in a
        router-owned :class:`Sequence` queued under ``tenant``. Returns
        ``(Admission, Sequence-or-None)``."""
        if self.max_queue is not None and self.queue_depth >= self.max_queue:
            adm = Admission(False, "queue_full")
            self.rejected.append({
                "request_id": request.request_id, "tenant": tenant,
                "reason": "queue_full", "t": float(now),
            })
            return adm, None
        if self.slo_ttft_s is not None:
            pred = self.predicted_ttft()
            if pred is not None and pred > self.slo_ttft_s:
                adm = Admission(False, "slo")
                self.rejected.append({
                    "request_id": request.request_id, "tenant": tenant,
                    "reason": "slo", "t": float(now),
                    "predicted_ttft_s": round(pred, 4),
                })
                return adm, None
        t = self._tenant(tenant)
        seq = Sequence(request)
        seq.submitted_at = float(now)
        seq.enqueued_at = float(now)
        seq.tenant = tenant
        cost = request.prompt.size + request.max_new_tokens  # token work
        seq.vft = max(self._vt, t.last_vft) + cost / t.weight
        t.last_vft = seq.vft
        t.queue.append(seq)
        t.submitted += 1
        return Admission(True), seq

    def requeue(self, seqs, now: float) -> None:
        """Put recovered in-flight sequences back at the head of their
        tenant queues, keeping their original virtual finish times (their
        work is already charged — the replica's death is not billed to
        the tenant)."""
        for seq in reversed(list(seqs)):
            t = self._tenant(getattr(seq, "tenant", "default"))
            seq.enqueued_at = float(now)
            seq.requeues = getattr(seq, "requeues", 0) + 1
            t.queue.appendleft(seq)
            self.requeues += 1

    # ------------------------------------------------------------- dequeue
    def _best_tenant(self) -> Optional[_Tenant]:
        best: Optional[_Tenant] = None
        for name in sorted(self._tenants):
            t = self._tenants[name]
            if not t.queue:
                continue
            if best is None or t.queue[0].vft < best.queue[0].vft:
                best = t
        return best

    def peek(self) -> Optional[Sequence]:
        """The sequence ``next_request`` would pop, without popping — a
        dispatcher can inspect the WFQ head (is it fresh? does capacity
        exist for it?) and leave it queued, preserving WFQ order instead
        of pop/requeue churn."""
        best = self._best_tenant()
        return best.queue[0] if best is not None else None

    def next_request(self) -> Optional[Sequence]:
        """Pop the waiting sequence with the smallest virtual finish time
        (ties break on tenant name, so order is deterministic)."""
        best = self._best_tenant()
        if best is None:
            return None
        seq = best.queue.popleft()
        best.dequeued += 1
        self._vt = max(self._vt, seq.vft)
        return seq

    # ------------------------------------------------------------ placement
    def place(self, seq: Sequence, candidates, *,
              gossip_adoptable: bool = False):
        """Pick the decode replica for ``seq`` from ``candidates``
        (replicas with capacity): PREFIX AFFINITY first — a replica whose
        prefix store already holds the sequence's leading prompt block
        (``DecodeReplica.holds_prefix``) admits it with a warm cache and,
        under block transfer, receives a trimmed suffix-only payload —
        affinity TIES break by lowest queue depth (the replica that will
        ADMIT soonest; two warm replicas are equally warm, but the one
        with the shorter wait wins), then least in-flight, then name
        (deterministic). Without prefix caching every replica scores
        equal affinity and this degrades to shortest-queue/least-loaded.

        ``gossip_adoptable``: the fleet found a PEER advertising this
        sequence's prefix (``fleet.gossip``), so any prefix-caching
        replica can be made warm by adopting the remote run at placement
        — every such replica scores warm affinity and the tie breaks by
        queue depth, instead of the cold pool pinning all shared-prefix
        traffic onto the one replica that prefilled first."""
        pool = list(candidates)
        if not pool:
            return None

        def key(rep):
            holds = getattr(rep, "holds_prefix", None)
            affinity = 1 if holds is not None and holds(seq) else 0
            if not affinity and gossip_adoptable and (
                    getattr(getattr(rep, "kv", None), "prefix", None)
                    is not None):
                affinity = 1
            return (-affinity, getattr(rep, "queue_depth", rep.in_flight),
                    rep.in_flight, rep.name)

        return min(pool, key=key)

    # ----------------------------------------------------------- telemetry
    def telemetry(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "rejected": len(self.rejected),
            "rejected_by_reason": {
                r: sum(1 for x in self.rejected if x["reason"] == r)
                for r in sorted({x["reason"] for x in self.rejected})
            },
            "requeues": self.requeues,
            "tenants": {
                name: {
                    "weight": t.weight,
                    "submitted": t.submitted,
                    "dequeued": t.dequeued,
                    "waiting": len(t.queue),
                }
                for name, t in sorted(self._tenants.items())
            },
        }
