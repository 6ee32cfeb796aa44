"""The serving fleet: disaggregated prefill/decode pools behind a router.

``ServingFleet`` composes the pieces this package and its neighbors
provide into one serving tier:

- a :class:`~distributed_tpu_torch.fleet.router.Router` at the front (bounded
  queue, SLO admission, weighted per-tenant fairness);
- a pool of :class:`~distributed_tpu_torch.fleet.replica.PrefillReplica` that
  turn prompts into first tokens + KV payloads
  (``fleet.handoff``), and a pool of
  :class:`~distributed_tpu_torch.fleet.replica.DecodeReplica` that decode them
  to completion — prefill/decode DISAGGREGATION, the intra-engine split
  of ``serving.Engine`` promoted to an inter-replica one;
- a :class:`~distributed_tpu_torch.fleet.autoscale.QueueAutoscaler` (optional)
  driving the decode-pool size from queue depth / tail latency through
  the same reconcile step that replaces killed replicas;
- a :class:`~distributed_tpu_torch.resilience.FaultInjector` hook
  (``mode="replica_kill"``) so replica death mid-request is a provable,
  benchable event: the dead replica's in-flight sequences re-queue at
  the router and finish on surviving replicas, token-exact under greedy
  (the scheduler's preemption-requeue contract across replicas).

**The clock.** Replicas are cooperative objects in one process; the fleet
drives them with a discrete-event loop over a VIRTUAL clock: every device
dispatch is real work timed for real (each span ends once its sampled
tokens are on the host), but its wall time advances only the owning
replica's timeline (``busy_until``), and fleet time jumps to the next
event (arrival, replica free, spin-up done). Tokens, scheduling
decisions, and failure handling are therefore exactly what a process-per-
replica deployment computes, while throughput/latency numbers describe
the fleet as if replicas ran in parallel, which replicas sharing one
card do not. So the fleet's tokens/s and TTFT are virtual-clock figures;
``serve_service`` runs the same control logic as processes on wall
time.

A copy of the JAX package's ``fleet/core.py`` over the port's replicas;
its telemetry has the same keys and rounding.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence as SequenceT

import numpy as np
import torch

from ..serving.engine import _check_positions, _validate_swap
from ..serving.kv_cache import _chain_hashes
from ..serving.scheduler import Request, Sequence
from ..utils import event_schema as evs
from ..utils import events as events_lib
from .autoscale import QueueAutoscaler
from .gossip import PrefixGossipIndex
from .handoff import (
    HandoffIncompatible, adopt_prefix, pack_prefix, trim_kv,
)
from .replica import DecodeReplica, EnginePrograms, PrefillReplica
from .router import Router

__all__ = ["ServingFleet", "FleetResult"]


class FleetResult(list):
    """The per-request outputs (submission order; ``None`` for rejected
    requests) with the run's telemetry attached as ``.telemetry``."""

    telemetry: dict


class ServingFleet:
    """See module docstring.

    ``transfer="blocks"`` moves prefilled KV to the decode replica via
    the handoff payload; ``transfer="none"`` models a deployment without
    a transfer path — the decode replica re-prefills every context (the
    documented fallback; same tokens, more compute). ``prefill_replicas=0``
    colocates prefill on the decode replicas (the engine's own layout).

    ``prefix_cache=True`` gives every decode replica a refcounted prefix
    store (``serving.kv_cache.PrefixStore``): the router places requests
    by prefix affinity, admission adopts cached prompt blocks, and
    handoff payloads are TRIMMED to the non-cached suffix before
    shipping (``fleet.handoff.trim_kv``) — telemetry reports the bytes
    saved.

    ``prefix_gossip=True`` (requires ``prefix_cache``) federates those
    per-replica stores through a :class:`~distributed_tpu_torch.fleet.
    gossip.PrefixGossipIndex`: replicas advertise their chain-hash keys after
    every step, placement consults the global view (a request whose
    prefix SOME peer holds treats every prefix-caching replica as warm),
    and the fleet moves the blocks at placement time —
    ``pack_prefix`` on the warm side, ``adopt_prefix`` on the cold one,
    the copy charged to both replicas' timelines. A cold replica then
    admits with ``cached_len > 0`` and never re-prefills a shared
    prefix (``handoffs.prefills_full`` telemetry proves it). Every
    advertisement and payload carries ``weights_version``;
    :meth:`update_weights` bumps it, flushes every store, and withdraws
    every advertisement, so stale-weights blocks can never travel.
    """

    def __init__(self, model, *, decode_replicas: int = 2,
                 prefill_replicas: int = 1, max_slots: int = 4,
                 block_size: int = 16, max_len: int = 128,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 transfer: str = "blocks",
                 prefix_cache: bool = False,
                 prefix_gossip: bool = False,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 router: Optional[Router] = None,
                 autoscaler: Optional[QueueAutoscaler] = None,
                 fault=None,
                 programs: Optional[EnginePrograms] = None):
        if decode_replicas < 1:
            raise ValueError(
                f"decode_replicas must be >= 1, got {decode_replicas}"
            )
        if prefill_replicas < 0:
            raise ValueError(
                f"prefill_replicas must be >= 0, got {prefill_replicas}"
            )
        if transfer not in ("blocks", "none"):
            raise ValueError(
                f"transfer must be 'blocks' or 'none', got {transfer!r}"
            )
        if prefix_gossip and not prefix_cache:
            raise ValueError(
                "prefix_gossip=True requires prefix_cache=True — the "
                "gossip index advertises the per-replica prefix stores"
            )
        self.model = model
        self.programs = programs or EnginePrograms(
            model, temperature=temperature, top_k=top_k, seed=seed
        )
        # Positional-capacity check up front, exactly like Engine: a
        # too-short learned positional table must fail HERE, not clamp
        # rows mid-serve on some replica.
        _check_positions(model, int(max_len))
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.num_blocks = num_blocks
        self.prefill_chunk = prefill_chunk
        self.transfer = transfer
        self.prefix_cache = bool(prefix_cache)
        self.prefix_gossip = bool(prefix_gossip)
        self.gossip = PrefixGossipIndex() if prefix_gossip else None
        self.weights_version = 0
        self.eos_id = eos_id
        self.router = router or Router()
        self.autoscaler = autoscaler
        self.fault = fault
        self._ids = itertools.count()
        self._configured_decode = int(decode_replicas)
        self.decode_pool: Dict[str, DecodeReplica] = {}
        self._warming: Dict[str, float] = {}  # name -> ready_at
        self.prefill_pool: List[PrefillReplica] = [
            PrefillReplica(
                f"prefill-{i}", self.programs,
                block_size=self.block_size, max_len=self.max_len,
                prefill_chunk=self.prefill_chunk,
            )
            for i in range(int(prefill_replicas))
        ]
        self.pool_events: List[dict] = []
        self._retired_rows: Dict[str, dict] = {}  # stats outlive retirement
        self.spinup_measured_s = 0.0
        for _ in range(int(decode_replicas)):
            self._spawn(0.0, warm=False)
        self.last_run_telemetry: Optional[dict] = None

    # ----------------------------------------------------------- replicas
    def _spawn(self, now: float, *, warm: bool = True) -> DecodeReplica:
        """Add a decode replica. Pool allocation is timed for real and,
        together with the autoscaler's modeled ``spinup_s``, delays when
        the replica takes work; the programs are shared."""
        name = f"decode-{next(self._ids)}"
        t0 = time.perf_counter()
        rep = DecodeReplica(
            name, self.programs, max_slots=self.max_slots,
            block_size=self.block_size, max_len=self.max_len,
            num_blocks=self.num_blocks, prefill_chunk=self.prefill_chunk,
            eos_id=self.eos_id, prefix_cache=self.prefix_cache,
        )
        alloc = time.perf_counter() - t0
        self.spinup_measured_s = max(self.spinup_measured_s, alloc)
        self.decode_pool[name] = rep
        if warm:
            extra = self.autoscaler.spinup_s if self.autoscaler else 0.0
            ready = now + alloc + extra
            self._warming[name] = ready
            rep.busy_until = ready
            self.pool_events.append({
                "t": round(now, 4), "event": "spawn", "replica": name,
                "ready_at": round(ready, 4),
            })
        return rep

    @staticmethod
    def _replica_row(rep: DecodeReplica) -> dict:
        return {
            "decode_steps": rep.decode_steps,
            "prefill_dispatches": rep.prefill_dispatches,
            "prefills_full": rep.prefills_full,
            "preemptions": rep.preemptions,
            "handoffs_installed": rep.handoffs_installed,
            "handoffs_fallback": rep.handoffs_fallback,
            "handoffs_trim_stale": rep.handoffs_trim_stale,
            "gossip_adopts": rep.gossip_adopts,
            "gossip_adopt_blocks": rep.gossip_adopt_blocks,
            "gossip_serves": rep.gossip_serves,
            "gossip_advertised": rep.gossip_advertised,
            "busy_s": round(rep.busy_s, 4),
            "alive": rep.alive,
        }

    def _retire(self, name: str, now: float) -> None:
        rep = self.decode_pool.pop(name)
        self._retired_rows[name] = self._replica_row(rep)
        rep.release_pool()
        self._warming.pop(name, None)
        if self.gossip is not None:
            # A retired/killed replica's pool dies with it: its
            # advertisements must not linger as adoptable claims.
            self.gossip.withdraw(name)
        self.pool_events.append({
            "t": round(now, 4), "event": "retire", "replica": name,
        })

    def _ready(self, rep: DecodeReplica, now: float) -> bool:
        return rep.alive and self._warming.get(rep.name, 0.0) <= now

    def _reconcile(self, now: float) -> bool:
        """Drive the live decode-pool size toward the target — the
        autoscaler's if present, else the configured count. One reconcile
        step serves BOTH elasticity and healing: a killed replica leaves
        the pool below target and the next pass replaces it."""
        target = (self.autoscaler.target if self.autoscaler
                  else self._configured_decode)
        changed = False
        while len(self.decode_pool) < target:
            self._spawn(now)
            changed = True
        if len(self.decode_pool) > target:
            # Shrink only drains: retire an idle replica; if none is
            # idle, keep serving and try again at the next event.
            for name, rep in sorted(self.decode_pool.items()):
                if self._ready(rep, now) and rep.in_flight == 0:
                    self._retire(name, now)
                    changed = True
                    break
        return changed

    # -------------------------------------------------------- weight swap
    def update_weights(self, params) -> int:
        """Hot-swap the fleet's served weights (the Engine
        ``update_weights`` contract, pool-wide): validate the new
        ``{tree path: tensor}`` tree against the model's (paths, shapes
        and dtypes), then copy it into the model
        (``Model.load_params``) and wait for the card — replicas dispatch
        through ``programs.model.module``, so the swap is atomic at
        dispatch granularity for every replica at once.

        Staleness discipline: every replica's prefix store is flushed
        (cached KV was computed under the old weights) AND its gossip
        advertisement withdrawn, and ``weights_version`` bumps — so even
        an advertisement that somehow survived (or a payload packed
        before the swap, in a real multi-process deployment) fails the
        stamp check at adoption time instead of seeding a new request
        from one-update-old KV. Returns the new version."""
        model = self.programs.model
        _validate_swap(model.params, params, "fleet.update_weights")
        model.load_params(params)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        self.weights_version += 1
        for name, rep in sorted(self.decode_pool.items()):
            if rep.kv.prefix is not None:
                rep.kv.prefix.flush(rep.kv.allocator)
            if self.gossip is not None:
                self.gossip.withdraw(name)
        for rep in self.prefill_pool:
            if rep.kv.prefix is not None:
                rep.kv.prefix.flush(rep.kv.allocator)
        return self.weights_version

    # ---------------------------------------------------------------- run
    def run(self, requests: SequenceT, *,
            arrival_times: Optional[SequenceT] = None,
            tenants: Optional[SequenceT] = None) -> FleetResult:
        """Serve ``requests`` (``serving.Request`` or (prompt, n) pairs)
        under an open-loop arrival process: request i becomes visible to
        the router at ``arrival_times[i]`` (fleet seconds; default all
        0.0) with tenant ``tenants[i]`` (default "default"). Returns
        outputs in submission order (``None`` where admission rejected);
        telemetry lands in ``fleet.last_run_telemetry`` and on the
        result's ``.telemetry``."""
        reqs = [
            r if isinstance(r, Request) else Request(r[0], r[1])
            for r in requests
        ]
        for r in reqs:
            need = r.prompt.size + r.max_new_tokens
            if need > self.max_len:
                raise ValueError(
                    f"request {r.request_id}: prompt {r.prompt.size} + "
                    f"max_new_tokens {r.max_new_tokens} exceeds fleet "
                    f"max_len {self.max_len}"
                )
        times = [0.0] * len(reqs) if arrival_times is None else [
            float(t) for t in arrival_times
        ]
        tens = ["default"] * len(reqs) if tenants is None else list(tenants)
        if len(times) != len(reqs) or len(tens) != len(reqs):
            raise ValueError(
                "arrival_times/tenants must match requests in length"
            )
        arrivals = sorted(
            zip(times, range(len(reqs)), reqs, tens), key=lambda a: a[:2]
        )
        ai = 0
        now = 0.0
        wall0 = time.perf_counter()
        results: Dict[int, np.ndarray] = {}
        admitted: Dict[int, Sequence] = {}
        seqs_in_order: List[Optional[Sequence]] = [None] * len(reqs)
        head: Optional[Sequence] = None  # popped from router, unplaced
        pending_handoff: List[list] = []  # [ready_at, seq, payload]
        kills: List[dict] = []
        fallback_dispatches = 0  # re-prefills: transfer off / replica lost
        gossip_adoptions: List[dict] = []  # placement-time block moves
        gossip_stale = 0  # adoptions refused by the weights-version stamp
        handoff_bytes_full = 0     # payload bytes before suffix trimming
        handoff_bytes_shipped = 0  # payload bytes actually transferred
        suffix_trims = 0           # payloads that shipped suffix-only
        queue_peak = 0
        ttft_recent: List[float] = []

        def record_finish(seq: Sequence):
            results[seq.request.request_id] = seq.output()
            self.router.observe_finish(seq.finished_at)
            ttft_recent.append(seq.first_token_at - seq.submitted_at)
            del ttft_recent[:-64]

        while True:
            progressed = False
            # -- arrivals due now --------------------------------------
            while ai < len(arrivals) and arrivals[ai][0] <= now:
                t, i, req, tenant = arrivals[ai]
                ai += 1
                adm, seq = self.router.submit(req, tenant=tenant, now=t)
                if adm.accepted:
                    admitted[req.request_id] = seq
                    seqs_in_order[i] = seq
                progressed = True
            # -- fault injection: replica-addressable kills ------------
            if self.fault is not None:
                for name, rep in sorted(self.decode_pool.items()):
                    if not rep.alive:
                        continue
                    if self.fault.should_kill_replica(name,
                                                      rep.decode_steps):
                        lost = rep.kill(now)
                        self._retire(name, now)
                        self.router.requeue(lost, now)
                        kills.append({
                            "t": round(now, 4), "replica": name,
                            "requeued": len(lost),
                            "decode_steps": rep.decode_steps,
                        })
                        events_lib.emit(
                            evs.FLEET_REPLICA_KILLED, replica=name,
                            requeued=len(lost),
                        )
                        progressed = True
            # -- autoscaling + pool reconcile --------------------------
            if self.autoscaler is not None:
                live = [
                    r for r in self.decode_pool.values() if r.alive
                ]
                qd = self.router.queue_depth + sum(
                    r.queue_depth for r in live
                ) + (1 if head is not None else 0)
                p99 = (
                    float(np.percentile(ttft_recent, 99))
                    if ttft_recent else None
                )
                self.autoscaler.decide(
                    now, queue_depth=qd, replicas=max(len(live), 1),
                    free_slots=sum(
                        r.free_slots for r in live
                        if self._ready(r, now)
                    ),
                    slots_per_replica=self.max_slots,
                    recent_p99_ttft=p99,
                )
            if self._reconcile(now):
                progressed = True
            # -- prefill completions -> decode dispatch queue ----------
            # (Extraction alone is not progress: an item that fails to
            # place goes straight back, and claiming progress for the
            # round-trip would busy-spin the loop at a stuck `now`.)
            due = [p for p in pending_handoff if p[0] <= now]
            pending_handoff[:] = [
                p for p in pending_handoff if p[0] > now
            ]
            # -- route work --------------------------------------------
            # head buffer: at most one popped-but-unplaced sequence, so
            # WFQ order is preserved while a full pool applies
            # backpressure instead of dropping the pop.
            dispatchable = due
            while True:
                if head is None:
                    head = self.router.next_request()
                if head is None:
                    break
                seq = head
                fresh = seq.num_generated == 0
                idle_prefill = next(
                    (p for p in self.prefill_pool
                     if p.busy_until <= now), None
                ) if (fresh and self.prefill_pool) else None
                if fresh and self.prefill_pool:
                    if idle_prefill is None:
                        break  # prefill pool busy: arrivals wait here
                    dt, payload = idle_prefill.prefill(seq)
                    idle_prefill.busy_until = now + dt
                    if seq.first_token_at is None:
                        seq.first_token_at = now + dt
                    if seq.finished or seq.last_token == self.eos_id:
                        seq.finished_at = now + dt
                        record_finish(seq)
                    else:
                        pending_handoff.append([
                            now + dt, seq,
                            payload if self.transfer == "blocks" else None,
                        ])
                    head = None
                    progressed = True
                    continue
                # straight to decode: requeued sequences, and fresh ones
                # when no prefill pool exists (colocated layout).
                dispatchable.append([now, seq, None])
                head = None
                progressed = True
            for item in dispatchable:
                _, seq, payload = item
                # Gossip lookup BEFORE placement: if some peer advertises
                # this sequence's prefix at the current weights version,
                # every prefix-caching replica is adoptable-warm and the
                # router may spread the load instead of pinning it.
                peer, peer_keys = None, ()
                if self.gossip is not None and payload is None:
                    keys = _chain_hashes(
                        seq.tokens[:seq.prompt_len], self.block_size
                    )
                    if keys:
                        name, run = self.gossip.best_peer(
                            keys, weights_version=self.weights_version
                        )
                        if name is not None and run > 0:
                            peer, peer_keys = name, tuple(keys[:run])
                target = self.router.place(
                    seq,
                    (r for r in self.decode_pool.values()
                     if self._ready(r, now) and r.free_slots > 0),
                    gossip_adoptable=peer is not None,
                )
                if target is None:
                    # No capacity: hold as pending, re-offered next pass.
                    pending_handoff.append([now, seq, payload])
                    continue
                if (peer is not None and peer != target.name
                        and not target.holds_prefix(seq)):
                    src = self.decode_pool.get(peer)
                    if src is not None and src.alive:
                        t0 = time.perf_counter()
                        adopted = 0
                        try:
                            pay = pack_prefix(
                                src.kv, peer_keys,
                                weights_version=self.weights_version,
                            )
                            if pay is not None:
                                adopted = adopt_prefix(
                                    target.kv, pay,
                                    weights_version=self.weights_version,
                                )
                        except HandoffIncompatible:
                            gossip_stale += 1
                        # The gather/scatter is real device work on both
                        # ends: charge each replica's own timeline, like
                        # any other dispatch.
                        dt = time.perf_counter() - t0
                        src.busy_s += dt
                        src.busy_until = max(src.busy_until, now + dt)
                        target.busy_s += dt
                        target.busy_until = max(
                            target.busy_until, now + dt
                        )
                        if adopted:
                            src.gossip_serves += 1
                            target.gossip_adopts += 1
                            target.gossip_adopt_blocks += adopted
                            gossip_adoptions.append({
                                "t": round(now, 4),
                                "request_id": seq.request.request_id,
                                "from": src.name, "to": target.name,
                                "blocks": int(adopted),
                                "copy_s": round(dt, 6),
                            })
                            events_lib.emit(
                                evs.PREFIX_GOSSIP_ADOPT,
                                replica=target.name, source=src.name,
                                blocks=int(adopted),
                                tokens=int(adopted * self.block_size),
                                weights_version=self.weights_version,
                                transport="inproc",
                            )
                if payload is None and seq.num_generated > 0:
                    # Prefilled (or partially decoded) elsewhere but the
                    # KV could not travel: the decode side re-prefills.
                    fallback_dispatches += 1
                if payload is not None:
                    # Ship only the suffix the target's prefix store does
                    # not already hold. Trimming is per-target (stores
                    # differ), so it happens at placement, not at pack.
                    handoff_bytes_full += payload.nbytes
                    payload, skipped = trim_kv(payload, target.kv.prefix)
                    handoff_bytes_shipped += payload.nbytes
                    if skipped:
                        suffix_trims += 1
                target.submit(seq, now, payload=payload)
                seq.replica = target.name
                progressed = True
            # -- step replicas on their own timelines ------------------
            for name, rep in sorted(self.decode_pool.items()):
                if not self._ready(rep, now) or rep.busy_until > now:
                    continue
                if not rep.has_work:
                    continue
                dt, finished = rep.step(now)
                rep.busy_until = now + dt
                for seq in finished:
                    record_finish(seq)
                if self.gossip is not None and rep.kv.prefix is not None:
                    # Advertise-sync after the step wrote new prefix
                    # blocks: REPLACE semantics, so local eviction
                    # propagates too (no dangling claims).
                    rep.gossip_advertised += self.gossip.advertise(
                        name, rep.kv.prefix.keys(),
                        weights_version=self.weights_version,
                    )
                progressed = True
            queue_peak = max(
                queue_peak,
                self.router.queue_depth + sum(
                    r.queue_depth for r in self.decode_pool.values()
                ) + (1 if head is not None else 0) + len(pending_handoff),
            )
            if progressed:
                continue
            # -- advance the clock to the next event -------------------
            horizon = []
            if ai < len(arrivals):
                horizon.append(arrivals[ai][0])
            horizon += [p[0] for p in pending_handoff]
            horizon += [
                r.busy_until for r in self.decode_pool.values()
                if r.busy_until > now and (r.has_work or not self._ready(
                    r, now))
            ]
            horizon += [
                p.busy_until for p in self.prefill_pool
                if p.busy_until > now
            ]
            horizon += [
                t for t in self._warming.values() if t > now
            ]
            future = [t for t in horizon if t > now]
            outstanding = (
                head is not None or pending_handoff
                or self.router.queue_depth
                or any(r.has_work for r in self.decode_pool.values())
                or ai < len(arrivals)
            )
            if not outstanding:
                break
            if not future:
                raise RuntimeError(
                    "fleet deadlock: "
                    f"{len(admitted) - len(results)} request(s) cannot be "
                    "placed — decode pool too small for the workload "
                    "(raise num_blocks/max_slots or add replicas)"
                )
            now = min(future)

        self._finalize_telemetry(
            reqs, seqs_in_order, admitted, results, kills, queue_peak,
            fallback_dispatches, wall_s=time.perf_counter() - wall0,
            handoff_bytes=(handoff_bytes_full, handoff_bytes_shipped,
                           suffix_trims),
            gossip_rows=(gossip_adoptions, gossip_stale),
        )
        out = FleetResult(
            results.get(r.request_id) for r in reqs
        )
        out.telemetry = self.last_run_telemetry
        return out

    # ----------------------------------------------------------- telemetry
    def _finalize_telemetry(self, reqs, seqs_in_order, admitted, results,
                            kills, queue_peak, fallback_dispatches,
                            wall_s, handoff_bytes=(0, 0, 0),
                            gossip_rows=((), 0)):
        fins = [s for s in admitted.values()
                if s.request.request_id in results]
        ttfts = [s.first_token_at - s.submitted_at for s in fins]
        makespan = max((s.finished_at for s in fins), default=0.0)
        useful = int(sum(
            len(results[s.request.request_id]) - s.prompt_len
            for s in fins
        ))
        rows = dict(self._retired_rows)
        rows.update({
            n: self._replica_row(r)
            for n, r in sorted(self.decode_pool.items())
        })
        tel = {
            "clock": "virtual (per-replica timelines over real dispatch "
                     "walls; single-host harness — see docs/SERVING.md "
                     "'Fleet')",
            "requests_submitted": len(reqs),
            "requests_admitted": len(admitted),
            "requests_finished": len(results),
            "lost_requests": len(admitted) - len(results),
            "generated_tokens": useful,
            "makespan_s": round(float(makespan), 4),
            "wall_s": round(float(wall_s), 4),
            "tokens_per_sec": round(useful / makespan, 3)
            if makespan > 0 else 0.0,
            "time_to_first_token": {
                "mean": round(float(np.mean(ttfts)), 4) if ttfts else None,
                "p50": round(float(np.percentile(ttfts, 50)), 4)
                if ttfts else None,
                "p99": round(float(np.percentile(ttfts, 99)), 4)
                if ttfts else None,
                "max": round(float(np.max(ttfts)), 4) if ttfts else None,
            },
            "requests": [
                None if s is None else {
                    "request_id": s.request.request_id,
                    "tenant": getattr(s, "tenant", "default"),
                    "replica": getattr(s, "replica", None),
                    "enqueued_s": round(float(s.submitted_at), 4),
                    "admitted_s": round(float(s.admitted_at), 4)
                    if s.admitted_at is not None else None,
                    "first_token_s": round(float(s.first_token_at), 4)
                    if s.first_token_at is not None else None,
                    "finished_s": round(float(s.finished_at), 4)
                    if s.finished_at is not None else None,
                    "requeues": getattr(s, "requeues", 0),
                    "preemptions": s.preemptions,
                }
                for s in seqs_in_order
            ],
            "router": self.router.telemetry(),
            "queue_depth_peak": int(queue_peak),
            "decode_pool": {
                "final_replicas": len(self.decode_pool),
                "replicas": rows,
                "events": list(self.pool_events),
                "kills": kills,
                "spinup_alloc_s": round(self.spinup_measured_s, 4),
            },
            "prefill_pool": {
                "replicas": len(self.prefill_pool),
                "prefills": sum(p.prefills for p in self.prefill_pool),
                "busy_s": round(
                    sum(p.busy_s for p in self.prefill_pool), 4
                ),
            },
            "handoffs": {
                "transfer": self.transfer,
                "installed": sum(
                    r["handoffs_installed"] for r in rows.values()
                ),
                "fallback_reprefill": fallback_dispatches + sum(
                    r["handoffs_fallback"] for r in rows.values()
                ),
                "trim_stale": sum(
                    r["handoffs_trim_stale"] for r in rows.values()
                ),
                "prefills_full": sum(
                    r["prefills_full"] for r in rows.values()
                ),
                "bytes_full": int(handoff_bytes[0]),
                "bytes_shipped": int(handoff_bytes[1]),
                "bytes_saved": int(handoff_bytes[0] - handoff_bytes[1]),
                "suffix_trims": int(handoff_bytes[2]),
            },
            "preemptions": sum(r["preemptions"] for r in rows.values()),
            "decode_steps": sum(r["decode_steps"] for r in rows.values()),
        }
        if self.autoscaler is not None:
            tel["autoscaler"] = {
                "target": self.autoscaler.target,
                "events": list(self.autoscaler.events),
            }
        if self.gossip is not None:
            adoptions, stale = gossip_rows
            tel["gossip"] = {
                **self.gossip.telemetry(),
                "weights_version": self.weights_version,
                "adoptions": len(adoptions),
                "adopted_blocks": sum(a["blocks"] for a in adoptions),
                "stale_rejected": int(stale),
                "events": list(adoptions),
            }
            # One advertise event per replica, run-aggregate granularity:
            # per-step emission would swamp the log with near-identical
            # advertisements.
            for name, row in sorted(rows.items()):
                if row.get("gossip_advertised"):
                    events_lib.emit(
                        evs.PREFIX_GOSSIP_ADVERTISE, replica=name,
                        blocks=int(row["gossip_advertised"]),
                        weights_version=self.weights_version,
                    )
        # Publish into the metrics registry: the run's report, with the
        # SLO-facing aggregates doubled as counters/gauges for the
        # Prometheus/JSONL exporters.
        from ..obs import registry as obs_registry

        reg = obs_registry.default_registry()
        reg.counter("fleet/requests_finished", tel["requests_finished"])
        reg.counter("fleet/generated_tokens", tel["generated_tokens"])
        reg.counter("fleet/preemptions", tel["preemptions"])
        reg.gauge("fleet/tokens_per_sec", tel["tokens_per_sec"])
        reg.gauge("fleet/queue_depth_peak", queue_peak)
        reg.gauge("fleet/decode_replicas", len(self.decode_pool))
        reg.gauge("fleet/handoff_bytes_saved",
                  tel["handoffs"]["bytes_saved"])
        if self.gossip is not None:
            reg.counter("fleet/gossip_adoptions",
                        tel["gossip"]["adoptions"])
            reg.counter("fleet/gossip_adopted_blocks",
                        tel["gossip"]["adopted_blocks"])
        self.last_run_telemetry = reg.set_report("fleet.run", tel)
