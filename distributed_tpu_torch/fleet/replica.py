"""Fleet workers: step-driven prefill and decode replicas.

The serving :class:`~distributed_tpu_torch.serving.Engine` is a closed
loop — ``run(requests)`` to completion, one engine, one pool. A fleet
needs the same mechanics OPENED UP: a router interleaves many replicas,
kills some mid-request, and spins up new ones, so each replica here
advances by ONE scheduling iteration per ``step()`` call and reports how
long its device work took, leaving the clock and the request lifecycle to
the fleet.

Replicas of one fleet share one :class:`EnginePrograms`: the model, the
sampling settings and the dispatches, which are the Engine's own
(``serving.engine._prefill_dispatch``/``_decode_dispatch``), so spinning
up a decode replica costs a pool allocation and nothing else.

**Which weights a fleet serves.** The live model's: every dispatch runs
``programs.model.module``, as the JAX fleet dispatches
``programs.model.params`` at each call. A ``fit`` or ``load_params`` on
the model after the fleet was built is what the fleet serves next, and
``ServingFleet.update_weights`` copies a new tree into the model. (The
Engine instead serves a snapshot taken when it was built, as the JAX
Engine does.)

Scheduling semantics inside a decode replica are exactly the engine's
(``serving.scheduler``): FIFO admission when slots + blocks allow, at most
one prefill chunk between decode steps, youngest-first preemption under
pool pressure. Sequences arrive through ``submit()`` (optionally carrying
a prefill replica's KV payload — ``fleet.handoff``), and ``kill()``
returns every in-flight sequence for the router to re-queue.

A copy of the JAX package's ``fleet/replica.py`` with the port's
dispatches and pools.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import paged_attention as paged_ops
from ..serving.engine import (
    _bucket, _decode_dispatch, _mix_seed, _prefill_dispatch, _token_key,
)
from ..serving.kv_cache import PagedKVCache, _chain_hashes
from ..serving.scheduler import Scheduler, Sequence
from .handoff import HandoffIncompatible, KVHandoff, install_kv, pack_kv

__all__ = ["EnginePrograms", "PrefillReplica", "DecodeReplica"]


class EnginePrograms:
    """The serving dispatches of one model, shared fleet-wide: the
    sampling settings, the per-request RNG stream (``token_key``) and the
    ``prefill_fn``/``decode_fn`` every replica calls on its own pool.
    ``decode_kernel="fused"`` sends every replica's decode attention
    through ``ops.paged_attention`` (the hand-written kernel on a card).

    They dispatch the LIVE ``model.module`` (see the module docstring)."""

    def __init__(self, model, *, temperature: float = 0.0,
                 top_k: Optional[int] = None, seed: int = 0,
                 decode_kernel: str = "reference"):
        if not model.built:
            raise RuntimeError("Model not built")
        if decode_kernel not in paged_ops.KINDS:
            raise ValueError(
                f"decode_kernel must be one of {paged_ops.KINDS}, got "
                f"{decode_kernel!r}"
            )
        self.model = model
        self.temperature = float(temperature)
        self.top_k = top_k
        self.seed = int(seed)
        self.decode_kernel = decode_kernel

    def prefill_fn(self, kv, tokens, block_table, start: int, last_idx: int,
                   key) -> Tuple[int, float]:
        """One prompt chunk into ``kv``; (sampled token, logprob)."""
        m = self.model
        return _prefill_dispatch(m.module, m.precision, m.device, kv,
                                 tokens, block_table, start, last_idx, key,
                                 self.temperature, self.top_k)

    def decode_fn(self, kv, tokens, block_tables, positions, keys):
        """One decode step over every slot of ``kv``; (tokens, logprobs)
        on the host."""
        m = self.model
        return _decode_dispatch(m.module, m.precision, m.device, kv, tokens,
                                block_tables, positions, keys,
                                self.temperature, self.top_k,
                                self.decode_kernel)

    def token_key(self, seq: Sequence) -> np.ndarray:
        """Per-request, per-token sampling key (the engine's derivation):
        depends only on (fleet seed, request seed, generated-token index),
        so a sampled request decodes the same tokens whichever replica —
        or post-kill re-queue — runs it."""
        r = seq.request
        return _token_key(
            _mix_seed(
                self.seed,
                r.seed if getattr(r, "seed", None) is not None
                else r.request_id,
            ),
            seq.num_generated,
        )


class _ReplicaBase:
    """Pool + program plumbing common to both replica kinds."""

    def __init__(self, name: str, programs: EnginePrograms, *,
                 max_slots: int, block_size: int, max_len: int,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False):
        self.name = name
        self.programs = programs
        model = programs.model
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        nb_per_seq = -(-self.max_len // self.block_size)
        if num_blocks is None:
            num_blocks = self.max_slots * nb_per_seq + 1
        self.kv = PagedKVCache(
            model.module,
            max_slots=self.max_slots, block_size=self.block_size,
            max_blocks_per_seq=nb_per_seq, num_blocks=int(num_blocks),
            dtype=model.decode_dtype(), device=model.device,
            prefix_cache=bool(prefix_cache),
        )
        self.alive = True
        self.busy_until = 0.0  # this replica's own (virtual) timeline
        self.busy_s = 0.0  # cumulative device seconds

    def release_pool(self) -> None:
        """Drop the pool (a killed or retired replica): on a card its
        device memory returns to the allocator once nothing else holds
        the tensors, and nothing in the fleet does."""
        self.kv = None

    def _run_prefill_chunk(self, seq: Sequence, start: int, c: int,
                           last_idx: int):
        """One prefill dispatch over positions [start, start+c) of
        ``seq``'s context on slot ``seq.slot``; returns (sampled token,
        measured seconds)."""
        cb = _bucket(c, start, self.max_len)
        buf = np.zeros((1, cb), np.int32)
        buf[0, :c] = seq.tokens[start:start + c]
        t0 = time.perf_counter()
        # The sampled token is on the host when the dispatch returns (a
        # read that waits for the card), so the span covers the work.
        with torch.inference_mode():
            tok, _logp = self.programs.prefill_fn(
                self.kv, buf, self.kv.block_tables[seq.slot], start,
                last_idx, self.programs.token_key(seq),
            )
        return tok, time.perf_counter() - t0


class PrefillReplica(_ReplicaBase):
    """One-sequence-at-a-time prompt worker: fills its scratch pool,
    samples the first token (the fleet's TTFT moment), packs the blocks
    into a :class:`~distributed_tpu_torch.fleet.handoff.KVHandoff`, and
    frees the pool for the next prompt. ``prefill_chunk`` bounds positions
    per dispatch exactly like the engine's."""

    def __init__(self, name: str, programs: EnginePrograms, *,
                 block_size: int, max_len: int,
                 prefill_chunk: Optional[int] = None):
        super().__init__(name, programs, max_slots=1,
                         block_size=block_size, max_len=max_len)
        self.prefill_chunk = (
            int(prefill_chunk) if prefill_chunk is not None else None
        )
        self.prefills = 0

    def prefill(self, seq: Sequence) -> Tuple[float, KVHandoff]:
        """Prefill ``seq``'s whole current context, append the sampled
        next token, and return (device seconds, payload for the decode
        side). The payload covers the PRE-SAMPLE context; the sampled
        token's KV row is written by the receiver's first decode step."""
        total = seq.context_len
        if not self.kv.reserve(0, total):
            raise RuntimeError(
                f"{self.name}: context of {total} tokens does not fit the "
                f"prefill scratch pool ({self.kv.allocator.num_allocatable}"
                " blocks)"
            )
        seq.slot = 0
        step = self.prefill_chunk or total
        chunks = [(s, min(step, total - s)) for s in range(0, total, step)]
        spent = 0.0
        tok = None
        for i, (start, c) in enumerate(chunks):
            last = (total - 1 - start) if i == len(chunks) - 1 else c - 1
            tok, dt = self._run_prefill_chunk(seq, start, c, last)
            spent += dt
        # Chain hashes ride along so a prefix-caching decode replica can
        # trim the payload to the non-cached suffix (fleet.handoff).
        payload = pack_kv(self.kv, 0, total, tokens=seq.tokens[:total])
        self.kv.release(0)
        seq.slot = None
        seq.tokens.append(int(tok))
        seq.num_generated += 1
        self.prefills += 1
        self.busy_s += spent
        return spent, payload


class DecodeReplica(_ReplicaBase):
    """Continuous-batching decode worker, advanced one iteration per
    ``step()``. Mirrors the engine loop body: admit as many waiting
    sequences as slots+blocks allow (installing handed-off KV when the
    payload is compatible, else queuing a re-prefill job), run at most
    one prefill chunk, then one fixed-shape decode step over every ready
    slot, preempting the youngest under pool pressure."""

    def __init__(self, name: str, programs: EnginePrograms, *,
                 max_slots: int, block_size: int, max_len: int,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 prefix_cache: bool = False):
        super().__init__(name, programs, max_slots=max_slots,
                         block_size=block_size, max_len=max_len,
                         num_blocks=num_blocks, prefix_cache=prefix_cache)
        self.prefill_chunk = (
            int(prefill_chunk) if prefill_chunk is not None else None
        )
        self.eos_id = eos_id
        self.sched = Scheduler(self.max_slots)
        self._handoffs: Dict[int, KVHandoff] = {}  # request_id -> payload
        self._prefill_jobs: List[list] = []
        self.decode_steps = 0
        self.prefill_dispatches = 0
        self.preemptions = 0
        self.handoffs_installed = 0
        self.handoffs_fallback = 0
        self.handoffs_trim_stale = 0  # trimmed prefix evicted pre-admit
        self.prefills_full = 0        # prefill jobs that started at pos 0
        self.gossip_adopts = 0        # remote prefix runs installed here
        self.gossip_adopt_blocks = 0  # blocks those runs carried
        self.gossip_serves = 0        # runs packed here for a peer
        self.gossip_advertised = 0    # keys newly advertised (cumulative)

    # ------------------------------------------------------------ signals
    @property
    def queue_depth(self) -> int:
        return len(self.sched.waiting)

    @property
    def running(self) -> int:
        return len(self.sched.running)

    @property
    def in_flight(self) -> int:
        return self.queue_depth + self.running

    @property
    def free_slots(self) -> int:
        return self.max_slots - self.running

    @property
    def free_blocks(self) -> int:
        return self.kv.allocator.num_free

    @property
    def has_work(self) -> bool:
        return not self.sched.idle or bool(self._prefill_jobs)

    def holds_prefix(self, seq: Sequence) -> bool:
        """True when this replica's prefix store already caches the
        sequence's leading prompt block — the router's placement
        affinity signal."""
        store = self.kv.prefix
        if store is None:
            return False
        keys = _chain_hashes(seq.tokens[:self.block_size],
                             self.block_size)
        return bool(keys) and keys[0] in store

    # ----------------------------------------------------------- lifecycle
    def submit(self, seq: Sequence, now: float,
               payload: Optional[KVHandoff] = None) -> None:
        self.sched.enqueue(seq, now)
        if payload is not None:
            self._handoffs[seq.request.request_id] = payload

    def kill(self, now: float) -> List[Sequence]:
        """Tear the replica down: every in-flight sequence (running,
        oldest first, then queued) is detached and returned for the
        router to re-queue. Generated tokens ride along; KV (and any
        pending handoff payloads) die here, so the next replica
        re-prefills."""
        self.alive = False
        lost = list(self.sched.running) + list(self.sched.waiting)
        for seq in lost:
            seq.slot = None
        self.sched.running.clear()
        self.sched.waiting.clear()
        self._prefill_jobs.clear()
        self._handoffs.clear()
        return lost

    # ---------------------------------------------------------------- step
    def _admit(self, now: float):
        while True:
            seq = self.sched.next_admittable(self.kv)
            if seq is None:
                break
            if seq.admitted_at is None:
                seq.admitted_at = now
            payload = self._handoffs.pop(seq.request.request_id, None)
            if (payload is not None and payload.skip_blocks > 0
                    and payload.skip_blocks * self.kv.block_size
                    > seq.cached_len):
                # The payload was trimmed against this store, but the
                # trimmed prefix was evicted before admission could
                # adopt it: re-prefill instead of leaving a hole.
                self.handoffs_trim_stale += 1
                self.handoffs_fallback += 1
                payload = None
            if payload is not None:
                try:
                    install_kv(self.kv, seq.slot, payload)
                    # Post-prefill engine state: positions = cached
                    # context, last token decodes next.
                    self.kv.positions[seq.slot] = payload.cached_len
                    if self.kv.prefix is not None:
                        self.kv.insert_prefix(
                            seq.slot, seq.tokens[:seq.prompt_len]
                        )
                    self.handoffs_installed += 1
                    continue
                except HandoffIncompatible:
                    self.handoffs_fallback += 1
            # No payload (transfer off, replica lost, or preempted here):
            # prefill the current context minus what the prefix store
            # already adopted, and sample the next token from its last
            # position — the engine's re-admission path, token-exact
            # under greedy.
            total = seq.context_len
            begin = min(seq.cached_len, total - 1)
            if begin == 0:
                self.prefills_full += 1
            step = self.prefill_chunk or (total - begin)
            chunks = [
                (s, min(step, total - s)) for s in range(begin, total, step)
            ]
            self._prefill_jobs.append([seq, chunks, 0])

    def step(self, now: float) -> Tuple[float, List[Sequence]]:
        """One scheduling iteration at fleet time ``now``. Returns
        (device seconds spent, sequences finished). Lifecycle timestamps
        are stamped at ``now + spent-so-far`` — the moment the token
        exists on this replica's own timeline."""
        if not self.alive:
            raise RuntimeError(f"{self.name} is dead")
        spent = 0.0
        finished: List[Sequence] = []

        def finish(seq, at):
            self.sched.finish(seq, self.kv)
            seq.finished_at = at
            finished.append(seq)

        self._admit(now)
        if (not self.sched.running and not self._prefill_jobs
                and self.sched.waiting):
            head = self.sched.waiting[0]
            raise RuntimeError(
                f"{self.name}: request {head.request.request_id} needs "
                f"{self.kv.blocks_for(head.context_len)} blocks but the "
                f"pool only has {self.kv.allocator.num_allocatable} "
                "allocatable — raise num_blocks or lower max_len"
            )
        # -- one prefill chunk ------------------------------------------
        if self._prefill_jobs:
            job = self._prefill_jobs[0]
            seq, chunks, idx = job
            if seq.slot is None:  # preempted mid-prefill: job is moot
                self._prefill_jobs.pop(0)
            else:
                start, c = chunks[idx]
                is_last = idx == len(chunks) - 1
                total = chunks[-1][0] + chunks[-1][1]
                last = (total - 1 - start) if is_last else c - 1
                tok, dt = self._run_prefill_chunk(seq, start, c, last)
                spent += dt
                self.prefill_dispatches += 1
                job[2] = idx + 1
                if job[2] == len(chunks):
                    self._prefill_jobs.pop(0)
                    self.kv.positions[seq.slot] = total
                    if self.kv.prefix is not None:
                        self.kv.insert_prefix(
                            seq.slot, seq.tokens[:seq.prompt_len]
                        )
                    seq.tokens.append(tok)
                    seq.num_generated += 1
                    if seq.first_token_at is None:
                        seq.first_token_at = now + spent
                    if seq.finished or tok == self.eos_id:
                        finish(seq, now + spent)
        # -- decode: every running, fully-cached slot -------------------
        mid_prefill = {
            id(j[0]) for j in self._prefill_jobs if j[0].slot is not None
        }
        ready = [
            s for s in self.sched.running if id(s) not in mid_prefill
        ]
        for seq in ready:
            if seq.slot is None:
                continue  # evicted by an older peer this pass
            while not self.kv.reserve(seq.slot, seq.context_len):
                victim = self.sched.preempt_youngest(self.kv, protect=seq)
                if victim is None:
                    raise RuntimeError(
                        f"{self.name}: request "
                        f"{seq.request.request_id} cannot back "
                        f"{seq.context_len} positions with "
                        f"{self.kv.num_blocks - 1} pool blocks even alone"
                        " — raise num_blocks"
                    )
                self.preemptions += 1
                victim.enqueued_at = now
                self._handoffs.pop(victim.request.request_id, None)
                self._prefill_jobs[:] = [
                    j for j in self._prefill_jobs if j[0] is not victim
                ]
        ready = [s for s in ready if s.slot is not None]
        if ready:
            tokens = np.zeros((self.max_slots,), np.int32)
            mask = np.zeros((self.max_slots,), bool)
            keys = np.zeros((self.max_slots, 2), np.uint32)
            for seq in ready:
                tokens[seq.slot] = seq.last_token
                mask[seq.slot] = True
                keys[seq.slot] = self.programs.token_key(seq)
            tables = np.where(
                mask[:, None], self.kv.block_tables, np.int32(0)
            )
            positions = np.where(mask, self.kv.positions, 0).astype(
                np.int32
            )
            t0 = time.perf_counter()
            # The sampled tokens come back on the host inside the span
            # (the read waits for the card), so it measures the step.
            with torch.inference_mode():
                sampled, _logps = self.programs.decode_fn(
                    self.kv, tokens, tables, positions, keys,
                )
            spent += time.perf_counter() - t0
            self.decode_steps += 1
            for seq in ready:
                tok = int(sampled[seq.slot])
                self.kv.positions[seq.slot] = seq.context_len
                seq.tokens.append(tok)
                seq.num_generated += 1
                if seq.num_generated == 1 and seq.first_token_at is None:
                    seq.first_token_at = now + spent
                if seq.finished or tok == self.eos_id:
                    finish(seq, now + spent)
        self.busy_s += spent
        return spent, finished
