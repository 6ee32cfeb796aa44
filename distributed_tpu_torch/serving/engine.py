"""Serving engine: continuous batching over a paged KV cache.

``Engine(model, max_slots, block_size)`` turns a built token LM into a
synchronous serving loop (``engine.run(requests)``) built from three
pieces, as in the JAX package's ``serving/engine.py``:

- **Continuous batching** (``serving.scheduler``): requests are admitted
  into decode SLOTS the moment one frees up, and finished sequences
  release their slot and KV blocks immediately.
- **Paged KV cache** (``serving.kv_cache`` +
  ``nn.MultiHeadAttention.paged_decode``): one device pool of fixed-size
  blocks shared by all slots, allocated on demand and freed on eviction.
- **Prefill/decode split**: a prompt is cached by its own parallel pass
  (optionally chunked via ``prefill_chunk``); the decode loop for running
  sequences proceeds between prefill chunks.

The decode step always runs at the fixed shapes ``(S,)`` tokens,
``(S, nb)`` block tables and ``(S,)`` positions; slots that are free or
mid-prefill point at the trash block. Prefill chunks are padded to a
multiple of 64 positions, as in the JAX engine, so both write the same
pool rows.

The decode attention reads through ``decode_kernel``: ``"reference"`` (the
default, as in the JAX engine) gathers each slot's blocks into a view and
runs dense attention, and ``"fused"`` calls ``ops.paged_attention`` — the
hand-written CUDA kernel on a card. Everything runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence as SequenceT

import numpy as np
import torch

from ..nn.attention import PositionalEmbedding
from ..ops import paged_attention as paged_ops
from ..ops._common import round_up
from ..training.model import Model
from .kv_cache import PagedKVCache
from .scheduler import Request, Scheduler

_M64 = (1 << 64) - 1


def _mix_seed(engine_seed: int, request_seed: int) -> int:
    """One 64-bit mix of (engine seed, request seed) — the per-request
    sampling-stream identity."""
    return (
        (int(engine_seed) + 1) * 0xD1342543DE82EF95
        + (int(request_seed) + 1) * 0x9E3779B97F4A7C15
    ) & _M64


def _token_key(sample_seed: int, index: int) -> np.ndarray:
    """Deterministic uint32[2] sampling key for generated-token ``index``
    of the request identified by ``sample_seed`` (splitmix64 finalizer
    over the pair), bit-equal to the JAX engine's. It depends on nothing
    else — not the slot, the decode step or ``max_slots``."""
    x = (
        int(sample_seed) + (int(index) + 1) * 0xBF58476D1CE4E5B9
    ) & _M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return np.array([x >> 32, x & 0xFFFFFFFF], np.uint32)


def _sample_with_logprob(logits, keys, temperature, top_k):
    """Sample each row's next token and its sampling logprob: ``logits``
    (S, V), ``keys`` (S, 2) uint32 token keys. Greedy (``temperature <=
    0``) takes the argmax and reports the unscaled log-likelihood;
    otherwise each row draws from its top_k-truncated, temperature-scaled
    softmax with a ``torch.Generator`` seeded from its key — deterministic
    per request, but not the same draw as JAX's ``categorical``."""
    logits = logits.to(torch.float32)
    if top_k is not None:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    t = float(temperature) if temperature > 0.0 else 1.0
    scaled = logits / t
    logp_all = torch.log_softmax(scaled, dim=-1)
    if temperature <= 0.0:
        toks = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(scaled, dim=-1)
        draws = []
        for row, key in zip(probs, keys):
            gen = torch.Generator(device=logits.device)
            gen.manual_seed((int(key[0]) << 32) | int(key[1]))
            draws.append(torch.multinomial(row, 1, generator=gen))
        toks = torch.cat(draws)
    logp = logp_all.gather(1, toks[:, None])[:, 0]
    return toks, logp


class Engine:
    """Synchronous continuous-batching serving loop for a built token LM.

    ``max_slots``: decode-batch width S. ``block_size``: KV block
    granularity in positions. ``max_len``: per-sequence context cap
    (prompt + generated); sizes the block tables. ``num_blocks``: pool
    blocks INCLUDING the trash block — default fully provisions
    ``max_slots * ceil(max_len/block_size) + 1``; lower values trade
    memory for possible preemptions. ``prefill_chunk``: cache prompts in
    chunks of at most this many positions (None = one pass).

    ``temperature=0`` is greedy; otherwise ``top_k`` truncation and
    per-request seeded sampling (``Request.seed``, else its id, mixed with
    ``seed``). ``eos_id`` stops a sequence early.
    ``prefix_cache=True`` shares full prompt blocks across requests
    (refcounted, copy-on-write). ``kv_dtype="int8"`` stores the pools as
    int8 with per-(position, head) scales; None uses
    ``model.decode_dtype()``. ``decode_kernel``: "reference" (default, as
    in the JAX engine) or "fused" (see the module docstring).
    """

    def __init__(self, model: Model, max_slots: int, block_size: int, *,
                 max_len: int = 512, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefix_cache: bool = False, kv_dtype=None,
                 decode_kernel: str = paged_ops.REFERENCE):
        if not model.built:
            raise RuntimeError("Model not built")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if decode_kernel not in paged_ops.KINDS:
            raise ValueError(
                f"decode_kernel must be one of {paged_ops.KINDS}, got "
                f"{decode_kernel!r}"
            )
        if kv_dtype not in (None, "int8", torch.int8):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.prefill_chunk = (
            int(prefill_chunk) if prefill_chunk is not None else None
        )
        self.temperature = float(temperature)
        self.top_k = top_k
        self.eos_id = eos_id
        self.seed = int(seed)
        self.decode_kernel = decode_kernel
        # A learned positional table shorter than max_len must fail here,
        # not mid-serve.
        for m in model.module.modules():
            if isinstance(m, PositionalEmbedding) and self.max_len > m.max_len:
                raise ValueError(
                    f"generation length {self.max_len} exceeds positional "
                    f"table max_len {m.max_len}"
                )
        nb_per_seq = -(-self.max_len // self.block_size)
        if num_blocks is None:
            num_blocks = self.max_slots * nb_per_seq + 1
        self.kv = PagedKVCache(
            model.module,
            max_slots=self.max_slots, block_size=self.block_size,
            max_blocks_per_seq=nb_per_seq, num_blocks=int(num_blocks),
            dtype=torch.int8 if kv_dtype is not None else model.decode_dtype(),
            device=self.device, prefix_cache=bool(prefix_cache),
        )
        self.last_run_telemetry = None

    # ------------------------------------------------------------- helpers
    def _bucket(self, c: int, start: int) -> int:
        """Chunk lengths round up to a multiple of 64 (the JAX engine's
        compile buckets), capped so the padded chunk never runs past
        max_len — the positional rows and block indices must stay inside
        their tables."""
        return min(max(64, round_up(c, 64)), self.max_len - start)

    def _prefill_chunks(self, seq):
        """(start, length) chunks covering seq's current context — minus
        the leading span admission found already cached (capped at
        context-1, so the final chunk, whose logits sample the
        continuation, always exists)."""
        total = seq.context_len
        begin = min(seq.cached_len, total - 1)
        step = self.prefill_chunk or (total - begin)
        return [
            (s, min(step, total - s)) for s in range(begin, total, step)
        ]

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill(self, tokens, block_table, start, last_idx, key):
        """One prompt chunk for one sequence: KV scattered into its blocks,
        and the next token sampled from position ``last_idx``'s logits."""
        out, self.kv.caches = self.model.module.paged_prefill(
            self.kv.caches, self._tensor(tokens),
            block_table=self._tensor(block_table), start=int(start),
        )
        tok, logp = _sample_with_logprob(
            out[0, last_idx:last_idx + 1], key[None], self.temperature,
            self.top_k,
        )
        return int(tok[0]), float(logp[0])

    def _decode(self, tokens, block_tables, positions, keys):
        """One decode step over every slot."""
        logits, self.kv.caches = self.model.module.paged_decode(
            self.kv.caches, self._tensor(tokens)[:, None],
            block_tables=self._tensor(block_tables),
            positions=self._tensor(positions),
            decode_kernel=self.decode_kernel,
        )
        toks, logp = _sample_with_logprob(
            logits[:, 0], keys, self.temperature, self.top_k)
        return toks.cpu().numpy(), logp.cpu().numpy()

    # ---------------------------------------------------------------- run
    def run(self, requests: SequenceT, *,
            return_logprobs: bool = False) -> List[np.ndarray]:
        """Serve ``requests`` (``serving.Request``s, or (prompt,
        max_new_tokens) pairs) to completion; returns each request's
        prompt+generated tokens in submission order. Telemetry lands in
        ``last_run_telemetry``; ``return_logprobs=True`` adds each
        generated token's sampling logprob to its request row."""
        with torch.inference_mode():
            return self._run(requests, return_logprobs)

    def _run(self, requests, return_logprobs):
        reqs = [
            r if isinstance(r, Request) else Request(r[0], r[1])
            for r in requests
        ]
        for r in reqs:
            if r.prompt.size + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {r.request_id}: prompt {r.prompt.size} + "
                    f"max_new_tokens {r.max_new_tokens} exceeds engine "
                    f"max_len {self.max_len}"
                )
        sched = Scheduler(self.max_slots)
        t0 = time.perf_counter()
        seqs = [sched.submit(r, now=0.0) for r in reqs]
        for seq in seqs:
            r = seq.request
            seq.sample_seed = _mix_seed(
                self.seed, r.seed if r.seed is not None else r.request_id
            )
        results = {}
        ttft = {}
        util_samples = []
        decode_steps = 0
        prefill_dispatches = 0
        preemptions = 0
        prefix_hit_tokens = 0
        # (seq, chunk list, next chunk index): at most ONE chunk runs per
        # loop iteration, so running sequences keep decoding between a
        # long prompt's chunks.
        prefill_jobs = []

        def elapsed():
            return time.perf_counter() - t0

        def finish(seq):
            sched.finish(seq, self.kv)
            seq.finished_at = elapsed()
            results[seq.request.request_id] = seq.output()

        def commit(seq, tok, logp):
            seq.tokens.append(tok)
            if return_logprobs:
                seq.logprobs.append(logp)
            seq.num_generated += 1
            if seq.num_generated == 1:
                ttft[seq.request.request_id] = seq.first_token_at = elapsed()
            if seq.finished or tok == self.eos_id:
                finish(seq)

        while not (sched.idle and not prefill_jobs):
            # -- admit: fill every free slot the pool can back ------------
            while True:
                seq = sched.next_admittable(self.kv)
                if seq is None:
                    break
                if seq.admitted_at is None:
                    seq.admitted_at = elapsed()
                prefix_hit_tokens += seq.cached_len
                prefill_jobs.append([seq, self._prefill_chunks(seq), 0])
            if not sched.running:
                head = sched.waiting[0]
                raise RuntimeError(
                    f"request {head.request.request_id}: context of "
                    f"{head.context_len} tokens needs "
                    f"{self.kv.blocks_for(head.context_len)} blocks but "
                    f"the pool only has {self.kv.allocator.num_allocatable}"
                    " allocatable — raise num_blocks or lower max_len"
                )
            # -- one prefill chunk, if any are pending --------------------
            if prefill_jobs:
                job = prefill_jobs[0]
                seq, chunks, idx = job
                if seq.slot is None:  # preempted mid-prefill: job is moot
                    prefill_jobs.pop(0)
                    continue
                start, c = chunks[idx]
                cb = self._bucket(c, start)
                buf = np.zeros((1, cb), np.int32)
                buf[0, :c] = seq.tokens[start:start + c]
                final_chunk = idx + 1 == len(chunks)
                tok, logp = self._prefill(
                    buf, self.kv.block_tables[seq.slot], start,
                    seq.context_len - 1 - start if final_chunk else c - 1,
                    _token_key(seq.sample_seed, seq.num_generated),
                )
                prefill_dispatches += 1
                job[2] = idx + 1
                if final_chunk:
                    prefill_jobs.pop(0)
                    # Publish the now-written PROMPT blocks for future
                    # admissions to adopt.
                    self.kv.insert_prefix(
                        seq.slot, seq.tokens[:seq.prompt_len]
                    )
                    self.kv.positions[seq.slot] = seq.context_len
                    commit(seq, tok, logp)
            # -- decode: every running slot whose prefill is done ---------
            mid_prefill = {
                id(j[0]) for j in prefill_jobs if j[0].slot is not None
            }
            ready = [s for s in sched.running if id(s) not in mid_prefill]
            # Grow each ready slot's table to cover its next write
            # position; under pool pressure evict the youngest runner
            # back to the queue (re-prefilled on re-admission).
            for seq in ready:
                if seq.slot is None:
                    continue  # evicted by an older peer this pass
                while not self.kv.reserve(seq.slot, seq.context_len):
                    victim = sched.preempt_youngest(self.kv, protect=seq)
                    if victim is None:
                        raise RuntimeError(
                            f"request {seq.request.request_id}: cannot "
                            f"back {seq.context_len} positions with "
                            f"{self.kv.num_blocks - 1} pool blocks even "
                            "alone — raise num_blocks"
                        )
                    preemptions += 1
                    victim.enqueued_at = elapsed()
                    prefill_jobs[:] = [
                        j for j in prefill_jobs if j[0] is not victim
                    ]
            ready = [s for s in ready if s.slot is not None]
            if not ready:
                continue
            tokens = np.zeros((self.max_slots,), np.int32)
            ready_mask = np.zeros((self.max_slots,), bool)
            keys = np.zeros((self.max_slots, 2), np.uint32)
            for seq in ready:
                tokens[seq.slot] = seq.last_token
                ready_mask[seq.slot] = True
                keys[seq.slot] = _token_key(
                    seq.sample_seed, seq.num_generated
                )
            # Slots that are free or mid-prefill get all-trash tables:
            # their scatter writes must not touch a live sequence's blocks.
            tables = np.where(
                ready_mask[:, None], self.kv.block_tables, np.int32(0)
            )
            positions = np.where(ready_mask, self.kv.positions, 0).astype(
                np.int32
            )
            sampled, logps = self._decode(tokens, tables, positions, keys)
            decode_steps += 1
            util_samples.append(self.kv.utilization())
            for seq in ready:
                self.kv.positions[seq.slot] = seq.context_len
                commit(seq, int(sampled[seq.slot]), float(logps[seq.slot]))
        total = elapsed()
        generated = int(
            sum(len(results[r.request_id]) - r.prompt.size for r in reqs)
        )
        vals = list(ttft.values())
        report = {
            "total_seconds": total,
            "generated_tokens": generated,
            "tokens_per_sec": generated / total if total > 0 else 0.0,
            "time_to_first_token": {
                "mean": float(np.mean(vals)),
                "p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "max": float(np.max(vals)),
            },
            "kv_utilization": {
                "mean": float(np.mean(util_samples)) if util_samples else 0.0,
                "peak": float(np.max(util_samples)) if util_samples else 0.0,
            },
            "decode_steps": decode_steps,
            "prefill_dispatches": prefill_dispatches,
            "preemptions": preemptions,
            "requests": [
                {
                    "request_id": s.request.request_id,
                    "admitted_s": s.admitted_at,
                    "first_token_s": s.first_token_at,
                    "finished_s": s.finished_at,
                    "preemptions": s.preemptions,
                    **({"logprobs": s.logprobs[: s.request.max_new_tokens]}
                       if return_logprobs else {}),
                }
                for s in seqs
            ],
        }
        if self.kv.prefix is not None:
            st = self.kv.prefix
            lookups = st.hits + st.misses
            report["prefix_cache"] = {
                "hit_rate": st.hits / lookups if lookups else 0.0,
                "hit_blocks": int(st.hits),
                "hit_tokens": int(prefix_hit_tokens),
                "insertions": int(st.insertions),
                "evictions": int(st.evictions),
                "cow_copies": int(self.kv.cow_copies),
                "kv_bytes_saved": int(st.hits * self.kv.bytes_per_block()),
            }
        self.last_run_telemetry = report
        return [results[r.request_id] for r in reqs]


__all__ = ["Engine"]
