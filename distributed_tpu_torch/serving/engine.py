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
hand-written CUDA kernel on a card. Everything runs under
``torch.inference_mode``.

The engine serves a SNAPSHOT: at construction it copies the model's module
(parameters and buffers, detached, without grad), and only
``update_weights`` changes what it serves, so ``fit`` or ``load_params``
on the model after the engine was built leave the served tokens alone, as
in the JAX engine. The copy costs the parameters' bytes once more in
device memory (a draft model's likewise).

Tensor parallelism: on a model built under ``DataTensorParallel``, or a
``CompositeParallel`` whose split axes are data and model, each rank
serves its blocks of the model line, as the JAX engine serves the
model's sharded tree: the snapshot copies the rank's blocks with their
layouts, the dispatches run inside the model's strategy scope (where the
layers compute with them, Megatron's pair joining the line), and every
attention layer's pool holds the rank's heads only. Every rank of the
line runs the same scheduler on the same requests (no decision reads the
clock) and takes the sampled tokens and logprobs of the line's first
rank (one broadcast a dispatch), so the ranks cannot part; ranks on
other data coordinates serve the same requests as replicas. Under any
other sharding strategy (FSDP, an fsdp, seq, expert or pipe axis) the
snapshot gathers every leaf whole; the JAX engine serves FSDP's row
blocks instead, with its pool's heads split over fsdp (ROADMAP 1.7b.8).

Speculative decoding (``draft_model`` + ``spec_k``): the draft proposes
``spec_k - 1`` greedy tokens a slot, one at a time, and the target scores
all ``spec_k`` candidates in one verify pass (``paged_verify``; under
``"fused"`` the paged kernel reads ``spec_k`` query rows a slot in one
launch); the host commits the longest run where the draft agreed with the
target's own token, so the output is token-exact against plain decode,
greedy or sampled. ``spec_k="adaptive"`` picks each round's width from
``SPEC_K_LADDER`` by per-tenant accept-rate EMAs.

Telemetry (``last_run_telemetry``, stored in ``obs.default_registry()``)
has the JAX engine's keys and rounding: the ``StepTimer`` stall buckets
(``queue_wait``, ``prefill``, ``draft``, ``decode``; host seconds, each
span ending after its tokens are on the host), TTFT, KV utilization,
queue depth, the per-request ``weights_versions`` spans, and the
``speculative`` block.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import List, Optional, Sequence as SequenceT

import numpy as np
import torch
import torch.distributed as dist

from ..nn.core import param_tree
from ..nn.attention import PositionalEmbedding
from ..obs import registry as obs_registry
from ..obs import spans as obs_spans
from ..ops import paged_attention as paged_ops
from ..ops._common import round_up
from ..parallel.collectives import layout_of, mark
from ..optim import EmaBaseline
from ..training.model import Model
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import threefry
from ..utils.profiler import StepTimer
from .kv_cache import PagedKVCache
from .scheduler import Request, Scheduler

_M64 = (1 << 64) - 1

#: Adaptive speculative-k ladder: the only verify widths an adaptive
#: engine dispatches (0 = draft off for that tenant, plain decode).
SPEC_K_LADDER = (0, 2, 4, 8)
#: Cold-start k for a tenant with no accept-rate evidence yet.
SPEC_K_DEFAULT = 4
#: Per-tenant accept-rate EMA decay (the first update adopts outright)
#: and the observation floor before the ladder reacts.
SPEC_EMA_DECAY = 0.7
SPEC_MIN_ROUNDS = 2


def _ladder_k(accept_ema: float) -> int:
    """Ladder rung for an accept-rate EMA: below 0.25 the draft's
    dispatches cost more than the verify saves at any k, so it switches
    off (the JAX engine's thresholds)."""
    if accept_ema < 0.25:
        return 0
    if accept_ema < 0.5:
        return 2
    if accept_ema < 0.75:
        return 4
    return 8


def _served_tree(module) -> dict:
    """``{tree path: parameter}`` of a served module, paths as
    ``Model.params`` gives them (a quantized weight's ``q`` and ``scale``
    buffers included)."""
    return param_tree(module)


def _serves_blocks(model) -> bool:
    """True when the engine serves each rank's Megatron blocks of
    ``model``: built under ``DataTensorParallel``, or under a
    ``CompositeParallel`` whose axes larger than 1 are data and model."""
    from ..parallel.strategy import CompositeParallel, DataTensorParallel

    st = model.strategy
    if isinstance(st, DataTensorParallel):
        return True
    return (isinstance(st, CompositeParallel) and st.model_axis is not None
            and all(n == 1 or a in ("data", "model")
                    for a, n in st.axis_sizes.items()))


def _snapshot(model, blocks: bool):
    """An engine-owned copy of ``model.module``: its parameters and
    buffers copied on their device, detached and without grad. With
    ``blocks`` (tensor parallelism) each leaf is this rank's block,
    marked with its layout, and nothing is gathered. Otherwise a leaf a
    strategy shards (FSDP) is gathered whole (every rank builds the
    engine) and the copy holds it unmarked (module docstring)."""
    live = model.live_params()
    full = (model.params if not blocks and any(
        layout_of(t) is not None for t in live.values()) else None)
    snap = copy.deepcopy(model.module)
    with torch.no_grad():
        for path, t in param_tree(snap).items():
            if full is not None:
                t.data = full[path].detach().clone()
            # A deep-copied Parameter drops its attributes: re-mark.
            mark(t, None if full is not None else layout_of(live[path]))
    for p in snap.parameters():
        p.requires_grad_(False)
        p.grad = None
    snap.eval()
    return snap


def _full_shape(t) -> tuple:
    """A served leaf's whole shape (its layout's, for a block)."""
    lay = layout_of(t)
    return tuple(lay.shape) if lay is not None else tuple(t.shape)


def _validate_swap(served: dict, params: dict, label: str) -> None:
    """Hot-swap gate of ``Engine.update_weights`` (target and draft arms):
    the paths, each leaf's whole shape (a served block's layout's) AND
    dtype must match the served tree exactly, or ``ValueError`` names the
    path."""
    if set(served) != set(params):
        raise ValueError(
            f"{label}: new param tree structure does not match the served "
            f"tree: missing {sorted(set(served) - set(params))}, unexpected "
            f"{sorted(set(params) - set(served))}"
        )
    for path, have in served.items():
        want = params[path]
        shape = tuple(getattr(want, "shape", ()))
        if shape != _full_shape(have):
            raise ValueError(
                f"{label}: shape mismatch at {path}: new weights have "
                f"{shape}, engine serves {_full_shape(have)}"
            )
        dtype = want.dtype if isinstance(want, torch.Tensor) else (
            torch.as_tensor(want).dtype)
        if dtype != have.dtype:
            raise ValueError(
                f"{label}: dtype mismatch at {path}: new weights are "
                f"{dtype}, engine serves {have.dtype}"
            )


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
    (R, V), ``keys`` (R, 2) uint32 token keys. Greedy (``temperature <=
    0``) takes the argmax and reports the unscaled log-likelihood;
    otherwise each row draws from its top_k-truncated, temperature-scaled
    softmax by the Gumbel-max trick with JAX's ``random.categorical``
    noise for its key, so both engines draw the same tokens (up to the
    last bit of ``log``)."""
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
        noise = threefry.gumbel_from_bits(threefry.row_bits(
            np.asarray(keys), logits.shape[-1], logits.device))
        toks = torch.argmax(scaled + noise, dim=-1)
    logp = logp_all.gather(1, toks[:, None])[:, 0]
    return toks, logp


class _PairedKV:
    """Target + draft paged caches moving in lockstep through the
    scheduler's seams (admit/reserve/release), so a slot holds blocks in
    both pools or in neither. The draft pool (fully provisioned) reserves
    first; a failed target admission rolls the draft's back."""

    def __init__(self, target: PagedKVCache, draft: PagedKVCache):
        self.target = target
        self.draft = draft

    def blocks_for(self, tokens: int) -> int:
        return self.target.blocks_for(tokens)

    def admit(self, slot: int, tokens):
        if not self.draft.reserve(slot, len(tokens)):
            return None
        cached = self.target.admit(slot, tokens)
        if cached is None:
            self.draft.release(slot)
            return None
        return cached

    def reserve(self, slot: int, upto_len: int) -> bool:
        if not self.draft.reserve(slot, upto_len):
            return False
        return self.target.reserve(slot, upto_len)

    def release(self, slot: int) -> None:
        self.target.release(slot)
        self.draft.release(slot)


def _precision_scope(precision):
    """A served model's precision policy: its layers compute in the
    policy's dtype, as in ``Model.generate``."""
    return (contextlib.nullcontext() if precision is None
            else precision.scope())


def _strategy_scope(strategy):
    """The served model's strategy scope, under tensor parallelism (where
    the layers compute with their blocks), else none."""
    return contextlib.nullcontext() if strategy is None else strategy.scope()


def _line_agree(strategy, toks, logp):
    """The model line's first rank's sampled ``toks`` and ``logp`` on
    every rank of the line (one broadcast of both), so the ranks' next
    dispatches and admissions cannot part; ``strategy`` None: as they
    are."""
    if strategy is None:
        return toks, logp
    group = strategy.tp_group
    both = torch.stack([toks.to(torch.float64), logp.to(torch.float64)])
    dist.broadcast(both, src=dist.get_global_rank(group, 0), group=group)
    return both[0].to(toks.dtype), both[1].to(logp.dtype)


def _on(device, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _prefill_dispatch(module, precision, device, kv, tokens, block_table,
                      start, last_idx, key, temperature, top_k,
                      strategy=None):
    """One prompt chunk for one sequence on ``module``: KV scattered into
    its blocks of ``kv`` and the next token sampled from position
    ``last_idx``; returns (token, logprob) on the host. The Engine and the
    fleet's ``EnginePrograms`` both dispatch through it. ``strategy``:
    the tensor-parallel strategy whose blocks ``module`` holds (the
    pass runs in its scope and the line agrees on the sample)."""
    with _strategy_scope(strategy), _precision_scope(precision):
        out, kv.caches = module.paged_prefill(
            kv.caches, _on(device, tokens),
            block_table=_on(device, block_table), start=int(start),
        )
    tok, logp = _line_agree(strategy, *_sample_with_logprob(
        out[0, last_idx:last_idx + 1], key[None], temperature, top_k))
    return int(tok[0]), float(logp[0])


def _decode_dispatch(module, precision, device, kv, tokens, block_tables,
                     positions, keys, temperature, top_k, decode_kernel,
                     strategy=None):
    """One decode (tokens (S,)) or verify (tokens (S, K), keys (S, K, 2))
    pass of ``module`` over every slot of ``kv``; the sampled tokens and
    logprobs come back on the host, shaped as ``tokens``. The Engine and
    the fleet's ``EnginePrograms`` both dispatch through it. ``strategy``
    as for :func:`_prefill_dispatch`."""
    t = _on(device, tokens)
    kw = {"block_tables": _on(device, block_tables),
          "positions": _on(device, positions),
          "decode_kernel": decode_kernel}
    with _strategy_scope(strategy), _precision_scope(precision):
        if t.dim() == 1:
            logits, kv.caches = module.paged_decode(kv.caches, t[:, None],
                                                    **kw)
        else:
            logits, kv.caches = module.paged_verify(kv.caches, t, **kw)
    toks, logp = _line_agree(strategy, *_sample_with_logprob(
        logits.reshape(-1, logits.shape[-1]),
        np.asarray(keys).reshape(-1, 2), temperature, top_k))
    shape = np.shape(tokens)
    return (toks.cpu().numpy().reshape(shape),
            logp.cpu().numpy().reshape(shape))


class _Served:
    """One served LM: the engine's snapshot of its module, the tree that
    ``update_weights`` swaps into, its paged pools (``kv``, made by
    :meth:`pools`), and under tensor parallelism the strategy whose
    blocks it serves (``strategy``; None: served whole)."""

    def __init__(self, model: Model):
        blocks = _serves_blocks(model)
        self.strategy = model.strategy if blocks else None
        self.module = _snapshot(model, blocks)
        self.params = _served_tree(self.module)
        self.device = model.device
        self.precision = model.precision
        self.kv: Optional[PagedKVCache] = None

    def pools(self, **kw) -> PagedKVCache:
        """The module's paged pools (``PagedKVCache(**kw)``), made in the
        strategy's scope: a rank's attention pools hold its heads."""
        with _strategy_scope(self.strategy):
            self.kv = PagedKVCache(self.module, device=self.device, **kw)
        return self.kv

    def swap(self, params: dict) -> None:
        """Copy the whole tree ``params`` into the snapshot in place (each
        served block takes its block of the whole leaf) and wait until
        the card has them (the next pass must read them, and the caller's
        timing must cover the copy)."""
        with torch.no_grad():
            for path, t in self.params.items():
                new = torch.as_tensor(params[path])
                lay = layout_of(t)
                t.copy_(new if lay is None else new[lay.index()])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, tokens, block_table, start, last_idx, key,
                temperature, top_k):
        return _prefill_dispatch(self.module, self.precision, self.device,
                                 self.kv, tokens, block_table, start,
                                 last_idx, key, temperature, top_k,
                                 self.strategy)

    def step(self, tokens, block_tables, positions, keys, temperature,
             top_k, decode_kernel):
        return _decode_dispatch(self.module, self.precision, self.device,
                                self.kv, tokens, block_tables, positions,
                                keys, temperature, top_k, decode_kernel,
                                self.strategy)


def _bucket(c: int, start: int, max_len: int) -> int:
    """Chunk lengths round up to a multiple of 64 (the JAX engine's
    compile buckets), capped so the padded chunk never runs past
    ``max_len``: the positional rows and block indices must stay inside
    their tables. The fleet's replicas pad the same way."""
    return min(max(64, round_up(c, 64)), max_len - start)


def _check_positions(model: Model, max_len: int) -> None:
    """A learned positional table shorter than ``max_len`` fails here,
    not mid-serve."""
    for m in model.module.modules():
        if isinstance(m, PositionalEmbedding) and max_len > m.max_len:
            raise ValueError(
                f"generation length {max_len} exceeds positional table "
                f"max_len {m.max_len}"
            )


def _version_spans(versions):
    """Per-token weight versions as [{"version", "tokens"}] runs."""
    spans = []
    for v in versions:
        if spans and spans[-1]["version"] == v:
            spans[-1]["tokens"] += 1
        else:
            spans.append({"version": int(v), "tokens": 1})
    return spans


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
    (refcounted, copy-on-write). ``kv_dtype="int8"`` stores the target's
    pools as int8 with per-(position, head) scales; None uses
    ``model.decode_dtype()``. ``decode_kernel``: "reference" (default, as
    in the JAX engine) or "fused" (see the module docstring).

    ``draft_model`` + ``spec_k``: speculative decoding (module docstring).
    The draft must be a built LM over the same vocabulary; it keeps its
    own fully provisioned pool in ``draft_model.decode_dtype()`` (never
    int8), re-prefills fully on (re-)admission, and decodes greedily
    whatever the engine's temperature. ``spec_k`` is an int >= 2 or
    ``"adaptive"``.
    """

    def __init__(self, model: Model, max_slots: int, block_size: int, *,
                 max_len: int = 512, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 prefix_cache: bool = False, kv_dtype=None,
                 draft_model: Optional[Model] = None, spec_k=4,
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
        self._weights_version = 0
        _check_positions(model, self.max_len)
        nb_per_seq = -(-self.max_len // self.block_size)
        if num_blocks is None:
            num_blocks = self.max_slots * nb_per_seq + 1
        self._target = _Served(model)
        self.kv = self._target.pools(
            max_slots=self.max_slots, block_size=self.block_size,
            max_blocks_per_seq=nb_per_seq, num_blocks=int(num_blocks),
            dtype=torch.int8 if kv_dtype is not None else model.decode_dtype(),
            prefix_cache=bool(prefix_cache),
        )
        # spec_k="adaptive": the round's width comes from SPEC_K_LADDER;
        # headroom and reservations use the ladder's max.
        self._adaptive_k = spec_k == "adaptive"
        if self._adaptive_k:
            self._spec_k = SPEC_K_LADDER[-1]
        elif isinstance(spec_k, str):
            raise ValueError(
                f"spec_k must be an int >= 2 or 'adaptive', got {spec_k!r}"
            )
        else:
            self._spec_k = int(spec_k)
        self._accept_ema = {}     # tenant -> EmaBaseline of round accepts
        self._tenant_k = {}       # tenant -> current ladder k
        self._tenant_rounds = {}  # tenant -> speculative rounds observed
        self._tenant_moved = {}   # tenant -> round of its last rung move
        self._k_adjustments = 0
        self._draft = draft_model
        if draft_model is not None:
            if not draft_model.built:
                raise RuntimeError("draft model not built")
            if self._spec_k < 2:
                raise ValueError(
                    f"spec_k must be >= 2 (k=1 is plain decode), got "
                    f"{spec_k}"
                )
            _check_positions(draft_model, self.max_len)
            self._draft_served = _Served(draft_model)
            self._draft_kv = self._draft_served.pools(
                max_slots=self.max_slots, block_size=self.block_size,
                max_blocks_per_seq=nb_per_seq,
                num_blocks=self.max_slots * nb_per_seq + 1,
                dtype=draft_model.decode_dtype(),
            )
            self._kvs = _PairedKV(self.kv, self._draft_kv)
        else:
            self._draft_kv = None
            self._kvs = self.kv
            self._draft_served = None
        # Draft staleness: target swaps the served draft has not been
        # re-synced across (0 = in sync). Acceptance only: every proposal
        # is verified by the live target.
        self._draft_version = 0
        self._draft_staleness = 0
        events_lib.emit(evs.DECODE_KERNEL_SELECTED,
                        kernel=self.decode_kernel, backend=self.device.type)
        self.last_run_telemetry = None
        self._sched: Optional[Scheduler] = None  # live during run()

    # ------------------------------------------------------- live signals
    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot right now (0 when idle)."""
        return len(self._sched.waiting) if self._sched is not None else 0

    @property
    def free_blocks(self) -> int:
        """KV pool blocks currently unallocated: the admission headroom."""
        return self.kv.allocator.num_free

    # --------------------------------------------------------- weight swap
    @property
    def weights_version(self) -> int:
        """Served-weight generation: 0 for the construction-time snapshot,
        +1 per ``update_weights``. Recorded per generated token."""
        return self._weights_version

    def update_weights(self, params=None, *, draft_params=None) -> int:
        """Hot-swap the served weights without a restart, as the JAX
        engine's ``update_weights``: validate the new ``{tree path:
        tensor}`` tree (``Model.params``' form: every leaf whole) against
        the served one, copy it into the engine's snapshot (under tensor
        parallelism each rank its blocks, as the JAX engine places the
        tree), synchronize, and bump ``weights_version``. Returns the new
        version.

        In-flight sequences keep their KV (written by the old weights) and
        finish under the new ones; their per-token ``weights_versions``
        record the boundary. The prefix store is flushed, so no new
        request seeds from blocks computed under old weights. Paths,
        shapes and dtypes must match exactly (``ValueError`` otherwise);
        state (buffers) is not swapped.

        ``draft_params``: re-sync the draft's snapshot the same way. A
        target swap without it leaves the draft one version staler
        (``draft_staleness``); a sync emits ``draft_sync``."""
        if params is None and draft_params is None:
            raise ValueError(
                "update_weights: pass params, draft_params, or both"
            )
        if draft_params is not None and self._draft is None:
            raise ValueError(
                "update_weights: draft_params given but the engine has no "
                "draft model"
            )
        if params is not None:
            _validate_swap(self._target.params, params, "update_weights")
        if draft_params is not None:
            _validate_swap(self._draft_served.params, draft_params,
                           "update_weights(draft_params)")
        if params is not None:
            self._target.swap(params)
            self._weights_version += 1
            if self.kv.prefix is not None:
                self.kv.prefix.flush(self.kv.allocator)
            if self._draft is not None and draft_params is None:
                self._draft_staleness += 1
        if draft_params is not None:
            self._draft_served.swap(draft_params)
            staleness = self._draft_staleness
            self._draft_version = self._weights_version
            self._draft_staleness = 0
            events_lib.emit(
                evs.DRAFT_SYNC,
                weights_version=int(self._weights_version),
                staleness=int(staleness),
                source="update_weights",
            )
        return self._weights_version

    # ------------------------------------------------------------- helpers
    def _bucket(self, c: int, start: int) -> int:
        return _bucket(c, start, self.max_len)

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

    def _draft_prefill(self, seq):
        """Draft prefill of the FULL context (the draft has no prefix
        store), chunk-bucketed like the target; the sampled continuation
        is discarded (proposals start from the target's token)."""
        n = seq.context_len
        step = self.prefill_chunk or n
        for start in range(0, n, step):
            c = min(step, n - start)
            buf = np.zeros((1, self._bucket(c, start)), np.int32)
            buf[0, :c] = seq.tokens[start:start + c]
            self._draft_served.prefill(
                buf, self._draft_kv.block_tables[seq.slot], start, c - 1,
                _token_key(seq.sample_seed, 0), 0.0, None)
        self._draft_kv.positions[seq.slot] = n

    def _observe_accept(self, seq, frac: float) -> None:
        """Fold one round's accept fraction (accepted / proposed, this
        slot) into its tenant's EMA and re-pick the tenant's rung. The rung
        moves only after SPEC_MIN_ROUNDS observations, and then dwells
        SPEC_MIN_ROUNDS more between moves; each move emits
        ``spec_k_adjust``."""
        tenant = str(getattr(seq, "tenant", "default"))
        ema = self._accept_ema.get(tenant)
        if ema is None:
            ema = self._accept_ema[tenant] = EmaBaseline(SPEC_EMA_DECAY)
        ema.update(float(frac))
        rounds = self._tenant_rounds.get(tenant, 0) + 1
        self._tenant_rounds[tenant] = rounds
        if rounds < SPEC_MIN_ROUNDS:
            return
        if rounds - self._tenant_moved.get(tenant, 0) < SPEC_MIN_ROUNDS:
            return
        old = self._tenant_k.get(tenant, SPEC_K_DEFAULT)
        new = _ladder_k(float(ema.value))
        self._tenant_k[tenant] = new
        if new != old:
            self._k_adjustments += 1
            self._tenant_moved[tenant] = rounds
            events_lib.emit(
                evs.SPEC_K_ADJUST, tenant=tenant, old_k=int(old),
                new_k=int(new), accept_ema=round(float(ema.value), 4),
                rounds=int(rounds),
            )

    # ---------------------------------------------------------------- run
    def run(self, requests: SequenceT, *, return_logprobs: bool = False,
            on_decode_step=None, tenants=None) -> List[np.ndarray]:
        """Serve ``requests`` (``serving.Request``s, or (prompt,
        max_new_tokens) pairs) to completion; returns each request's
        prompt+generated tokens in submission order. Telemetry lands in
        ``last_run_telemetry``; ``return_logprobs=True`` adds each
        generated token's sampling logprob to its request row.

        ``on_decode_step``: optional ``fn(engine, decode_step)`` called
        after every decode or verify pass (e.g. ``update_weights``
        mid-run). ``tenants``: optional per-request tenant names (the
        identity the adaptive spec_k EMAs key on; default "default")."""
        with torch.inference_mode():
            return self._run(requests, return_logprobs, on_decode_step,
                             tenants)

    def _run(self, requests, return_logprobs, on_decode_step, tenants):
        reqs = [
            r if isinstance(r, Request) else Request(r[0], r[1])
            for r in requests
        ]
        if tenants is not None and len(tenants) != len(reqs):
            raise ValueError(
                f"tenants covers {len(tenants)} requests but "
                f"{len(reqs)} were submitted"
            )
        # A speculating engine needs spec_k - 1 positions of table
        # headroom past the last committed token: the verify pass writes K
        # consecutive candidate rows.
        headroom = self._spec_k - 1 if self._draft is not None else 0
        for r in reqs:
            need = r.prompt.size + r.max_new_tokens
            if need > self.max_len - headroom:
                raise ValueError(
                    f"request {r.request_id}: prompt {r.prompt.size} + "
                    f"max_new_tokens {r.max_new_tokens} exceeds engine "
                    f"max_len {self.max_len}"
                    + (
                        f" minus speculative headroom spec_k-1={headroom}"
                        if self._draft is not None else ""
                    )
                )
        timer = StepTimer()
        obs_reg = obs_registry.default_registry()
        sched = Scheduler(self.max_slots)
        self._sched = sched
        t0 = time.perf_counter()
        seqs = [sched.submit(r, now=0.0) for r in reqs]
        for i, seq in enumerate(seqs):
            r = seq.request
            seq.sample_seed = _mix_seed(
                self.seed, r.seed if r.seed is not None else r.request_id
            )
            seq.tenant = (
                str(tenants[i]) if tenants is not None else "default"
            )
            seq.spec_proposed = 0
            seq.spec_accepted = 0
            seq.spec_tokens = 0
        version_at_start = self._weights_version
        results = {}
        ttft = {}
        util_samples = []
        queue_samples = []
        free_blocks_min = self.kv.allocator.num_free
        decode_steps = 0
        prefill_dispatches = 0
        preemptions = 0
        prefix_hit_tokens = 0
        spec_rounds = spec_proposed = spec_accepted = spec_tokens = 0
        # (seq, chunk list, next chunk index): at most ONE chunk runs per
        # loop iteration, so running sequences keep decoding between a
        # long prompt's chunks.
        prefill_jobs = []

        def elapsed():
            return time.perf_counter() - t0

        def finish(seq):
            sched.finish(seq, self._kvs)
            seq.finished_at = elapsed()
            results[seq.request.request_id] = seq.output()

        def commit(seq, tok, logp):
            """Append one generated token; True when ``seq`` stops."""
            seq.tokens.append(tok)
            seq.token_versions.append(self._weights_version)
            if return_logprobs:
                seq.logprobs.append(float(logp))
            seq.num_generated += 1
            if seq.num_generated == 1:
                ttft[seq.request.request_id] = seq.first_token_at = elapsed()
            return seq.finished or tok == self.eos_id

        def sample_step(ready, sp_dec):
            util = self.kv.utilization()
            util_samples.append(util)
            queue_samples.append(len(sched.waiting))
            nonlocal free_blocks_min
            free_blocks_min = min(free_blocks_min, self.kv.allocator.num_free)
            obs_reg.gauge("engine/kv_utilization", float(util))
            obs_reg.gauge("engine/queue_depth", len(sched.waiting))
            obs_reg.ring_append("engine/step_seconds", {
                "step": int(decode_steps),
                "seconds": round(sp_dec.seconds, 6),
                "running": len(ready),
            })

        while not (sched.idle and not prefill_jobs):
            # -- admit: fill every free slot the pool can back ------------
            while True:
                seq = sched.next_admittable(self._kvs)
                if seq is None:
                    break
                timer.attribute("queue_wait", elapsed() - seq.enqueued_at)
                if seq.admitted_at is None:
                    seq.admitted_at = elapsed()
                if seq.cached_len > 0:
                    prefix_hit_tokens += seq.cached_len
                    events_lib.emit(
                        evs.PREFIX_CACHE_HIT,
                        request_id=int(seq.request.request_id),
                        cached_tokens=int(seq.cached_len),
                        blocks=seq.cached_len // self.block_size,
                    )
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
                buf = np.zeros((1, self._bucket(c, start)), np.int32)
                buf[0, :c] = seq.tokens[start:start + c]
                final_chunk = idx + 1 == len(chunks)
                with obs_spans.span("prefill", timer=timer):
                    tok, logp = self._target.prefill(
                        buf, self.kv.block_tables[seq.slot], start,
                        seq.context_len - 1 - start if final_chunk else c - 1,
                        _token_key(seq.sample_seed, seq.num_generated),
                        self.temperature, self.top_k,
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
                    if self._draft is not None:
                        self._draft_prefill(seq)
                    self.kv.positions[seq.slot] = seq.context_len
                    if commit(seq, tok, logp):
                        finish(seq)
            # -- decode: every running slot whose prefill is done ---------
            mid_prefill = {
                id(j[0]) for j in prefill_jobs if j[0].slot is not None
            }
            ready = [s for s in sched.running if id(s) not in mid_prefill]
            # Grow each ready slot's table to cover its next write
            # positions (spec_k - 1 more when speculating); under pool
            # pressure evict the youngest runner back to the queue.
            for seq in ready:
                if seq.slot is None:
                    continue  # evicted by an older peer this pass
                while not self._kvs.reserve(
                        seq.slot, seq.context_len + headroom):
                    victim = sched.preempt_youngest(self._kvs, protect=seq)
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
            # Round width: the static spec_k, or (adaptive) the max of the
            # ready tenants' rungs, each slot's walk capped at its own
            # tenant's k. kw < 2 falls through to plain decode.
            kw = 0
            slot_limit = None
            if self._draft is not None:
                if self._adaptive_k:
                    slot_limit = {
                        id(s): self._tenant_k.get(s.tenant, SPEC_K_DEFAULT)
                        for s in ready
                    }
                    kw = max(slot_limit.values())
                else:
                    kw = self._spec_k
            ready_mask = np.zeros((self.max_slots,), bool)
            for seq in ready:
                ready_mask[seq.slot] = True
            # Slots that are free or mid-prefill get all-trash tables: their
            # writes must not touch a live sequence's blocks.
            tables = np.where(
                ready_mask[:, None], self.kv.block_tables, np.int32(0)
            )
            positions = np.where(ready_mask, self.kv.positions, 0).astype(
                np.int32
            )
            if kw >= 2:
                # ---- speculative round: the candidate matrix's column 0
                # is each slot's real last token, columns 1..K-1 the
                # draft's greedy chain; one K-wide verify scores them all.
                cand = np.zeros((self.max_slots, kw), np.int32)
                keys = np.zeros((self.max_slots, kw, 2), np.uint32)
                for seq in ready:
                    cand[seq.slot, 0] = seq.last_token
                    for j in range(kw):
                        keys[seq.slot, j] = _token_key(
                            seq.sample_seed, seq.num_generated + j
                        )
                dtables = np.where(
                    ready_mask[:, None], self._draft_kv.block_tables,
                    np.int32(0),
                )
                dpos = np.where(
                    ready_mask, self._draft_kv.positions, 0
                ).astype(np.int32)
                dummy_keys = np.zeros((self.max_slots, 2), np.uint32)
                with obs_spans.span("draft", timer=timer):
                    for j in range(1, kw):
                        prop, _ = self._draft_served.step(
                            cand[:, j - 1], dtables, dpos, dummy_keys, 0.0,
                            None, self.decode_kernel)
                        cand[:, j] = prop
                        # Non-speculating slots advance through the trash
                        # block.
                        dpos = (dpos + 1).astype(np.int32)
                with obs_spans.span("decode", timer=timer) as sp_dec:
                    toks, logps = self._target.step(
                        cand, tables, positions, keys, self.temperature,
                        self.top_k, self.decode_kernel)
                decode_steps += 1
                spec_rounds += 1
                sample_step(ready, sp_dec)
                for seq in ready:
                    # A slot commits at most its own tenant's k columns
                    # (k=0 commits exactly column 0, the plain-decode
                    # token).
                    limit = (kw if slot_limit is None
                             else max(1, slot_limit[id(seq)]))
                    m = 0
                    while True:
                        tok = int(toks[seq.slot, m])
                        stop = commit(seq, tok, logps[seq.slot, m])
                        m += 1
                        if stop:
                            break
                        # Accept the next column only if the draft
                        # proposed there the token the target just
                        # produced: then its logits saw the true prefix.
                        if m >= limit or int(cand[seq.slot, m]) != tok:
                            break
                    spec_tokens += m
                    spec_accepted += m - 1
                    spec_proposed += limit - 1
                    seq.spec_tokens += m
                    seq.spec_accepted += m - 1
                    seq.spec_proposed += limit - 1
                    if self._adaptive_k and limit >= 2:
                        self._observe_accept(seq, (m - 1) / (limit - 1))
                    # positions = committed rows = the next write, in
                    # both pools.
                    self.kv.positions[seq.slot] = seq.context_len - 1
                    self._draft_kv.positions[seq.slot] = seq.context_len - 1
                    if seq.finished or seq.last_token == self.eos_id:
                        finish(seq)
            else:
                tokens = np.zeros((self.max_slots,), np.int32)
                keys = np.zeros((self.max_slots, 2), np.uint32)
                for seq in ready:
                    tokens[seq.slot] = seq.last_token
                    keys[seq.slot] = _token_key(
                        seq.sample_seed, seq.num_generated
                    )
                with obs_spans.span("decode", timer=timer) as sp_dec:
                    sampled, logps = self._target.step(
                        tokens, tables, positions, keys, self.temperature,
                        self.top_k, self.decode_kernel)
                decode_steps += 1
                sample_step(ready, sp_dec)
                for seq in ready:
                    self.kv.positions[seq.slot] = seq.context_len
                    if commit(seq, int(sampled[seq.slot]), logps[seq.slot]):
                        finish(seq)
            if on_decode_step is not None:
                on_decode_step(self, decode_steps)
        self._sched = None
        report = self._report(
            timer, reqs, seqs, results, ttft, util_samples, queue_samples,
            return_logprobs, version_at_start)
        report["free_blocks_min"] = int(free_blocks_min)
        report["decode_steps"] = decode_steps
        report["prefill_dispatches"] = prefill_dispatches
        report["preemptions"] = preemptions
        if self.kv.prefix is not None:
            st = self.kv.prefix
            lookups = st.hits + st.misses
            hit_rate = st.hits / lookups if lookups else 0.0
            bytes_saved = st.hits * self.kv.bytes_per_block()
            report["prefix_cache"] = {
                "hit_rate": round(hit_rate, 4),
                "hit_blocks": int(st.hits),
                "hit_tokens": int(prefix_hit_tokens),
                "insertions": int(st.insertions),
                "evictions": int(st.evictions),
                "cow_copies": int(self.kv.cow_copies),
                "kv_bytes_saved": int(bytes_saved),
            }
            obs_reg.gauge("engine/prefix_hit_rate", round(hit_rate, 4))
            obs_reg.gauge("engine/kv_bytes_saved", int(bytes_saved))
        if self._draft is not None:
            accept_rate = (
                spec_accepted / spec_proposed if spec_proposed else 0.0
            )
            tpd = spec_tokens / spec_rounds if spec_rounds else 0.0
            report["speculative"] = {
                "k": "adaptive" if self._adaptive_k else int(self._spec_k),
                "rounds": int(spec_rounds),
                "proposed": int(spec_proposed),
                "accepted": int(spec_accepted),
                "accept_rate": round(accept_rate, 4),
                "tokens_per_dispatch": round(tpd, 3),
                "draft_version": int(self._draft_version),
                "draft_staleness": int(self._draft_staleness),
                **(
                    {
                        "max_k": int(self._spec_k),
                        "tenant_k": {
                            t: int(k)
                            for t, k in sorted(self._tenant_k.items())
                        },
                        "k_adjustments": int(self._k_adjustments),
                    }
                    if self._adaptive_k else {}
                ),
            }
            obs_reg.gauge("engine/spec_accept_rate", round(accept_rate, 4))
            # One per-run aggregate (the transport fsyncs per record).
            events_lib.emit(
                evs.SPEC_VERIFY, rounds=int(spec_rounds),
                proposed=int(spec_proposed), accepted=int(spec_accepted),
                accept_rate=round(accept_rate, 4),
                tokens_per_dispatch=round(tpd, 3),
            )
        obs_reg.counter("engine/generated_tokens", report["generated_tokens"])
        obs_reg.counter("engine/requests", len(reqs))
        obs_reg.counter("engine/preemptions", preemptions)
        obs_reg.gauge("engine/tokens_per_sec", report["tokens_per_sec"])
        self.last_run_telemetry = obs_reg.set_report("engine.run", report)
        return [results[r.request_id] for r in reqs]

    def _report(self, timer, reqs, seqs, results, ttft, util_samples,
                queue_samples, return_logprobs, version_at_start):
        """The run's report, key for key and rounded as the JAX engine's:
        the timer's stall buckets, KV utilization, tokens, TTFT, the
        per-request rows and the weight-version and queue fields."""
        report = timer.stall_report()
        report["kv_utilization"] = {
            "mean": round(float(np.mean(util_samples)), 4)
            if util_samples else 0.0,
            "peak": round(float(np.max(util_samples)), 4)
            if util_samples else 0.0,
        }
        report["generated_tokens"] = int(
            sum(len(results[r.request_id]) - r.prompt.size for r in reqs)
        )
        report["tokens_per_sec"] = round(
            report["generated_tokens"] / report["total_seconds"], 3
        )
        vals = list(ttft.values())
        report["time_to_first_token"] = {
            "mean": round(float(np.mean(vals)), 4),
            "p50": round(float(np.percentile(vals, 50)), 4),
            "p99": round(float(np.percentile(vals, 99)), 4),
            "max": round(float(np.max(vals)), 4),
        }
        report["requests"] = [
            {
                "request_id": s.request.request_id,
                "enqueued_s": round(float(s.submitted_at), 4),
                "admitted_s": round(float(s.admitted_at), 4),
                "first_token_s": round(float(s.first_token_at), 4),
                "finished_s": round(float(s.finished_at), 4),
                "preemptions": s.preemptions,
                "weights_versions": _version_spans(
                    s.token_versions[: s.request.max_new_tokens]
                ),
                **(
                    {
                        "spec_tokens": int(s.spec_tokens),
                        "spec_proposed": int(s.spec_proposed),
                        "accept_rate": (
                            round(s.spec_accepted / s.spec_proposed, 4)
                            if s.spec_proposed else None
                        ),
                    }
                    if self._draft is not None else {}
                ),
                **(
                    {"logprobs": [
                        float(lp) for lp in
                        s.logprobs[: s.request.max_new_tokens]
                    ]}
                    if return_logprobs else {}
                ),
            }
            for s in seqs
        ]
        report["weights_version"] = self._weights_version
        report["weight_swaps"] = self._weights_version - version_at_start
        report["queue_depth"] = {
            "mean": round(float(np.mean(queue_samples)), 4)
            if queue_samples else 0.0,
            "peak": int(np.max(queue_samples)) if queue_samples else 0,
        }
        return report


__all__ = ["Engine", "SPEC_K_DEFAULT", "SPEC_K_LADDER"]
