"""Prefill→decode KV-block handoff (the disaggregation contract).

A prefill replica computes a request's prompt KV into its OWN paged pool;
the decode replica that will run the request owns a DIFFERENT pool with
different free blocks. The handoff payload is the bridge: the sequence's
blocks, gathered to host in logical order and keyed by the
``ShardedCheckpointer`` block-layout idiom — ``<leaf-path>@<starts>@<shape>``
(``checkpoint.sharded._block_key``), where ``starts`` is the LOGICAL block
offset of the run within the sequence, not a pool index. Pool block ids are
absent from the payload: placement is the receiver's business. The decode
side scatters each run into whatever blocks its own allocator granted.

The keys and the host arrays are the JAX package's (``fleet/handoff.py``):
the leaf paths are the pool tree's (``interop.iter_leaf_paths``), so a
payload packed by either package installs into the other's pool. Pools
below a ``stacked`` key (``nn.ScannedBlocks``) keep their blocks on axis 1.

**bf16 pools.** numpy has no bfloat16, so a bf16 leaf travels as its raw
16 bits (``uint16`` host arrays) and the payload's ``dtype`` names
``bfloat16``; install views the bits back, so the round trip is exact.
f32 and int8 pools (``q`` int8, ``scale`` f32) travel as themselves,
byte for byte the JAX package's payloads.

**On the card** each leaf is one indexed gather into a pinned host buffer
(all leaves' copies queued, then one wait), and install one indexed
scatter per leaf and run from a pinned staging buffer.

When transfer is unavailable (``ServingFleet(transfer="none")``), or the
pools disagree on block size / dtype / layer structure,
:func:`install_kv` raises :class:`HandoffIncompatible` and the fleet falls
back to RE-PREFILLING the context on the decode replica — the scheduler's
preemption-requeue semantics (token-exact under greedy), paid as recompute
instead of transfer.

**Suffix-only shipping.** When the decode side runs a prefix store, the
sender attaches the prompt's chain hashes (``serving.kv_cache.
_chain_hashes``) and :func:`trim_kv` drops the leading blocks the
receiver already holds: only the non-cached SUFFIX travels. If the store
evicted between trim and admission, the receiver detects the gap
(``payload.skip_blocks`` exceeds its adopted span) and falls back to
re-prefill — never a silent hole in the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.sharded import _block_key, _parse_key
from ..interop import iter_leaf_paths
from ..serving.kv_cache import _chain_hashes

__all__ = [
    "KVHandoff", "HandoffIncompatible", "pack_kv", "install_kv", "trim_kv",
    "pack_prefix", "adopt_prefix",
]

#: Pool dtypes numpy cannot hold: carried as their raw bits, host dtype.
_BITS = {torch.bfloat16: np.dtype(np.uint16)}


class HandoffIncompatible(ValueError):
    """The payload cannot be installed into this pool (block size, dtype,
    or layer-structure mismatch) — the caller must re-prefill instead."""


def _block_axis(path: str) -> int:
    """Pool-block axis for the leaf at ``path``: 0 for ordinary per-layer
    pools, 1 below a ``stacked`` key (``nn.scan.STACKED_POOL_KEY``),
    whose leading dim is the block stack."""
    return 1 if "stacked" in path.split("/") else 0


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool leaf of ``dtype`` travels as."""
    bits = _BITS.get(dtype)
    if bits is not None:
        return bits
    return torch.empty((), dtype=dtype).numpy().dtype


def _gather(kv, ids) -> Tuple[Dict[str, np.ndarray], str]:
    """``{block key: host array}`` of pool blocks ``ids`` in every leaf,
    and the last leaf's dtype name (JAX's descriptive ``dtype``). One
    indexed gather a leaf; on the card into pinned buffers, every copy
    queued before the one wait."""
    leaves = list(iter_leaf_paths(kv.caches))
    idx = torch.as_tensor(np.asarray(ids, np.int64),
                          device=leaves[0][1].device)
    staged = []
    for path, pool in leaves:
        part = pool.index_select(_block_axis(path), idx)
        if part.dtype in _BITS:
            part = part.view(torch.int16)
        if pool.is_cuda:
            host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
            host.copy_(part, non_blocking=True)
            part = host
        staged.append((path, pool.dtype, part))
    if any(p.is_pinned() for _, _, p in staged):
        torch.cuda.synchronize()
    blocks = {}
    dtype = ""
    for path, pool_dtype, part in staged:
        data = part.numpy().view(_host_dtype(pool_dtype))
        blocks[_block_key(path, (0,) * data.ndim, data.shape)] = data
        dtype = _dtype_name(pool_dtype)
    return blocks, dtype


def _to_pool(data: np.ndarray, pool: torch.Tensor) -> torch.Tensor:
    """A host run as a tensor of ``pool``'s dtype on its device (bf16 from
    its bits), through a pinned staging buffer on the card."""
    bits = pool.dtype in _BITS
    dtype = torch.int16 if bits else pool.dtype
    stage = torch.empty(data.shape, dtype=dtype,
                        pin_memory=pool.is_cuda)
    stage.numpy()[...] = data.view(np.int16) if bits else data
    out = stage.to(pool.device, non_blocking=True)
    return out.view(pool.dtype) if bits else out


def _scatter(pool: torch.Tensor, ax: int, dst: List[int],
             data: np.ndarray) -> None:
    idx = torch.as_tensor(np.asarray(dst, np.int64), device=pool.device)
    pool.index_copy_(ax, idx, _to_pool(data, pool))


@dataclasses.dataclass
class KVHandoff:
    """One sequence's cached KV, detached from any pool.

    ``blocks`` maps ``<leaf-path>@<logical-block-start>@<shape>`` to a host
    array of shape ``(n_blocks, block_size, ...)`` — the sequence's blocks
    for that attention layer, in logical order (a bf16 leaf as its uint16
    bits). ``cached_len`` is the number of POSITIONS cached (the prefilled
    context; the first generated token's KV is NOT included — its row is
    written by the receiver's first decode step).

    ``dtype`` is descriptive (the last pool leaf's dtype name); the
    compatibility check is per leaf at install time, because a quantized
    int8 pool flattens to MIXED leaves (int8 ``q`` plus float32 ``scale``).

    ``prefix_hashes`` are the prompt's chain hashes (one per FULL block)
    and ``skip_blocks`` how many leading blocks :func:`trim_kv` dropped
    because the receiver's prefix store already held them.

    ``weights_version`` stamps which weights the KV was computed under
    (gossip payloads; None = unstamped). :func:`adopt_prefix` refuses a
    stamp mismatch — stale blocks never outlive ``update_weights`` by
    travelling."""

    blocks: Dict[str, np.ndarray]
    cached_len: int
    block_size: int
    dtype: str
    prefix_hashes: tuple = ()
    skip_blocks: int = 0
    weights_version: Optional[int] = None

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.blocks.values()))


def pack_kv(kv, slot: int, cached_len: int, tokens=None) -> KVHandoff:
    """Gather ``slot``'s first ``blocks_for(cached_len)`` blocks out of
    every layer pool into one host payload. Block ids never leave the
    owning pool.

    ``tokens``: the cached context's token ids; when given, the payload
    carries their chain hashes so a prefix-caching receiver can
    :func:`trim_kv` the blocks it already holds."""
    n = kv.blocks_for(cached_len)
    ids = list(kv._slot_blocks[slot][:n])
    if len(ids) < n:
        raise ValueError(
            f"slot {slot} owns {len(ids)} blocks but {n} are needed to "
            f"cover {cached_len} cached positions"
        )
    blocks, dtype = _gather(kv, ids)
    hashes = ()
    if tokens is not None:
        hashes = tuple(_chain_hashes(
            [int(t) for t in tokens[:cached_len]], kv.block_size
        ))
    return KVHandoff(blocks=blocks, cached_len=int(cached_len),
                     block_size=int(kv.block_size), dtype=dtype,
                     prefix_hashes=hashes)


def _by_path(kv, payload: KVHandoff, what: str):
    """The pool's (path, leaf) pairs and the payload's runs by path;
    raises :class:`HandoffIncompatible` unless they name the same leaves."""
    leaves = list(iter_leaf_paths(kv.caches))
    by_path: Dict[str, list] = {}
    for key, data in payload.blocks.items():
        path, starts, _shape = _parse_key(key)
        ax = _block_axis(path)
        by_path.setdefault(path, []).append(
            (starts[ax] if len(starts) > ax else 0, data)
        )
    paths = [p for p, _ in leaves]
    if set(by_path) != set(paths):
        raise HandoffIncompatible(
            f"layer structure mismatch between {what} pools "
            f"(payload layers {sorted(by_path)[:3]}... vs pool "
            f"{sorted(paths)[:3]}...)"
        )
    for path, pool in leaves:
        # Per-LEAF dtype gate: an int8 pool's leaves are int8 ``q`` plus
        # float32 ``scale``, each shipped run checked against its own leaf.
        for _, data in by_path[path]:
            if data.dtype != _host_dtype(pool.dtype):
                raise HandoffIncompatible(
                    f"dtype mismatch on {path}: payload {data.dtype} vs "
                    f"pool {_dtype_name(pool.dtype)}"
                )
    return leaves, by_path


def install_kv(kv, slot: int, payload: KVHandoff):
    """Scatter ``payload`` into ``slot``'s already-reserved blocks of this
    pool (reserve first: the engine's admission path grants the blocks).
    Raises :class:`HandoffIncompatible` when the pools disagree — before
    any block is written — and the caller then re-prefills. Returns the
    number of blocks installed (summed over leaves)."""
    if payload.block_size != kv.block_size:
        raise HandoffIncompatible(
            f"block_size mismatch: payload {payload.block_size} vs pool "
            f"{kv.block_size}"
        )
    need = kv.blocks_for(payload.cached_len)
    ids = kv._slot_blocks[slot]
    if len(ids) < need:
        raise ValueError(
            f"slot {slot} has {len(ids)} reserved blocks but the payload "
            f"covers {need} — reserve the sequence's context first"
        )
    if not payload.blocks:
        # Fully trimmed: every cached block was adopted from the
        # receiver's prefix store; nothing travels, nothing to scatter.
        return 0
    leaves, by_path = _by_path(kv, payload, "prefill and decode")
    installed = 0
    for path, pool in leaves:
        ax = _block_axis(path)
        for start, data in sorted(by_path[path], key=lambda r: r[0]):
            _scatter(pool, ax, ids[start:start + data.shape[ax]], data)
            installed += int(data.shape[ax])
    return installed


def pack_prefix(kv, keys, *,
                weights_version: Optional[int] = None) -> Optional[KVHandoff]:
    """Gather the prefix-store blocks for the leading run of chain
    ``keys`` this pool holds into a :class:`KVHandoff` — the gossip export
    side. The blocks belong to the STORE, not a slot. Returns None when
    the store holds none of ``keys``. The probe is
    ``PrefixStore.peek_run``: exporting is not an admission, so hit/miss
    counters and LRU order stay untouched."""
    store = getattr(kv, "prefix", None)
    if store is None or not keys:
        return None
    ids = store.peek_run(list(keys))
    if not ids:
        return None
    blocks, dtype = _gather(kv, ids)
    return KVHandoff(
        blocks=blocks, cached_len=len(ids) * kv.block_size,
        block_size=int(kv.block_size), dtype=dtype,
        prefix_hashes=tuple(keys[:len(ids)]),
        weights_version=weights_version,
    )


def adopt_prefix(kv, payload: KVHandoff, *,
                 weights_version: Optional[int] = None) -> int:
    """Install a gossiped prefix run into THIS pool's prefix store — the
    import side of :func:`pack_prefix`. Fresh blocks are allocated
    (store-owned: one reference each, as a local ``insert_prefix``), the
    payload's rows scattered in, and each chain key registered; later
    admissions adopt them through ``PrefixStore.lookup``.

    Keys already cached are skipped (first writer wins); the walk stops
    at the first allocation failure, leaving a shorter-but-valid leading
    run. Raises :class:`HandoffIncompatible` on pool disagreement or a
    ``weights_version`` stamp mismatch. Returns the number of blocks
    newly adopted."""
    store = getattr(kv, "prefix", None)
    if store is None:
        raise HandoffIncompatible(
            "adopt_prefix on a pool without a prefix store"
        )
    if payload.block_size != kv.block_size:
        raise HandoffIncompatible(
            f"block_size mismatch: payload {payload.block_size} vs pool "
            f"{kv.block_size}"
        )
    # The staleness stamp: a payload computed under different weights
    # must never enter the store.
    if (weights_version is not None
            and payload.weights_version is not None
            and int(payload.weights_version) != int(weights_version)):
        raise HandoffIncompatible(
            f"stale gossip payload: weights_version "
            f"{payload.weights_version} vs current {weights_version}"
        )
    keys = list(payload.prefix_hashes)
    if not keys or not payload.blocks:
        return 0
    leaves, by_path = _by_path(kv, payload, "gossip peer and local")
    # Chain property: only a LEADING run whose predecessors are all
    # cached (locally or by this adoption) is admissible.
    src_index: list = []
    dst_blocks: list = []
    adopt_keys: list = []
    for i, key in enumerate(keys):
        if key in store:
            continue  # first writer wins; the chain stays contiguous
        grant = kv._allocate(1)
        if grant is None:
            break  # pool dry: keep the shorter leading run
        src_index.append(i)
        dst_blocks.append(grant[0])
        adopt_keys.append(key)
    if not adopt_keys:
        return 0
    src = np.asarray(src_index, np.int64)
    for path, pool in leaves:
        ax = _block_axis(path)
        data = by_path[path][0][1]
        _scatter(pool, ax, dst_blocks,
                 np.take(data, src, axis=ax))
    for key, block in zip(adopt_keys, dst_blocks):
        if not store.insert(key, block):
            kv.allocator.decref([block])
    return len(adopt_keys)


def trim_kv(payload: KVHandoff, store) -> Tuple[KVHandoff, int]:
    """Drop the leading blocks the receiving replica's prefix ``store``
    already holds (a contiguous chain-hash hit run), returning
    ``(trimmed payload, blocks dropped)``. The original payload is not
    mutated — a failed placement can be re-offered to another replica.
    The trimmed payload records ``skip_blocks`` so the receiver can check
    at install time that its store STILL covers the gap."""
    if store is None or not payload.prefix_hashes or not payload.blocks:
        return payload, 0
    skip = 0
    for key in payload.prefix_hashes:
        if key in store:
            skip += 1
        else:
            break
    n_blocks = -(-payload.cached_len // payload.block_size)
    skip = min(skip, n_blocks)
    if skip == 0:
        return payload, 0
    blocks: Dict[str, np.ndarray] = {}
    for key, data in payload.blocks.items():
        path, starts, _shape = _parse_key(key)
        ax = _block_axis(path)
        first = starts[ax] if len(starts) > ax else 0
        if data.shape[ax] + first <= skip:
            continue  # this run is entirely inside the cached prefix
        keep = max(skip - first, 0)
        rest = data[keep:] if ax == 0 else data[:, keep:]
        new_starts = tuple(
            s + keep if i == ax else s for i, s in enumerate(starts)
        )
        blocks[_block_key(path, new_starts, rest.shape)] = rest
    trimmed = dataclasses.replace(
        payload, blocks=blocks, skip_blocks=int(skip)
    )
    return trimmed, int(skip)
