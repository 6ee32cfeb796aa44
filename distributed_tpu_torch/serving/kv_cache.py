"""Paged (block) KV cache: one device pool, per-sequence block tables.

The cache is a pool of fixed-size blocks (``block_size`` positions each)
shared by every running sequence: a sequence owns just the blocks covering
the positions it has filled (allocated on demand, freed the moment it
finishes or is preempted), and a per-slot block table maps logical
positions to pool blocks — vLLM's PagedAttention layout. The device-side
read/write path lives in ``nn.MultiHeadAttention.{paged_decode,
paged_prefill}``; this module owns the host-side bookkeeping.

Block 0 is reserved as the TRASH block: every unallocated block-table
entry (and every inactive slot's whole table) points at it, so the
fixed-shape decode step can scatter unconditionally — writes from dead
slots land in block 0 and no live sequence ever reads it.

**Prefix sharing (``prefix_cache=True``).** Blocks are REFCOUNTED: N
sequences whose prompts share a leading span at block granularity map
their tables at the SAME pool blocks. :class:`PrefixStore` is the
content-addressed index, keyed by a token-content hash CHAIN (block i's
key digests block i-1's key plus block i's tokens). Admission adopts every
leading hit and prefill runs only the non-cached suffix; the store holds
one reference per cached block, eviction is refcount-aware LRU, and
divergence inside a shared block is copy-on-write (:meth:`_copy_block`).

The bookkeeping is the JAX package's ``serving/kv_cache.py``; here the
pools are torch tensors on the model's device, and copy-on-write copies
a block in place. Pools below a ``"stacked"`` key (``nn.ScannedBlocks``'
:data:`~distributed_tpu_torch.nn.scan.STACKED_POOL_KEY`) carry a leading
(S, ...) axis, one slice per block, so their pool-block axis is 1:
copy-on-write copies along it and ``bytes_per_block`` skips it and counts
the S slices.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..utils import event_schema as evs
from ..utils import events as events_lib


class BlockAllocator:
    """Refcounted free-list over the pool's allocatable blocks
    (1..num_blocks-1; block 0 is the trash block). Allocation is
    all-or-nothing and LIFO; a fresh allocation has refcount 1, prefix
    sharing grows it (``incref``), and a block returns to the free list
    only when the LAST reference drops (``decref``, which raises on a
    double free)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved as the "
                f"trash block); got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocatable(self) -> int:
        return self.num_blocks - 1

    def allocate(self, n: int) -> Optional[List[int]]:
        """``n`` block ids (each at refcount 1), or None when the pool
        cannot serve all of them."""
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def refcount(self, block: int) -> int:
        """Current reference count (0 for free/never-allocated blocks)."""
        return self._refs.get(int(block), 0)

    def incref(self, blocks) -> None:
        """Add one reference to each allocated block. Raises on free
        blocks — a reference to an unowned block would alias the free
        list."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(
                    f"incref of unallocated block {b} (free blocks cannot "
                    "be shared)"
                )
            self._refs[b] += 1

    def decref(self, blocks) -> int:
        """Drop one reference from each block, returning blocks whose
        count hit zero to the free list. Raises on blocks with no
        outstanding reference. Returns how many blocks were freed."""
        freed = 0
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                freed += 1
        return freed

    def free(self, blocks) -> None:
        """Release EXCLUSIVELY-owned blocks. Raises on a double free and on
        a block with refcount > 1: its storage would go to the next
        allocation while a peer sequence or the prefix store still reads
        it. Shared owners must ``decref``."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"double free of block {b}")
            if self._refs[b] > 1:
                raise ValueError(
                    f"free of shared block {b} (refcount "
                    f"{self._refs[b]}) — holders of possibly-shared "
                    "blocks must decref, not free"
                )
        self.decref(blocks)

    def utilization(self) -> float:
        """Fraction of allocatable pool blocks currently owned."""
        return len(self._refs) / max(self.num_allocatable, 1)


def _chain_hashes(tokens, block_size: int) -> List[str]:
    """Content key per FULL block of ``tokens``: key i digests key i-1
    plus block i's tokens, so a single key names the whole prefix through
    its block. Partial trailing blocks get no key."""
    n = len(tokens) // int(block_size)
    keys: List[str] = []
    prev = b"dtpu-prefix/%d" % int(block_size)
    for i in range(n):
        span = np.asarray(
            tokens[i * block_size:(i + 1) * block_size], np.int32
        )
        h = hashlib.blake2b(prev + span.tobytes(), digest_size=16)
        prev = h.digest()
        keys.append(h.hexdigest())
    return keys


class PrefixStore:
    """Content-addressed index of cached full prompt blocks: chain hash
    -> pool block id, in LRU order. The store holds ONE allocator
    reference per entry; :meth:`evict` reclaims LRU entries whose
    refcount is exactly 1 (store-only) when the allocator runs dry."""

    def __init__(self):
        self._entries: "OrderedDict[str, int]" = OrderedDict()
        self.hits = 0          # blocks adopted by admissions
        self.misses = 0        # blocks admissions had to compute
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def blocks(self) -> List[int]:
        return list(self._entries.values())

    def keys(self) -> List[str]:
        """Every cached chain key, LRU order (oldest first): the fleet's
        gossip advertisement. No counter or LRU effect."""
        return list(self._entries)

    def peek_run(self, keys: List[str]) -> List[int]:
        """Block ids for the leading run of ``keys`` present, WITHOUT
        touching the hit/miss counters or LRU order: the gossip export's
        probe (a peer packing blocks for export is not an admission)."""
        found: List[int] = []
        for k in keys:
            if k not in self._entries:
                break
            found.append(self._entries[k])
        return found

    def lookup(self, keys: List[str]) -> List[int]:
        """Block ids for the LEADING run of ``keys`` present in the store
        (the walk stops at the first miss). Hits refresh LRU order."""
        found: List[int] = []
        for k in keys:
            if k not in self._entries:
                break
            self._entries.move_to_end(k)
            found.append(self._entries[k])
        self.hits += len(found)
        self.misses += len(keys) - len(found)
        return found

    def insert(self, key: str, block: int) -> bool:
        """Register ``block`` under ``key`` (False if the key is already
        cached — the existing entry wins; the caller must then NOT
        transfer a reference)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self._entries[key] = int(block)
        self.insertions += 1
        return True

    def evict(self, allocator: BlockAllocator, need: int) -> int:
        """Drop LRU entries whose block only the store references until
        ``need`` blocks came free or none is evictable. Returns the number
        of blocks freed."""
        freed = 0
        if need <= 0:
            return 0
        for key in list(self._entries):
            block = self._entries[key]
            if allocator.refcount(block) != 1:
                continue  # a live sequence shares it: pinned
            del self._entries[key]
            freed += allocator.decref([block])
            self.evictions += 1
            if freed >= need:
                break
        return freed

    def flush(self, allocator: BlockAllocator) -> int:
        """Drop EVERY entry (weight swaps: cached KV computed under old
        weights must not seed new requests). Blocks shared with live
        sequences lose only the store's reference; the sequences keep
        decoding over their (now private) copies. Returns the entries
        dropped."""
        dropped = len(self._entries)
        for block in self._entries.values():
            allocator.decref([block])
        self._entries.clear()
        self.evictions += dropped
        return dropped

    def __len__(self) -> int:
        return len(self._entries)


# nn.scan.STACKED_POOL_KEY, spelled out so this module's imports stay
# numpy-only: pools below a dict key with this name carry a leading
# (S, ...) block-stack axis, so the pool-block axis is 1, not 0.
_STACKED_POOL_KEY = "stacked"


def _pool_leaves(tree, out=None, stacked=False):
    """``(pool tensor, stacked)`` pairs of a paged-cache tree, in
    sorted-key order (``stacked``: the leaf sits below a
    ``_STACKED_POOL_KEY`` subtree)."""
    if out is None:
        out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            _pool_leaves(tree[k], out, stacked or k == _STACKED_POOL_KEY)
    else:
        out.append((tree, stacked))
    return out


class PagedKVCache:
    """Device block pools + host block tables for ``max_slots`` slots.

    ``caches`` holds the module's per-layer pools
    (``module.init_paged_cache``: K/V of shape ``(num_blocks, block_size,
    H, hd)`` per attention layer on ``device``, or with ``dtype=torch.int8``
    quantized ``{"q","scale"}`` pairs). ``block_tables`` is the host-side
    (max_slots, max_blocks_per_seq) int32 map shipped with every decode
    step; unassigned entries stay 0 (the trash block)."""

    def __init__(self, module, *, max_slots: int, block_size: int,
                 max_blocks_per_seq: int, num_blocks: int, dtype, device,
                 prefix_cache: bool = False):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_slots = int(max_slots)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.caches = module.init_paged_cache(
            self.num_blocks, self.block_size, dtype, device
        )
        self.allocator = BlockAllocator(self.num_blocks)
        self.block_tables = np.zeros(
            (self.max_slots, self.max_blocks_per_seq), np.int32
        )
        self.positions = np.zeros((self.max_slots,), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self.prefix: Optional[PrefixStore] = (
            PrefixStore() if prefix_cache else None
        )
        self.cow_copies = 0

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` positions."""
        return -(-int(tokens) // self.block_size)

    def _allocate(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, reclaiming store-only prefix entries in
        LRU order when the free list alone cannot serve the request."""
        grant = self.allocator.allocate(n)
        if grant is None and self.prefix is not None:
            evicted = self.prefix.evict(
                self.allocator, n - self.allocator.num_free
            )
            if evicted:
                events_lib.emit(evs.PREFIX_EVICT, blocks=evicted)
            grant = self.allocator.allocate(n)
        return grant

    def reserve(self, slot: int, upto_len: int) -> bool:
        """Grow ``slot``'s table so positions < ``upto_len`` are backed by
        real blocks. All-or-nothing; False when the pool is exhausted."""
        need = self.blocks_for(upto_len)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence length {upto_len} needs {need} blocks of "
                f"{self.block_size}, above the per-sequence cap "
                f"{self.max_blocks_per_seq} (engine max_len)"
            )
        have = len(self._slot_blocks[slot])
        if need <= have:
            return True
        grant = self._allocate(need - have)
        if grant is None:
            return False
        for i, b in enumerate(grant):
            self.block_tables[slot, have + i] = b
        self._slot_blocks[slot].extend(grant)
        return True

    def admit(self, slot: int, tokens) -> Optional[int]:
        """Back ``slot`` for the full context ``tokens``, adopting any
        cached prefix. Returns the number of leading positions already
        cached (0 without a prefix store) or None when the pool cannot
        back the context. The cached span is capped at ``len(tokens)-1``:
        the last position is always recomputed (its logits sample the next
        token); when that lands inside an adopted shared block, the block
        is copied-on-write first."""
        n = len(tokens)
        if self.prefix is None:
            return 0 if self.reserve(slot, n) else None
        if self._slot_blocks[slot]:
            raise ValueError(
                f"admit on slot {slot} which already owns "
                f"{len(self._slot_blocks[slot])} blocks — release first"
            )
        shared = self.prefix.lookup(_chain_hashes(tokens, self.block_size))
        cached = min(len(shared) * self.block_size, n - 1)
        self.allocator.incref(shared)
        for i, b in enumerate(shared):
            self.block_tables[slot, i] = b
        self._slot_blocks[slot].extend(shared)
        if not self.reserve(slot, n):
            self.release(slot)  # drop the adoptions: all-or-nothing
            return None
        div = cached // self.block_size
        if div < len(shared) and self.allocator.refcount(
            self._slot_blocks[slot][div]
        ) > 1:
            if not self._copy_block(slot, div):
                self.release(slot)
                return None
        return cached

    def _copy_block(self, slot: int, index: int) -> bool:
        """Copy-on-write: duplicate ``slot``'s table entry ``index`` into
        a fresh private block (an in-place device copy in every layer
        pool) and drop the shared reference. False when no block is
        available."""
        grant = self._allocate(1)
        if grant is None:
            return False
        new = grant[0]
        old = self._slot_blocks[slot][index]
        for pool, stacked in _pool_leaves(self.caches):
            if stacked:
                pool[:, new] = pool[:, old]
            else:
                pool[new] = pool[old]
        self._slot_blocks[slot][index] = new
        self.block_tables[slot, index] = new
        self.allocator.decref([old])
        self.cow_copies += 1
        return True

    def insert_prefix(self, slot: int, tokens) -> int:
        """Register ``slot``'s written full blocks covering ``tokens`` (the
        request's PROMPT) in the prefix store, one store reference each.
        Returns how many blocks were newly cached."""
        if self.prefix is None:
            return 0
        added = 0
        keys = _chain_hashes(tokens, self.block_size)
        blocks = self._slot_blocks[slot]
        for i, key in enumerate(keys[:len(blocks)]):
            if self.prefix.insert(key, blocks[i]):
                self.allocator.incref([blocks[i]])
                added += 1
        return added

    def release(self, slot: int) -> None:
        """Drop ``slot``'s reference on every block it maps and point its
        table back at the trash block."""
        blocks = self._slot_blocks[slot]
        if blocks:
            self.allocator.decref(blocks)
        self._slot_blocks[slot] = []
        self.block_tables[slot, :] = 0
        self.positions[slot] = 0

    def bytes_per_block(self) -> int:
        """Device bytes one pool block occupies across every layer leaf
        (quantized pools count q + scale); a stacked pool's block is its S
        slices' (the block axis 1 skipped, S multiplied back in)."""
        total = 0
        for leaf, stacked in _pool_leaves(self.caches):
            per = leaf[:, 0] if stacked else leaf[0]
            total += leaf.element_size() * per.numel()
        return int(total)

    def utilization(self) -> float:
        return self.allocator.utilization()

    @property
    def live_blocks(self) -> int:
        """Block references the slots hold (0 once every sequence left)."""
        return sum(len(b) for b in self._slot_blocks)


__all__ = [
    "BlockAllocator", "PagedKVCache", "PrefixStore", "_chain_hashes",
]
