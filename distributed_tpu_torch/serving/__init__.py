"""Serving: continuous batching over a paged KV cache."""

from .engine import Engine
from .kv_cache import BlockAllocator, PagedKVCache, PrefixStore
from .scheduler import Request, Scheduler, Sequence

__all__ = [
    "BlockAllocator", "Engine", "PagedKVCache", "PrefixStore", "Request",
    "Scheduler", "Sequence",
]
