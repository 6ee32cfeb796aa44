"""Ops: the paged-attention decode kernel and the dense attention path."""

from . import flash_attention, paged_attention

__all__ = ["flash_attention", "paged_attention"]
