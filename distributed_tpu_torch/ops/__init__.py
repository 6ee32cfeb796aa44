"""Ops: the CUDA kernels of the port and the plain tensor code around them.

- ``paged_attention``: the serving decode read (kernel K1/K2).
- ``flash_attention``: flash attention forward and backward, and the
  dense path.
- ``pallas_kernels``: fused softmax cross-entropy forward and backward.
- ``fused_update``: the fused Adam/AdamW update (kernel K11).
- ``losses`` and ``metrics``: what ``Model.compile`` takes by name.
"""

from . import (
    flash_attention, fused_update, losses, metrics, paged_attention,
    pallas_kernels,
)

__all__ = [
    "flash_attention", "fused_update", "losses", "metrics",
    "paged_attention", "pallas_kernels",
]
