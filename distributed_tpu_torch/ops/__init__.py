"""Ops: the CUDA kernels of the port and the plain tensor code around them.

- ``paged_attention``: the serving decode read (kernel K1/K2).
- ``flash_attention``: flash attention forward and backward, and the
  dense path.
- ``pallas_kernels``: fused softmax cross-entropy forward and backward.
- ``fused_update``: the fused Adam/AdamW update (kernel K11).
- ``conv1x1``: the GEMM of a 1x1 convolution and its gradient (K12).
- ``bn_reduce``: BatchNorm's per-channel reductions (K13, K14).
- ``launch_probe``: the launch-cost probe (K15).
- ``losses`` and ``metrics``: what ``Model.compile`` takes by name.
"""

from . import (
    bn_reduce, conv1x1, flash_attention, fused_update, launch_probe, losses,
    metrics, paged_attention, pallas_kernels,
)

__all__ = [
    "bn_reduce", "conv1x1", "flash_attention", "fused_update",
    "launch_probe", "losses", "metrics", "paged_attention", "pallas_kernels",
]
