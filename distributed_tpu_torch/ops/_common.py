"""Constants and helpers shared by the port's kernel modules."""

from __future__ import annotations


def round_up(v: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``v``."""
    return -(-v // m) * m


# Column/score padding value shared by the attention-family kernels:
# exp(NEG - max) == 0, and NEG is large enough to never be the row max.
NEG = -1e30
