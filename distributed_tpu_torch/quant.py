"""int8 ``{"q", "scale"}`` pairs, as the JAX package's ``quant.py`` keeps them.

The int8 KV pools use this plain-dict idiom: an int8 payload and an f32
scale beside it. Weight quantization is not ported yet.
"""

from __future__ import annotations

import torch

QKEY = "q"
SKEY = "scale"
_QMAX = 127.0


def is_quantized_leaf(x) -> bool:
    """True for a ``{"q": int8, "scale": f32}`` dict."""
    return (
        isinstance(x, dict)
        and set(x) == {QKEY, SKEY}
        and x[QKEY].dtype == torch.int8
    )


def dequantize(w, dtype=None):
    """``q * scale`` in f32, cast to ``dtype`` when given. The multiply
    runs in f32 so a bf16 target rounds once, not twice."""
    out = w[QKEY].to(torch.float32) * w[SKEY].to(torch.float32)
    return out if dtype is None else out.to(dtype)


def maybe_dequantize(w, dtype=None):
    """Quantized dicts dequantize; plain tensors pass through untouched."""
    return dequantize(w, dtype) if is_quantized_leaf(w) else w


__all__ = [
    "QKEY", "SKEY", "dequantize", "is_quantized_leaf", "maybe_dequantize",
]
