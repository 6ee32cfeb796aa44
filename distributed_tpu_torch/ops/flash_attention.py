"""Dense attention: the short-sequence path of ``MultiHeadAttention.apply``.

Only ``dense_attention`` is ported. It is plain tensor code, not a kernel;
the flash-attention kernels wait for the training slice.
"""

from __future__ import annotations

import math

import torch

from ._common import NEG


def dense_attention(q, k, v, causal: bool):
    """Attention over (B, T, H, D) tensors: scores in f32 divided by
    ``sqrt(D)``, masked with ``NEG``, softmax in f32, probabilities cast to
    ``q.dtype`` before the product with ``v``."""
    hd = q.shape[-1]
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


__all__ = ["dense_attention"]
