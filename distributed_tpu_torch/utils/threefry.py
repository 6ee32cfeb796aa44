"""JAX's default random-number generator, Threefry-2x32, bit for bit.

``jax.random`` under jax 0.9.0's defaults (``jax_threefry_partitionable``
on) draws every random array from a key of two uint32 words:

- ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``;
- ``split(key, n)``: row i is the pair of words Threefry gives for the
  counter ``(0, i)``;
- ``bits(key, shape)``: element e of the flattened shape is the xor of the
  two words Threefry gives for the counter ``(e >> 32, e mod 2**32)``;
- ``uniform`` puts a bits' top 23 into a float's mantissa, and ``gumbel``
  is ``-log(-log(u))`` over uniforms in ``[tiny, 1)``;
- ``categorical(key, logits)`` is the argmax of ``logits + gumbel(key,
  logits.shape)``: ONE key for the whole array.

The serving engine draws a row at a time from each token's own key
(``row_bits``); ``Model.generate`` draws a whole ``(B, V)`` array from one
key a step (``categorical``). uint32 arithmetic runs in int64 lanes,
masked, so the same code serves numpy arrays (the host's keys) and torch
tensors (the card's noise).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: the two output words for key words
    ``(k0, k1)`` and counter words ``(x0, x1)``, each an int64 array or
    tensor holding uint32 values (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: uint32 ``[0, seed mod
    2**32]``."""
    return np.array([0, int(seed) & _M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``'s key data, ``(num, 2)`` uint32."""
    k = np.asarray(key, np.uint32).astype(np.int64)
    y0, y1 = threefry2x32(k[0], k[1], np.zeros(num, np.int64),
                          np.arange(num, dtype=np.int64))
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in an int64 tensor
    on ``device``): one key for the whole array."""
    k = np.asarray(key, np.uint32).astype(np.int64)
    n = int(np.prod(shape, dtype=np.int64))
    e = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(int(k[0]), int(k[1]), e >> 32, e & _M32)
    return (y0 ^ y1).reshape(shape)


def row_bits(keys, n: int, device) -> torch.Tensor:
    """``jax.random.bits(keys[r], (n,))`` for each row r of ``keys``
    ((R, 2) uint32 key data): an ``(R, n)`` int64 tensor on ``device``."""
    k = torch.from_numpy(np.asarray(keys).astype(np.int64)).to(device)
    j = torch.arange(n, dtype=torch.int64, device=device)[None]
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(j), j)
    return y0 ^ y1


def gumbel_from_bits(b: torch.Tensor) -> torch.Tensor:
    """JAX's f32 ``gumbel`` ("low" mode) from its bits: uniforms in
    ``[tiny, 1)`` from the top 23 bits as a mantissa, then
    ``-log(-log(u))``."""
    u = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(u + tiny, tiny)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of f32
    ``logits``: the argmax of ``logits + gumbel(key, logits.shape)``."""
    noise = gumbel_from_bits(bits(key, tuple(logits.shape), logits.device))
    return torch.argmax(logits + noise, dim=-1)


__all__ = [
    "PRNGKey", "bits", "categorical", "gumbel_from_bits", "row_bits",
    "split", "threefry2x32",
]
