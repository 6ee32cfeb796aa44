"""JAX's default random-number generator, Threefry-2x32, bit for bit.

``jax.random`` under jax 0.9.0's defaults (``jax_threefry_partitionable``
on) draws every random array from a key of two uint32 words:

- ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``;
- ``split(key, n)``: row i is the pair of words Threefry gives for the
  counter ``(0, i)``, and ``fold_in(key, d)`` the pair for ``(0, d)``
  (so ``split(key, n)[i]`` is ``fold_in(key, i)``);
- ``bits(key, shape)``: element e of the flattened shape is the xor of the
  two words Threefry gives for the counter ``(e >> 32, e mod 2**32)``;
- ``uniform`` puts a bits' top 23 into a float's mantissa (``[1, 2)``)
  and subtracts 1, ``bernoulli(key, p, shape)`` is ``uniform < p``, and
  ``gumbel`` is ``-log(-log(u))`` over uniforms in ``[tiny, 1)``;
- ``categorical(key, logits)`` is the argmax of ``logits + gumbel(key,
  logits.shape)``: ONE key for the whole array;
- ``randint(key, shape, lo, hi)`` (int32) splits the key in two, draws 32
  bits from each and folds the pair into ``[lo, hi)`` by uint32
  remainders (:func:`randint`).

The serving engine draws a row at a time from each token's own key
(``row_bits``); ``Model.generate`` draws a whole ``(B, V)`` array from one
key a step (``categorical``). uint32 arithmetic runs in int64 lanes,
masked, so the same code serves numpy arrays (the host's keys) and torch
tensors (the card's noise).

A key may also be a device tensor (``(2,)`` int64 holding the two words,
:func:`device_key`): ``fold_in``, ``split``, ``bits``, ``uniform`` and
``bernoulli`` (each a call of its block form, ``bits_block`` and
``bernoulli_block``, which draw only the counters of a block of the
whole array; the whole array is the block of all indices) then compute on that device from the tensor, with no host
read, so a CUDA graph that captured them reads whatever key was copied
into the tensor before its replay (the train step's key, which
``Model.fit`` refreshes every step).
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


def split(key, num: int = 2):
    """``jax.random.split(key, num)``'s key data, ``(num, 2)``: uint32
    numpy for host key data, an int64 tensor on a device key's device."""
    if isinstance(key, torch.Tensor):
        j = torch.arange(num, dtype=torch.int64, device=key.device)
        y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(j), j)
        return torch.stack([y0, y1], dim=1)
    k = np.asarray(key, np.uint32).astype(np.int64)
    y0, y1 = threefry2x32(k[0], k[1], np.zeros(num, np.int64),
                          np.arange(num, dtype=np.int64))
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def device_key(key, device) -> torch.Tensor:
    """Key data (numpy, or a tensor) as a ``(2,)`` int64 tensor on
    ``device``."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    return torch.from_numpy(
        np.asarray(key, np.uint32).astype(np.int64)).to(device)


def _words(key):
    """The two key words: Python ints for host key data, 0-d int64
    tensors for a device key."""
    if isinstance(key, torch.Tensor):
        return key[0], key[1]
    k = np.asarray(key, np.uint32).astype(np.int64)
    return int(k[0]), int(k[1])


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``'s key data: the Threefry words of
    the counter ``(0, data mod 2**32)``. Host key data gives uint32 numpy,
    a device key an int64 tensor on its device."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, 0, int(data) & _M32)
    if isinstance(key, torch.Tensor):
        return torch.stack([y0, y1])
    return np.array([y0, y1], np.uint32)


def bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in an int64 tensor
    on ``device``): one key for the whole array."""
    return bits_block(key, shape, (None,) * len(shape), device)


def bits_block(key, shape, index, device) -> torch.Tensor:
    """``bits(key, shape)[np.ix_(*index)]`` without the whole array: the
    counters of the block's own elements only. ``index`` holds, for each
    dimension of ``shape``, a 1-D int64 tensor of the global indices this
    block takes (None: all of them); element e of the flattened shape
    has the counter ``(e >> 32, e mod 2**32)``."""
    k0, k1 = _words(key)
    if all(idx is None for idx in index):  # the whole array: one arange
        n = int(np.prod(shape, dtype=np.int64))
        e = torch.arange(n, dtype=torch.int64, device=device).reshape(
            tuple(shape))
    else:
        e, stride = None, 1
        for d in reversed(range(len(shape))):
            n, idx = int(shape[d]), index[d]
            v = (torch.arange(n, dtype=torch.int64, device=device)
                 if idx is None
                 else idx.to(device=device, dtype=torch.int64)) * stride
            v = v.reshape((-1,) + (1,) * (len(shape) - 1 - d))
            e = v if e is None else v + e
            stride *= n
    y0, y1 = threefry2x32(k0, k1, e >> 32, e & _M32)
    return y0 ^ y1


def uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """JAX's f32 ``uniform`` in ``[0, 1)`` from its bits: the top 23 as
    the mantissa of a float in ``[1, 2)``, minus 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32, ``[0, 1)``)."""
    return uniform_from_bits(bits(key, shape, device))


def bernoulli(key, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p``, with
    ``p`` an f32 as JAX holds it (a bool tensor)."""
    return bernoulli_block(key, p, shape, (None,) * len(shape), device)


def bernoulli_block(key, p: float, shape, index, device) -> torch.Tensor:
    """The block ``index`` (:func:`bits_block`) of ``bernoulli(key, p,
    shape)``, drawn from its own counters: a rank's slice of a mask whose
    whole ``shape`` no rank holds."""
    # A fill on the device, no host copy: safe inside a graph capture.
    pf = torch.full((), float(p), dtype=torch.float32, device=device)
    return uniform_from_bits(bits_block(key, shape, index, device)) < pf


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in its default
    int32 (the int32 values in an int64 tensor on ``device``): the key
    split in two, one draw of 32 bits from each (``higher``, ``lower``),
    and ``minval + ((higher % span) * m + lower % span) % span`` in uint32
    arithmetic, where ``span = maxval - minval`` (1 when ``maxval <=
    minval``) and ``m = (2**16 % span)**2 % span`` (which wraps to 0 for
    spans above 2**16). Bounds outside int32 raise ``OverflowError``, as
    JAX's do."""
    return randint_block(key, shape, (None,) * len(shape), minval, maxval,
                         device)


def randint_block(key, shape, index, minval: int, maxval: int,
                  device) -> torch.Tensor:
    """The block ``index`` (:func:`bits_block`) of ``randint(key, shape,
    minval, maxval)``, drawn from its own counters."""
    minval, maxval = int(minval), int(maxval)
    if not all(-(1 << 31) <= v < (1 << 31) for v in (minval, maxval)):
        raise OverflowError(
            f"randint bounds ({minval}, {maxval}) exceed int32's range")
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    k1, k2 = split(key)
    higher = bits_block(k1, shape, index, device)
    lower = bits_block(k2, shape, index, device)
    offset = (((higher % span) * mult + lower % span) & _M32) % span
    # uint32 -> int32 and the add wrap modulo 2**32, as XLA's do.
    return ((minval + offset + (1 << 31)) & _M32) - (1 << 31)


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
    u = uniform_from_bits(b)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(u + tiny, tiny)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of f32
    ``logits``: the argmax of ``logits + gumbel(key, logits.shape)``."""
    noise = gumbel_from_bits(bits(key, tuple(logits.shape), logits.device))
    return torch.argmax(logits + noise, dim=-1)


__all__ = [
    "PRNGKey", "bernoulli", "bernoulli_block", "bits", "bits_block",
    "categorical", "device_key", "fold_in", "gumbel_from_bits", "randint",
    "randint_block", "row_bits", "split", "threefry2x32", "uniform",
    "uniform_from_bits",
]
