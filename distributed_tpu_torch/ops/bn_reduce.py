"""BatchNorm's per-channel reductions (kernels K13 and K14).

The JAX package's ``examples/bn_pallas.py`` wrote the two reductions of
``nn.BatchNorm`` as Pallas kernels: ``_stats_kernel`` (K13), the forward's
shifted moments ``(sum(x - shift), sum((x - shift)^2))``, and
``_bwd_kernel`` (K14), the backward's ``(sum(dy), sum(dy * xhat))`` with
``xhat = (x - mean) * inv``. The JAX package never wired them into its
layer; the port's ``nn.BatchNorm`` runs them in every training step, and
``csrc/bn_reduce.cu`` replaces them with one kernel template. Each takes an
(M, C) activation in f32, bf16 or f16 and returns the two sums as one
(2, C) f32 tensor.

A call is one launch (``LAUNCHES_PER_CALL``; ``launches`` counts them).
Its grid is :func:`plan`'s partition of the (M, C) array into channel
tiles and row ranges, one wave of blocks on the card's SMs; each block
writes partial sums, and the last block of a tile to arrive adds them in
partition order, through a per-stream workspace of arrival counters and
partials. No atomics on the sums, so a call gives the same bits on every
run.

Dispatch is by the device of the tensors, with no fallback: CUDA tensors
launch the kernel (a failed build or launch raises), CPU tensors run the
plain versions :func:`bn_stats_ref` and :func:`bn_bwd_reduce_ref`.
"""

from __future__ import annotations

import functools

import torch

from . import _build

#: Launches of each CUDA kernel family; incremented only where launched.
launches = {"bn_stats": 0, "bn_bwd_reduce": 0}

#: Kernel launches per call: partial sums and their merge in one.
LAUNCHES_PER_CALL = 1


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------- plain versions
def bn_stats_ref(x2d, shift):
    """(2, C) f32: ``sum(x - shift)`` and ``sum((x - shift)^2)`` over the
    rows of ``x2d``, with ``x`` converted to f32 first."""
    xc = x2d.float() - shift
    return torch.stack([xc.sum(0), xc.square().sum(0)])


def bn_bwd_reduce_ref(dy2d, x2d, mean, inv):
    """(2, C) f32: ``sum(dy)`` and ``sum(dy * ((x - mean) * inv))`` over the
    rows, with ``dy`` and ``x`` converted to f32 first."""
    dyf = dy2d.float()
    xhat = (x2d.float() - mean) * inv
    return torch.stack([dyf.sum(0), (dyf * xhat).sum(0)])


# ------------------------------------------------------------ CUDA kernels
#: Blocks of the kernel an SM holds (its ``__launch_bounds__``): a wave is
#: ``sms * _BLOCKS_PER_SM`` blocks.
_BLOCKS_PER_SM = 2
#: Rows a thread loads before it adds them in K13 (the kernel's
#: ``kUnrollStats``; K14 loads 2 rows of two inputs): a partition gives each
#: thread at least one such batch.
_UNROLL = 4
#: The fewest channel tiles a 16-byte-vector partition aims at: the last
#: block of a tile merges the tile's partials alone, so narrow rows are cut
#: into several tiles, each read in row segments of 64 bytes or more.
_MIN_TILES = 4


@functools.lru_cache(maxsize=None)
def plan(m, c, elem, vec, sms, threads):
    """The kernel's partition of an (m, c) reduction of ``elem``-byte
    entries on a card of ``sms`` SMs and blocks of ``threads`` threads:
    ``(tw, tiles_c, nparts, rows)``. A block owns ``tw`` vectors of
    channels of one of ``tiles_c`` channel tiles and one of ``nparts``
    ranges of ``rows`` rows. Where ``vec``, a vector is 16 bytes and
    ``tw`` is 8 (128-byte row segments), or 4 where 8 would leave fewer
    than ``_MIN_TILES`` tiles; else a vector is one channel and ``tw``
    makes a 128-byte segment, at most 32. The tiles times the ranges make
    one wave of blocks, unless the rows run out first (every thread gets
    at least ``_UNROLL`` rows) or the tiles alone exceed a wave."""
    per = 16 // elem if vec else 1
    cvecs = -(-c // per)
    if vec:
        tw = 8 if cvecs >= 8 * _MIN_TILES else 4
    else:
        tw = min(128 // elem, 32)
    tw = min(tw, 1 << (cvecs - 1).bit_length())
    tiles_c = -(-cvecs // tw)
    th = threads // tw
    want = max(1, sms * _BLOCKS_PER_SM // tiles_c)
    nparts = min(want, -(-m // (th * _UNROLL)))
    rows = -(-m // nparts)
    rows = -(-rows // th) * th
    return tw, tiles_c, -(-m // rows), rows


#: The launcher's arguments (``BnArgs`` in the source): x, dy, a, b, out,
#: partials, counters, stream, dtype, bwd, vec, M, C, tw, tiles_c,
#: nparts, rows.
_ARGS = _build.packed(17)
_LIB = _build.Library("bn_reduce", {
    "dtt_bn_reduce": _ARGS,
    "dtt_bn_reduce_threads": [],
})
_WORKSPACE = {}  # (device index, stream) -> (counters, partials)
_sm_count = _build.sm_count


def _launch(name, acts, a, b):
    """One launch of K13 (``acts`` = [x], ``b`` None) or K14 (``acts`` =
    [dy, x]): checks, the partition, the packed call."""
    x = acts[-1]
    code = _build.FLOAT_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, "
                         "bfloat16, float16)")
    dev = x.device
    for i, t in enumerate(acts):
        _build.require(t, f"{name} input {i}", dev, x.dtype, 2)
        if t.shape != x.shape:
            raise ValueError(f"{name}: inputs {tuple(t.shape)} and "
                             f"{tuple(x.shape)} differ")
    m, c = x.shape
    vectors = []  # the f32 copies stay referenced until the launch
    for t in (a, b):
        if t is not None:
            if t.dtype != torch.float32 or not t.is_contiguous():
                t = t.to(torch.float32).contiguous()
            _build.require(t, f"{name} channel vector", dev, torch.float32, 1)
            if t.shape[0] != c:
                raise ValueError(f"{name}: channel vector of {t.shape[0]} "
                                 f"for {c} channels")
        vectors.append(t)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    if m == 0:
        return out.zero_()
    elem = x.element_size()
    ptrs = [t.data_ptr() for t in acts]
    vec = int(c % (16 // elem) == 0 and all(p % 16 == 0 for p in ptrs))
    index = x.get_device()
    tw, tiles_c, nparts, rows = plan(m, c, elem, vec, _sm_count(index),
                                     _LIB.constant("dtt_bn_reduce_threads"))
    st = _build.raw_stream(index)
    counters, partials = _build.workspace(
        _WORKSPACE, dev, st, tiles_c, 2 * c * nparts if nparts > 1 else 0)
    bwd = len(acts) == 2
    rc = _LIB.get().dtt_bn_reduce(_ARGS.pack(
        ptrs[-1], ptrs[0] if bwd else 0, vectors[0].data_ptr(),
        vectors[1].data_ptr() if bwd else 0,
        out.data_ptr(), partials.data_ptr(), counters.data_ptr(), st, code,
        bwd, vec, m, c, tw, tiles_c, nparts, rows))
    if rc:
        _build.check_launch(rc, name)
    launches[name] += 1
    return out


def _bn_stats_cuda(x2d, shift):
    return _launch("bn_stats", [x2d], shift, None)


def _bn_bwd_reduce_cuda(dy2d, x2d, mean, inv):
    return _launch("bn_bwd_reduce", [dy2d, x2d], mean, inv)


def bn_stats(x2d, shift):
    """:func:`bn_stats_ref`'s sums: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _build.dispatch(x2d, _bn_stats_cuda, bn_stats_ref,
                           "bn_stats")(x2d, shift)


def bn_bwd_reduce(dy2d, x2d, mean, inv):
    """:func:`bn_bwd_reduce_ref`'s sums: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _build.dispatch(x2d, _bn_bwd_reduce_cuda, bn_bwd_reduce_ref,
                           "bn_bwd_reduce")(dy2d, x2d, mean, inv)


__all__ = [
    "LAUNCHES_PER_CALL", "bn_bwd_reduce", "bn_bwd_reduce_ref", "bn_stats",
    "bn_stats_ref", "launches", "plan", "reset_launch_counts",
]
