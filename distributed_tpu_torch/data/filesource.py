"""File-backed dataset source: a directory of npy shards, memory-mapped.

The port's copy of the JAX package's ``data/filesource.py`` (which imports
no JAX). A ``FileSource`` presents a directory of ``shard-NNNNN-x.npy``
files as one logical (N, ...) uint8 array without loading it: each shard
is an ``np.memmap``, and both the C++ ring (span pointers, see
native/pipeline.cc) and the Python path gather rows straight from the
mapped pages, so the OS pages the working set in and out on demand (raw
224^2 ImageNet is ~190 GB). Labels (``shard-NNNNN-y.npy``) are tiny (4
bytes/row) and load fully into RAM as one int32 array.

Layout written by :func:`write_shards`::

    dir/shard-00000-x.npy   # uint8 (rows_i, ...row_shape)
    dir/shard-00000-y.npy   # int   (rows_i,)          [optional]
    dir/shard-00001-x.npy
    ...

Determinism: a ``Pipeline`` over a FileSource emits the exact stream the
in-memory pipeline would for the concatenated array (same seed/pass/step
permutations — the tests assert bit-equality), so switching a recipe to
sharded files changes nothing about training order.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["FileSource", "write_shards"]

_X_RE = re.compile(r"^shard-(\d+)-x\.npy$")


class FileSource:
    """Memory-mapped view over a shard directory (see module docstring)."""

    def __init__(self, directory):
        self.directory = Path(directory)
        if not self.directory.is_dir():
            raise FileNotFoundError(f"shard directory not found: {directory}")
        # Numeric order, not lexicographic: 'shard-10' must follow
        # 'shard-2', and unpadded/overflowing indices must not reorder rows.
        xs = sorted(
            (p for p in self.directory.iterdir() if _X_RE.match(p.name)),
            key=lambda p: int(_X_RE.match(p.name).group(1)),
        )
        if not xs:
            raise FileNotFoundError(
                f"no shard-*-x.npy files in {self.directory}"
            )
        self.x_shards = [np.load(p, mmap_mode="r") for p in xs]
        shape0 = self.x_shards[0].shape[1:]
        for p, m in zip(xs, self.x_shards):
            if m.dtype != np.uint8:
                raise TypeError(f"{p.name}: shards must be uint8, got {m.dtype}")
            if m.shape[1:] != shape0:
                raise ValueError(
                    f"{p.name}: row shape {m.shape[1:]} != {shape0}"
                )
            if m.ndim < 1 or m.shape[0] < 1:
                raise ValueError(f"{p.name}: empty shard")
            if not m.flags["C_CONTIGUOUS"]:
                # The native gather reads raw row-major bytes from the
                # mapped base pointer; an F-order shard would silently feed
                # scrambled rows there while the Python path read it fine.
                raise ValueError(
                    f"{p.name}: shard must be C-contiguous (saved from a "
                    "row-major array)"
                )
        self.row_shape: Tuple[int, ...] = tuple(shape0)
        self.span_rows = [int(m.shape[0]) for m in self.x_shards]
        self.n = int(sum(self.span_rows))
        # Cumulative starts for row -> (shard, offset) resolution.
        self._starts = np.cumsum([0] + self.span_rows)

        ys = [p.with_name(p.name.replace("-x.npy", "-y.npy")) for p in xs]
        have = [p.exists() for p in ys]
        if any(have) and not all(have):
            missing = [p.name for p, h in zip(ys, have) if not h]
            raise FileNotFoundError(
                f"label shards are partial; missing {missing}"
            )
        if all(have):
            parts = [np.load(p) for p in ys]
            for p, arr, rows in zip(ys, parts, self.span_rows):
                if arr.shape != (rows,):
                    raise ValueError(
                        f"{p.name}: labels shape {arr.shape} != ({rows},)"
                    )
                if not np.issubdtype(arr.dtype, np.integer):
                    # Same strictness as the x-shard checks: a float label
                    # file would otherwise be silently truncated to int32.
                    raise TypeError(
                        f"{p.name}: labels must be integer, got {arr.dtype}"
                    )
            self.y: Optional[np.ndarray] = np.concatenate(parts).astype(
                np.int32
            )
        else:
            self.y = None

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Rows ``idx`` (global indices) as one uint8 array — reads only the
        touched pages of the mapped shards. Vectorized: indices are grouped
        by shard and each group is one fancy-index read (a per-row Python
        loop dominated many-shard reads), emitting rows at their original
        positions — bit-identical to a row-at-a-time gather."""
        idx = np.asarray(idx, np.int64)
        out = np.empty((len(idx),) + self.row_shape, np.uint8)
        span = np.searchsorted(self._starts, idx, side="right") - 1
        for s in np.unique(span):
            sel = span == s
            out[sel] = self.x_shards[s][idx[sel] - self._starts[s]]
        return out

    def __len__(self) -> int:
        return self.n


def write_shards(
    directory,
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    *,
    rows_per_shard: int = 4096,
) -> Path:
    """Write (x, y) into the FileSource shard layout. ``x`` must be uint8;
    existing shards in the directory are an error (no silent mixing)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if any(_X_RE.match(p.name) for p in directory.iterdir()):
        raise FileExistsError(f"{directory} already contains shards")
    x = np.ascontiguousarray(x)
    if x.dtype != np.uint8:
        raise TypeError(f"x must be uint8, got {x.dtype}")
    if y is not None and len(y) != len(x):
        raise ValueError("x and y lengths differ")
    if rows_per_shard < 1:
        raise ValueError("rows_per_shard must be >= 1")
    for si, start in enumerate(range(0, len(x), rows_per_shard)):
        stop = min(start + rows_per_shard, len(x))
        np.save(directory / f"shard-{si:05d}-x.npy", x[start:stop])
        if y is not None:
            np.save(
                directory / f"shard-{si:05d}-y.npy",
                np.asarray(y[start:stop], np.int32),
            )
    return directory
