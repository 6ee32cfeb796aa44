"""Indexed record shards: variable-length encoded records.

The port's copy of the JAX package's ``data/records.py`` (which imports no
JAX): the same file layout, so shards written by either package read in
the other. ``FileSource`` (filesource.py) serves fixed-shape uint8 npy
shards, the right format when rows are raw tensors; production stores
ship *encoded*, variable-length records (JPEG bytes, tokenized documents,
protos), and what starves the accelerator is host-side **decode**, not
fetch latency. This module is the storage half; ``Pipeline(RecordSource(
...), decode_workers=W)`` (pipeline.py) is the compute half.

Layout written by :func:`write_records`::

    dir/records-00000.drs       # "DRS1" magic, then per record:
                                #   [u32 LE payload length][u32 LE crc32][payload]
    dir/records-00000-idx.npy   # int64 (n_i,) byte offset of each record header
    dir/records-00001.drs
    ...

The sidecar index is what makes the format *seekable*: record ``i`` of a
shard is one ``pread`` at ``offsets[i]`` — no scan, so a shuffled Pipeline
reads exactly the records each batch needs, and mid-epoch resume is O(1).
Reads go through ``os.pread`` (stateless, no shared file cursor), so any
number of decode workers can read one shard concurrently.

Corruption is LOUD: a truncated shard or a CRC mismatch raises
:class:`RecordCorruptionError` naming the shard file and record index —
a flipped bit in a petabyte store must fail the step that touched it, not
silently train on garbage.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["RecordSource", "RecordCorruptionError", "write_records"]

_SHARD_RE = re.compile(r"^records-(\d+)\.drs$")
_MAGIC = b"DRS1"
_HEADER = struct.Struct("<II")  # payload length, crc32(payload)


class RecordCorruptionError(ValueError):
    """A record shard failed validation (truncation or CRC mismatch). The
    message names the shard file and the record index within it."""


def write_records(
    directory,
    records: Iterable[bytes],
    *,
    records_per_shard: int = 4096,
) -> Path:
    """Write an iterable of bytes-like records into the indexed shard
    layout above. Empty records are rejected (a zero-length record is
    indistinguishable from a torn write at read time); existing record
    shards in the directory are an error (no silent mixing)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if any(_SHARD_RE.match(p.name) for p in directory.iterdir()):
        raise FileExistsError(f"{directory} already contains record shards")
    if records_per_shard < 1:
        raise ValueError("records_per_shard must be >= 1")

    shard_idx = 0
    fh = None
    offsets: List[int] = []
    pos = 0
    total = 0

    def _close_shard():
        nonlocal fh
        if fh is None:
            return
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        fh = None
        np.save(
            directory / f"records-{shard_idx:05d}-idx.npy",
            np.asarray(offsets, np.int64),
        )

    try:
        for rec in records:
            rec = bytes(rec)
            if not rec:
                raise ValueError(
                    f"record {total} is empty; zero-length records are not "
                    "representable (indistinguishable from truncation)"
                )
            if fh is None:
                fh = open(directory / f"records-{shard_idx:05d}.drs", "wb")
                fh.write(_MAGIC)
                pos = len(_MAGIC)
                offsets = []
            offsets.append(pos)
            fh.write(_HEADER.pack(len(rec), zlib.crc32(rec)))
            fh.write(rec)
            pos += _HEADER.size + len(rec)
            total += 1
            if len(offsets) >= records_per_shard:
                _close_shard()
                shard_idx += 1
        _close_shard()
    except BaseException:
        if fh is not None:
            fh.close()
        raise
    if total == 0:
        raise ValueError("no records to write")
    return directory


class _Shard:
    """One open record shard: fd for stateless pread + its offset index."""

    def __init__(self, path: Path):
        self.path = path
        idx_path = path.with_name(path.name[: -len(".drs")] + "-idx.npy")
        if not idx_path.exists():
            raise FileNotFoundError(
                f"{path.name}: sidecar index {idx_path.name} is missing — "
                "record shards are unreadable without their offset index "
                "(rewrite the shard set with write_records)"
            )
        self.offsets = np.load(idx_path)
        if self.offsets.ndim != 1 or not np.issubdtype(
            self.offsets.dtype, np.integer
        ):
            raise ValueError(
                f"{idx_path.name}: index must be a 1-D integer array, got "
                f"{self.offsets.dtype} with shape {self.offsets.shape}"
            )
        if len(self.offsets) == 0:
            raise ValueError(f"{path.name}: empty shard (index has 0 records)")
        self.size = path.stat().st_size
        self.fd = os.open(str(path), os.O_RDONLY)
        magic = os.pread(self.fd, len(_MAGIC), 0)
        if magic != _MAGIC:
            os.close(self.fd)
            raise RecordCorruptionError(
                f"{path.name}: bad magic {magic!r} (expected {_MAGIC!r}) — "
                "not a record shard, or its header is torn"
            )

    def read(self, rec: int) -> bytes:
        """Record ``rec`` of this shard, CRC-validated. Raises
        :class:`RecordCorruptionError` naming shard + record on any
        truncation or checksum mismatch."""
        off = int(self.offsets[rec])
        header = os.pread(self.fd, _HEADER.size, off)
        if len(header) < _HEADER.size:
            raise RecordCorruptionError(
                f"shard {self.path.name} is truncated at record {rec}: "
                f"header at offset {off} runs past the file end "
                f"({self.size} bytes)"
            )
        length, crc = _HEADER.unpack(header)
        if length == 0 or off + _HEADER.size + length > self.size:
            raise RecordCorruptionError(
                f"shard {self.path.name} is truncated at record {rec}: "
                f"payload of {length} bytes at offset {off} runs past the "
                f"file end ({self.size} bytes)"
            )
        payload = os.pread(self.fd, length, off + _HEADER.size)
        if len(payload) < length:
            raise RecordCorruptionError(
                f"shard {self.path.name} is truncated at record {rec}: "
                f"read {len(payload)} of {length} payload bytes"
            )
        if zlib.crc32(payload) != crc:
            raise RecordCorruptionError(
                f"CRC mismatch in shard {self.path.name}, record {rec}: "
                f"stored {crc:#010x}, computed {zlib.crc32(payload):#010x} "
                "— the record is corrupt on disk"
            )
        return payload

    def close(self):
        fd, self.fd = self.fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass


class RecordSource:
    """Read-side view over a directory of indexed record shards.

    Args:
      directory: shard directory written by :func:`write_records`.
      decode_fn: pluggable ``bytes -> row`` (or ``bytes -> (row, label)``)
        decoder. ``row`` is any array-like of one fixed shape (every
        record must decode to the same row shape — the Pipeline's batch
        shape is probed from record 0). Required for use as a
        ``Pipeline`` input; optional for raw ``read()`` access. Must be
        PURE (same bytes -> same row): the parallel decode stage calls it
        from worker threads, and stream determinism across worker counts
        relies on it.

    The global record order is shard-major (all of shard 0, then shard 1,
    ...), matching ``FileSource``'s row order, so the same seeded
    permutation addresses both formats identically.
    """

    def __init__(self, directory, decode_fn: Optional[Callable] = None):
        self.directory = Path(directory)
        if not self.directory.is_dir():
            raise FileNotFoundError(
                f"record directory not found: {directory}"
            )
        paths = sorted(
            (p for p in self.directory.iterdir() if _SHARD_RE.match(p.name)),
            key=lambda p: int(_SHARD_RE.match(p.name).group(1)),
        )
        if not paths:
            raise FileNotFoundError(
                f"no records-*.drs shards in {self.directory}"
            )
        self.shards = [_Shard(p) for p in paths]
        self._counts = [len(s.offsets) for s in self.shards]
        self.n = int(sum(self._counts))
        self._starts = np.cumsum([0] + self._counts)
        self.decode_fn = decode_fn
        self._probe_cache: Optional[Tuple[Tuple[int, ...], bool]] = None

    def __len__(self) -> int:
        return self.n

    def _locate(self, i: int) -> Tuple[_Shard, int]:
        if not 0 <= i < self.n:
            raise IndexError(f"record index {i} not in [0, {self.n})")
        s = int(np.searchsorted(self._starts, i, side="right") - 1)
        return self.shards[s], i - int(self._starts[s])

    def read(self, i: int) -> bytes:
        """Raw bytes of global record ``i``, CRC-validated."""
        shard, rec = self._locate(int(i))
        return shard.read(rec)

    def decode(self, i: int):
        """``decode_fn(read(i))`` — one decoded record."""
        if self.decode_fn is None:
            raise ValueError(
                "RecordSource has no decode_fn; pass one at construction "
                "to decode records"
            )
        return self.decode_fn(self.read(int(i)))

    def probe(self) -> Tuple[Tuple[int, ...], bool]:
        """(row_shape, has_labels) discovered by decoding record 0 once —
        how the Pipeline learns its batch shape without a schema file."""
        if self._probe_cache is None:
            out = self.decode(0)
            has_labels = isinstance(out, tuple)
            row = np.asarray(out[0] if has_labels else out)
            if row.ndim < 1:
                raise ValueError(
                    "decode_fn must return an array row (got a scalar); "
                    "wrap scalars as shape-(1,) arrays"
                )
            self._probe_cache = (tuple(row.shape), has_labels)
        return self._probe_cache

    def close(self):
        for s in getattr(self, "shards", []):
            s.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
