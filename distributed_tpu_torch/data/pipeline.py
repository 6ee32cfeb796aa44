"""Input pipeline: shuffled, normalized batches of an in-memory uint8 array.

The port's copy of the JAX package's ``data.Pipeline`` (``data/
pipeline.py``), its Python path: the same batch order, bit for bit. Each
pass's row permutation is ``np.random.default_rng((seed, pass))
.permutation(n)`` (the identity without ``shuffle``), a pass is ``n //
batch_size`` steps, and step s of a pass takes rows ``[s * b, (s + 1) *
b)`` of it; ``shard=(i, P)`` keeps rows ``[i * b/P, (i + 1) * b/P)`` of
each global batch. The reference documents its native C++ ring as
emitting this order bit for bit, so ``use_native=None`` takes this path.
``use_native=True`` (the C++ ring) and file or record sources raise
``NotImplementedError`` naming ROADMAP 1.8; host-side prefetch of the
batches is ``fit``'s ``DevicePrefetcher``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["Pipeline"]


def _unported(what: str):
    raise NotImplementedError(f"Pipeline({what}): not yet ported (ROADMAP "
                              "1.8, the data tiers)")


class Pipeline:
    """Iterator of ``(x_float32, y_int32)`` batches, infinite (passes
    repeat, reshuffled). ``steps_per_pass`` is one epoch's length,
    ``batch_shape`` the emitted x's shape; ``state_dict``/``load_state``
    capture and restore the cursor (``Checkpointer`` records it), ``seek``
    jumps to a global step and ``reshard`` adopts another slice of the
    same global stream. The arguments are the JAX ``Pipeline``'s:
    ``scale`` defaults to 1/255; ``prefetch`` and ``num_threads`` size
    the native ring and are kept only for call parity here."""

    def __init__(
        self,
        x,
        y: Optional[np.ndarray] = None,
        batch_size: int = 32,
        *,
        shuffle: bool = True,
        seed: int = 0,
        scale: Optional[float] = None,
        prefetch: int = 4,
        num_threads: int = 2,
        use_native: Optional[bool] = None,
        shard: Optional[Tuple[int, int]] = None,
        decode_workers: int = 0,
        decode_readahead: Optional[int] = None,
    ):
        self._closed = False
        self.steps_emitted = 0  # lets fit() fast-forward on resume
        if use_native:
            _unported("use_native=True")
        if isinstance(x, (str, os.PathLike)) or not hasattr(x, "dtype"):
            _unported(f"a {type(x).__name__} source; an in-memory uint8 "
                      "array is ported")
        x = np.ascontiguousarray(x)
        if x.dtype != np.uint8:
            raise TypeError(f"Pipeline feeds raw uint8 data, got {x.dtype}")
        n_rows = x.shape[0]
        if batch_size <= 0 or batch_size > n_rows:
            raise ValueError(
                f"batch_size {batch_size} invalid for {n_rows} rows")
        if int(decode_workers):
            raise ValueError(
                "decode_workers requires a RecordSource input (raw uint8 "
                "sources have nothing to decode)")
        self._x = x
        self._y = (None if y is None
                   else np.ascontiguousarray(y, dtype=np.int32))
        if self._y is not None and len(self._y) != n_rows:
            raise ValueError("x and y lengths differ")
        self.batch_size = int(batch_size)
        self._row_shape = tuple(x.shape[1:])
        self._set_shard(shard)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.scale = float(1.0 / 255.0 if scale is None else scale)
        self.prefetch = max(1, int(prefetch))
        self.num_threads = max(1, int(num_threads))
        self._n = int(n_rows)
        self.steps_per_pass = self._n // self.batch_size
        self._perm_cache = {}  # pass -> permutation
        self.decode_workers = 0  # record decode (not ported) runs none

    def _set_shard(self, shard) -> None:
        """Adopt a ``(index, count)`` slice of the global batch (None: the
        whole batch; "auto": this process's rank and world size)."""
        if isinstance(shard, str):
            if shard != "auto":
                raise ValueError(
                    f"shard must be (index, count), None, or 'auto'; "
                    f"got {shard!r}")
            import torch.distributed as dist

            shard = ((dist.get_rank(), dist.get_world_size())
                     if dist.is_available() and dist.is_initialized()
                     else (0, 1))
        if shard is None:
            shard = (0, 1)
        index, count = int(shard[0]), int(shard[1])
        if count < 1 or not 0 <= index < count:
            raise ValueError(f"shard index {index} not in [0, {count})")
        if self.batch_size % count:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by shard "
                f"count {count}")
        self.shard = (index, count) if count > 1 else None
        self.shard_rows = self.batch_size // count
        self.batch_shape = (self.shard_rows,) + self._row_shape

    def reshard(self, shard) -> "Pipeline":
        """Adopt a new slice of the SAME global stream at the current
        position: the next batch is this shard's rows of the global batch
        the old sharding would have assembled next."""
        if self._closed:
            raise ValueError("Pipeline is closed")
        self._set_shard(shard)
        return self

    def _pass_perm(self, pass_idx: int) -> np.ndarray:
        """The pass's row permutation, cached; passes behind the cursor
        are dropped."""
        order = self._perm_cache.get(pass_idx)
        if order is None:
            if self.shuffle:
                rng = np.random.default_rng((self.seed, pass_idx))
                order = rng.permutation(self._n).astype(np.int64)
            else:
                order = np.arange(self._n, dtype=np.int64)
            self._perm_cache[pass_idx] = order
            cur = self.steps_emitted // max(1, self.steps_per_pass)
            for old in [p for p in self._perm_cache if p < cur]:
                del self._perm_cache[old]
        return order

    def _indices_for_step(self, step: int) -> np.ndarray:
        pass_idx, within = divmod(step, self.steps_per_pass)
        start = within * self.batch_size
        if self.shard is not None:
            start += self.shard[0] * self.shard_rows
        return self._pass_perm(pass_idx)[start:start + self.shard_rows]

    def seek(self, step: int):
        """Jump to global step ``step`` in O(1): the stream depends only on
        (seed, pass, step within the pass)."""
        if self._closed:
            raise ValueError("Pipeline is closed")
        step = int(step)
        if step < 0:
            raise ValueError(f"seek target must be >= 0, got {step}")
        self._perm_cache = {}
        self.steps_emitted = step

    def state_dict(self, consumed_steps: Optional[int] = None) -> dict:
        """The cursor as JSON-able meta, with the identity fields
        ``load_state`` checks. ``consumed_steps`` (the step the model
        trained to, which a prefetching fit may trail) overrides the
        cursor. The JAX package's keys."""
        steps = (self.steps_emitted if consumed_steps is None
                 else int(consumed_steps))
        spp = max(1, self.steps_per_pass)
        return {
            "kind": "dtpu.data.Pipeline",
            "steps_emitted": int(steps),
            "pass": int(steps // spp),
            "step_in_pass": int(steps % spp),
            "seed": int(self.seed),
            "batch_size": int(self.batch_size),
            "shuffle": bool(self.shuffle),
            "n_rows": int(self._n),
            "shard_cursor": list(self.shard) if self.shard else [0, 1],
        }

    def load_state(self, state: dict) -> "Pipeline":
        """Restore a ``state_dict`` cursor in O(1). The identity fields
        (seed, batch_size, shuffle, row count) must match this pipeline or
        it raises; the saved shard is ignored (a resize changes it)."""
        for key, mine in (("seed", self.seed),
                          ("batch_size", self.batch_size),
                          ("shuffle", self.shuffle), ("n_rows", self._n)):
            if key in state and state[key] != mine:
                raise ValueError(
                    f"iterator state mismatch: checkpoint has {key}="
                    f"{state[key]!r} but this pipeline has {mine!r} — "
                    "resuming would replay a different stream")
        self.seek(int(state["steps_emitted"]))
        return self

    @property
    def is_native(self) -> bool:
        return False

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._closed:
            raise ValueError("Pipeline is closed")
        xb = np.empty(self.batch_shape, np.float32)
        yb = np.empty((self.shard_rows,), np.int32)
        self._fill(xb, yb)
        return xb, yb

    def _fill(self, xb: np.ndarray, yb: np.ndarray) -> None:
        idx = self._indices_for_step(self.steps_emitted)
        # The JAX path's ``rows.astype(np.float32) * scale`` (an f32
        # product), written straight into the batch.
        np.multiply(self._x[idx], np.float32(self.scale), out=xb,
                    dtype=np.float32)
        yb[:] = 0 if self._y is None else self._y[idx]
        self.steps_emitted += 1

    def next_k(self, k: int, out=None) -> Tuple[np.ndarray, np.ndarray]:
        """The next ``k`` batches stacked, ``(k,) + batch_shape`` and
        ``(k, shard_rows)``: the super-batch of ``steps_per_execution``.
        ``out=(xs, ys)``: write them there (contiguous f32 and int32 of
        those shapes; ``fit`` passes its pinned staging buffers)."""
        k = int(k)
        if k < 1:
            raise ValueError(f"next_k needs k >= 1, got {k}")
        if self._closed:
            raise ValueError("Pipeline is closed")
        if out is None:
            out = (np.empty((k,) + self.batch_shape, np.float32),
                   np.empty((k, self.shard_rows), np.int32))
        xs, ys = out
        if xs.shape != (k,) + self.batch_shape or ys.shape != (
                k, self.shard_rows):
            raise ValueError(f"next_k(out=) shapes {xs.shape}, {ys.shape}")
        for i in range(k):
            self._fill(xs[i], ys[i])
        return xs, ys

    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
