"""Input pipeline: prefetched shuffle/gather/decode/normalize batches.

The port of the JAX package's ``data/pipeline.py``: the same batch
streams, bit for bit, from the same sources. Two implementations behind
one API:

- **Native (C++)**: ``native/pipeline.cc``, compiled with ``g++`` into the
  git-ignored ``_build/`` at first use (keyed on a hash of the source and
  flags, under a file lock, so ranks sharing a host build it once) and
  driven through ``ctypes``. Worker threads keep a bounded ring of ready
  float32 batches ahead of the consumer.
- **Python**: the same semantics (per-pass reshuffle, steps per pass,
  /255 normalization), and the only path of record sources.

Batch streams are deterministic in (seed, pass, step) ACROSS
implementations: the per-pass permutation is computed once, in numpy
(``np.random.default_rng((seed, pass))``), and handed to the ring as an
index buffer. ``DTPU_NATIVE_LEGACY_SHUFFLE=1`` restores the ring's own
splitmix64 order; ``DTPU_NO_NATIVE=1`` keeps the ring unloaded.

Record sources (``data.RecordSource``) add host-side **decode** of
variable-length encoded records, optionally fanned across a bounded
worker pool (``decode_workers=W``) with work assigned by step index and
reassembled in order: the stream is bit-identical for any ``W``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils import logging as dlog

_PKG = Path(__file__).resolve().parents[1]
NATIVE_SOURCE = Path(__file__).resolve().parent / "native" / "pipeline.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None  # why the last load failed
_lib_tried = False


def _build_native() -> Path:
    """Compile ``native/pipeline.cc`` into ``_build/`` under a name keyed
    on a hash of the source and the flags, unless that library exists. An
    exclusive ``fcntl`` lock orders processes that build at once (the test
    workers, the ranks of a gang on one host): the first builds into a
    temporary file and renames it into place, the others find it."""
    import fcntl

    h = hashlib.sha256(NATIVE_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libdtpu_pipeline-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                cxx = os.environ.get("CXX", "g++")
                run = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
                    capture_output=True, text=True, timeout=300)
                if run.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise OSError(f"{cxx} failed on {NATIVE_SOURCE.name}:\n"
                                  f"{run.stdout}{run.stderr}")
                os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface's argument and result types (the JAX package's
    list)."""
    lib.dtpu_pipeline_create_spans.restype = ctypes.c_void_p
    lib.dtpu_pipeline_create_spans.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # xs (span base pointers)
        ctypes.POINTER(ctypes.c_int64),   # span_rows
        ctypes.c_int64,   # n_spans
        ctypes.c_void_p,  # y
        ctypes.c_int64,   # n
        ctypes.c_int64,   # row_elems
        ctypes.c_int64,   # batch
        ctypes.c_int,     # shuffle
        ctypes.c_uint64,  # seed
        ctypes.c_int,     # depth
        ctypes.c_int,     # threads
        ctypes.c_float,   # scale
        ctypes.c_int64,   # start_step
        ctypes.c_int64,   # shard_index
        ctypes.c_int64,   # shard_count
        ctypes.c_int,     # external_perms
    ]
    lib.dtpu_pipeline_next.restype = ctypes.c_int64
    lib.dtpu_pipeline_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dtpu_pipeline_steps_per_pass.restype = ctypes.c_int64
    lib.dtpu_pipeline_steps_per_pass.argtypes = [ctypes.c_void_p]
    lib.dtpu_pipeline_supply_perm.restype = None
    lib.dtpu_pipeline_supply_perm.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dtpu_pipeline_destroy.restype = None
    lib.dtpu_pipeline_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the ring's library; None if it cannot
    be built or loaded (the reason is kept for ``use_native=True``'s
    error). ``DTPU_NO_NATIVE=1`` keeps it unloaded."""
    global _lib, _lib_error, _lib_tried
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("DTPU_NO_NATIVE") == "1":
            _lib_error = "DTPU_NO_NATIVE=1"
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(_build_native())))
        except (OSError, subprocess.SubprocessError) as e:
            _lib_error = str(e)
            dlog.warning(f"native pipeline unavailable ({e}); using Python")
        return _lib


def native_available() -> bool:
    return _load_native() is not None


_POLL_S = 0.05  # decode worker/consumer wake-up period for stop checks


class _DecodePool:
    """Bounded, order-preserving parallel decode stage.

    Work items are whole batch steps, ``(step, indices)``, decoded by
    ``fn(indices)`` on one of ``workers`` daemon threads and reassembled
    by step key, so the consumed stream is bit-identical for ANY worker
    count (``fn`` must be pure). The Pipeline bounds outstanding work, so
    the results held here are bounded too.
    """

    def __init__(self, fn, workers: int):
        self._fn = fn
        self._tasks: "queue.Queue" = queue.Queue()
        self._results = {}
        self._cv = threading.Condition()
        self._error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(
                target=self._run, name=f"dtpu-decode-{i}", daemon=True
            )
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def _run(self):
        while True:
            task = self._tasks.get()
            if task is None:  # poison pill from close()
                return
            step, idx = task
            try:
                out = self._fn(idx)
            except BaseException as e:  # surfaced to the consumer in get()
                with self._cv:
                    if self._error is None:
                        self._error = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._results[step] = out
                self._cv.notify_all()

    def submit(self, step: int, idx: np.ndarray):
        self._tasks.put((int(step), idx))

    def get(self, step: int):
        """Block until step ``step``'s decode lands; re-raise any worker
        error with its original type."""
        with self._cv:
            while step not in self._results:
                if self._error is not None:
                    raise self._error
                self._cv.wait(timeout=_POLL_S)
            return self._results.pop(step)

    def close(self, join_timeout: float = 10.0):
        """Idempotent shutdown: drop pending tasks, poison every worker,
        join each within ``join_timeout``. Never raises: errors the
        consumer cares about surface in get()."""
        while True:  # unsubmitted work is abandoned, not decoded
            try:
                self._tasks.get_nowait()
            except queue.Empty:
                break
        for _ in self._threads:
            self._tasks.put(None)
        for t in self._threads:
            t.join(timeout=join_timeout)
        with self._cv:
            self._results.clear()


def _auto_shard() -> Tuple[int, int]:
    """``shard="auto"``: ``(row coordinate, row shards)`` of the ambient
    strategy; else ``(rank, world size)`` of the formed process group;
    else ``(0, 1)``. JAX's "auto" is ``(process index, process count)``,
    a TPU host holding whole model lines; the port runs one process a
    card, so the rows come from the strategy's row line."""
    from ..parallel.strategy import current_strategy

    strategy = current_strategy()
    if strategy is not None:
        return strategy.row_shard()
    import torch.distributed as dist

    return ((dist.get_rank(), dist.get_world_size())
            if dist.is_available() and dist.is_initialized() else (0, 1))


class Pipeline:
    """Iterator of ``(x_float32, y_int32)`` batches with background prefetch.

    Args (the JAX ``Pipeline``'s):
      x: uint8 array (N, ...), a file-backed shard set (``FileSource`` or a
        directory path), or an indexed record store (``RecordSource``,
        whose ``decode_fn`` turns encoded records into fixed-shape rows).
      y: int labels (N,) or None.
      batch_size: rows per emitted (global) batch.
      shuffle: reshuffle every pass deterministically from ``seed``.
      scale: multiplier of the ->float32 conversion; default 1/255 for
        uint8 sources, 1.0 for record sources (``decode_fn`` normalizes).
      prefetch: ring depth, how many batches may be ready ahead.
      num_threads: the ring's producer threads (the stream does not
        depend on it).
      use_native: True (the C++ ring; raises when it cannot be built or
        loaded), False (the Python path) or None (the ring when it loads,
        else the Python path with a warning; :attr:`is_native` says which
        was taken). Record sources always run the Python path.
      shard: ``(index, count)``: this pipeline prepares only rows ``[index
        * b/count, (index + 1) * b/count)`` of each global batch; "auto"
        takes this rank's coordinate on the row line of the ambient
        strategy and the number of row shards (``Strategy.row_shard``:
        the ranks of one model, pipe, expert or seq line read the same
        rows), ``(rank, world size)`` of the formed ``torch.distributed``
        group outside a strategy's scope, ``(0, 1)`` without one. A
        source built with "auto" is resolved again under the strategy of
        the ``fit``, ``evaluate`` or ``predict`` it is handed to
        (:attr:`shard_auto`).
      decode_workers: record sources only: decode on this many worker
        threads (0 decodes inline); the stream is the same for any count.
      decode_readahead: batch steps that may be decoding (or decoded,
        unconsumed) ahead of the consumer; default ``2 * decode_workers``.

    The stream is infinite (passes repeat, reshuffled); ``steps_per_pass``
    is one epoch's length. :meth:`state_dict`/:meth:`load_state` capture
    and restore the cursor (``Checkpointer`` records it), :meth:`seek`
    jumps to a global step and :meth:`reshard` adopts another slice of the
    same global stream.
    """

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
        from .filesource import FileSource
        from .records import RecordSource

        # Teardown-critical fields FIRST: __del__ runs on instances whose
        # __init__ raised partway, and close() must find them.
        self._lib = None
        self._handle = None
        self._closed = False
        self._py_step = 0
        self._decode_pool = None
        self.steps_emitted = 0  # lets fit() fast-forward on resume

        self._source: Optional[FileSource] = None
        self._records: Optional[RecordSource] = None
        self._decode_labels = False
        if isinstance(x, (str, os.PathLike)):
            x = FileSource(x)
        if isinstance(x, RecordSource):
            if x.decode_fn is None:
                raise ValueError(
                    "Pipeline needs a RecordSource with a decode_fn: "
                    "records are encoded bytes, and only the decoder "
                    "knows the row shape"
                )
            if use_native is True:
                raise ValueError(
                    "use_native=True is unavailable for record sources: "
                    "decode_fn runs in Python (decode parallelism comes "
                    "from decode_workers instead)"
                )
            self._records = x
            row_shape, self._decode_labels = x.probe()
            if self._decode_labels and y is not None:
                raise ValueError(
                    "labels come from decode_fn (it returns (row, label)); "
                    "do not also pass y"
                )
            n_rows = x.n
            self._x = None
        elif isinstance(x, FileSource):
            # The ring reads the memmaps through their base pointers: the
            # source (and so its maps) lives as long as this pipeline.
            self._source = x
            if y is None:
                y = x.y  # labels from the shard set, if present
            n_rows = x.n
            row_shape = x.row_shape
            self._x = None
        else:
            x = np.ascontiguousarray(x)
            if x.dtype != np.uint8:
                raise TypeError(
                    f"Pipeline feeds raw uint8 data, got {x.dtype}"
                )
            self._x = x
            n_rows = x.shape[0]
            row_shape = x.shape[1:]
        if batch_size <= 0 or batch_size > n_rows:
            raise ValueError(
                f"batch_size {batch_size} invalid for {n_rows} rows"
            )
        self._y = (
            None if y is None else np.ascontiguousarray(y, dtype=np.int32)
        )
        if self._y is not None and len(self._y) != n_rows:
            raise ValueError("x and y lengths differ")
        self.batch_size = int(batch_size)
        self._row_shape = tuple(row_shape)
        self._set_shard(shard)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        if scale is None:
            scale = 1.0 if self._records is not None else 1.0 / 255.0
        self.scale = float(scale)
        self.prefetch = max(1, int(prefetch))
        self.num_threads = max(1, int(num_threads))
        self._n = int(n_rows)
        self.steps_per_pass = self._n // self.batch_size
        self._row = int(np.prod(row_shape, dtype=np.int64))
        self._perm_cache = {}  # pass -> permutation (numpy, both paths)

        self.decode_workers = max(0, int(decode_workers))
        if self.decode_workers and self._records is None:
            raise ValueError(
                "decode_workers requires a RecordSource input (raw uint8 "
                "sources have nothing to decode)"
            )
        self._decode_readahead = (
            2 * self.decode_workers
            if decode_readahead is None
            else max(0, int(decode_readahead))
        )
        self._next_submit = 0  # next step handed to the decode pool

        lib = None
        if self._records is None and use_native in (None, True):
            lib = _load_native()
            if use_native is True and lib is None:
                raise RuntimeError(
                    f"Native pipeline requested but unavailable: "
                    f"{_lib_error}")
        self._lib = lib
        # The ring consumes the numpy per-pass permutations unless the
        # legacy flag pins its own splitmix order.
        self._external_perms = (
            lib is not None
            and self.shuffle
            and os.environ.get("DTPU_NATIVE_LEGACY_SHUFFLE") != "1"
        )
        self._supplied_passes = set()
        if lib is not None:
            self._handle = self._create_handle(0)
        elif self.decode_workers:
            self._decode_pool = _DecodePool(
                self._decode_batch, self.decode_workers
            )

    def _set_shard(self, shard) -> None:
        """Adopt a ``(index, count)`` slice of the global batch (None: the
        whole batch; "auto": ``_auto_shard``). Shared by ``__init__`` and
        :meth:`reshard`."""
        #: True when the shard was given as "auto" (and so follows the
        #: strategy it is trained, evaluated or predicted under).
        self.shard_auto = isinstance(shard, str)
        if isinstance(shard, str):
            if shard != "auto":
                raise ValueError(
                    f"shard must be (index, count), None, or 'auto'; "
                    f"got {shard!r}")
            shard = _auto_shard()
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
        the old sharding would have assembled next. The ring (or the
        decode pool) is recreated at the current step."""
        if self._closed:
            raise ValueError("Pipeline is closed")
        self._set_shard(shard)
        if self._handle is not None:
            # Detach before recreating: a failed recreate must not leave a
            # handle close() would destroy twice.
            handle, self._handle = self._handle, None
            self._lib.dtpu_pipeline_destroy(handle)
            self._supplied_passes = set()
            self._handle = self._create_handle(self.steps_emitted)
        else:
            # Decoded-but-unconsumed results were sliced for the OLD
            # shard; drop and re-stage them for the new one.
            self._reset_decode_pool(self._py_step)
        return self

    def _create_handle(self, start_step: int):
        # One span for an in-memory array; one per memory-mapped shard of
        # a FileSource (a memmap's .ctypes gives the mapping's address).
        arrays = (self._source.x_shards if self._source is not None
                  else [self._x])
        n_spans = len(arrays)
        xs = (ctypes.c_void_p * n_spans)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays]
        )
        rows = (ctypes.c_int64 * n_spans)(*[a.shape[0] for a in arrays])
        handle = self._lib.dtpu_pipeline_create_spans(
            ctypes.cast(xs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(rows, ctypes.POINTER(ctypes.c_int64)),
            n_spans,
            None if self._y is None
            else self._y.ctypes.data_as(ctypes.c_void_p),
            self._n,
            self._row,
            self.batch_size,
            1 if self.shuffle else 0,
            self.seed,
            self.prefetch,
            self.num_threads,
            self.scale,
            start_step,
            0 if self.shard is None else self.shard[0],
            1 if self.shard is None else self.shard[1],
            1 if self._external_perms else 0,
        )
        if not handle:
            raise RuntimeError("dtpu_pipeline_create failed")
        # Producers may fill up to prefetch steps ahead at once; hand them
        # every permutation they can reach first.
        self._supply_native_perms(handle, start_step + self.prefetch)
        return handle

    # ------------------------------------------------------------- shuffle --
    def _pass_perm(self, pass_idx: int) -> np.ndarray:
        """THE per-pass row permutation (identity when shuffle=False),
        shared by every path; cached, and passes behind the cursor are
        dropped."""
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

    def _supply_native_perms(self, handle, max_step: int) -> None:
        """Feed the ring every per-pass permutation its producers can
        reach while filling through ``max_step``."""
        if not self._external_perms or handle is None:
            return
        spp = max(1, self.steps_per_pass)
        for p in range(self.steps_emitted // spp, max_step // spp + 1):
            if p in self._supplied_passes:
                continue
            order = np.ascontiguousarray(self._pass_perm(p))
            self._lib.dtpu_pipeline_supply_perm(
                handle, p,
                order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            self._supplied_passes.add(p)
        cur = self.steps_emitted // spp
        self._supplied_passes = {
            p for p in self._supplied_passes if p >= cur
        }

    # -------------------------------------------------------------- decode --
    def _indices_for_step(self, step: int) -> np.ndarray:
        pass_idx, within = divmod(step, self.steps_per_pass)
        start = within * self.batch_size
        if self.shard is not None:
            start += self.shard[0] * self.shard_rows
        return self._pass_perm(pass_idx)[start:start + self.shard_rows]

    def _decode_batch(self, idx: np.ndarray):
        """Fetch, CRC-check and decode the records of one batch step, and
        scale them. Pure in ``idx`` (decode_fn must be pure), so it runs
        identically inline or on any decode worker."""
        src = self._records
        xb = np.empty((len(idx),) + self._row_shape, np.float32)
        yb = (
            np.empty((len(idx),), np.int32) if self._decode_labels else None
        )
        for i, g in enumerate(idx):
            out = src.decode(int(g))
            if self._decode_labels:
                row, label = out
                yb[i] = label
            else:
                row = out
            row = np.asarray(row)
            if row.shape != self._row_shape:
                raise ValueError(
                    f"decode_fn returned shape {row.shape} for record "
                    f"{int(g)}, but record 0 decoded to "
                    f"{self._row_shape} — rows must share one shape"
                )
            xb[i] = row
        if self.scale != 1.0:
            xb *= np.float32(self.scale)
        return xb, yb

    def _reset_decode_pool(self, step: int) -> None:
        """Recreate the decode pool at ``step``: work of an abandoned
        cursor (seek/reshard) is dropped, never consumed."""
        if self._decode_pool is not None:
            self._decode_pool.close()
            self._decode_pool = _DecodePool(
                self._decode_batch, self.decode_workers
            )
        self._next_submit = step

    def _fill_records(self, xb: np.ndarray, yb: np.ndarray) -> None:
        step = self._py_step
        self._py_step += 1
        if self._decode_pool is None:
            rows, labels = self._decode_batch(self._indices_for_step(step))
        else:
            # Keep the pool primed readahead steps past the consumer.
            if self._next_submit <= step:
                self._next_submit = step
            while self._next_submit <= step + self._decode_readahead:
                self._decode_pool.submit(
                    self._next_submit,
                    self._indices_for_step(self._next_submit),
                )
                self._next_submit += 1
            rows, labels = self._decode_pool.get(step)
        xb[:] = rows
        if labels is not None:
            yb[:] = labels
        elif self._y is not None:
            yb[:] = self._y[self._indices_for_step(step)]
        else:
            yb[:] = 0

    # ------------------------------------------------------------ iteration --
    def seek(self, step: int):
        """Jump to global step ``step`` in O(1): the stream depends only on
        (seed, pass, step within the pass)."""
        if self._closed:
            raise ValueError("Pipeline is closed")
        step = int(step)
        if step < 0:
            raise ValueError(f"seek target must be >= 0, got {step}")
        if self._handle is not None:
            handle, self._handle = self._handle, None
            self._lib.dtpu_pipeline_destroy(handle)
            self._supplied_passes = set()
            self._perm_cache = {}
            self.steps_emitted = step  # perm pruning keys off the cursor
            self._handle = self._create_handle(step)
        else:
            self._py_step = step
            self._perm_cache = {}
            self._reset_decode_pool(step)
        self.steps_emitted = step

    # ------------------------------------------------------ iterator state --
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
        """True when the C++ ring emits the batches."""
        return self._handle is not None

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
        """Write the next batch into contiguous f32/int32 buffers of
        ``batch_shape``/``(shard_rows,)``: the one emit path behind
        ``__next__`` and ``next_k``."""
        if self._records is not None:
            self._fill_records(xb, yb)
        elif self._handle is not None:
            # The call advances the ring's consumer to steps_emitted + 1,
            # after which producers may fill through steps_emitted +
            # prefetch: supply every permutation that window can touch.
            self._supply_native_perms(
                self._handle, self.steps_emitted + self.prefetch)
            step = self._lib.dtpu_pipeline_next(
                self._handle,
                xb.ctypes.data_as(ctypes.c_void_p),
                yb.ctypes.data_as(ctypes.c_void_p),
            )
            if step < 0:
                raise StopIteration
        else:
            idx = self._indices_for_step(self._py_step)
            self._py_step += 1
            rows = (self._source.gather(idx) if self._source is not None
                    else self._x[idx])
            # The JAX path's ``rows.astype(np.float32) * scale`` (an f32
            # product), written straight into the batch.
            np.multiply(rows, np.float32(self.scale), out=xb,
                        dtype=np.float32)
            yb[:] = 0 if self._y is None else self._y[idx]
        self.steps_emitted += 1

    def next_k(self, k: int, out=None) -> Tuple[np.ndarray, np.ndarray]:
        """The next ``k`` batches stacked, ``(k,) + batch_shape`` and
        ``(k, shard_rows)``: the super-batch of ``steps_per_execution``.
        ``out=(xs, ys)``: write them there (contiguous f32 and int32 of
        those shapes; ``fit`` passes its pinned staging buffers). Each
        batch is written straight into its row, by the ring's copy or the
        Python path's gather."""
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
        if not (xs.flags["C_CONTIGUOUS"] and ys.flags["C_CONTIGUOUS"]
                and xs.dtype == np.float32 and ys.dtype == np.int32):
            raise ValueError("next_k(out=) needs contiguous float32 and "
                             "int32 arrays (the ring writes raw rows)")
        for i in range(k):
            self._fill(xs[i], ys[i])
        return xs, ys

    def close(self):
        """Idempotent shutdown, safe on a half-built instance, a repeated
        close and at interpreter exit (where the ctypes library may
        already be torn down): every lookup is defensive and the destroy
        may fail silently."""
        self._closed = True
        pool = getattr(self, "_decode_pool", None)
        self._decode_pool = None
        if pool is not None:
            try:
                pool.close()
            except Exception:
                pass
        handle = getattr(self, "_handle", None)
        self._handle = None
        if handle:
            destroy = getattr(getattr(self, "_lib", None),
                              "dtpu_pipeline_destroy", None)
            if destroy is not None:
                try:
                    destroy(handle)
                except Exception:
                    pass  # shutdown-time ctypes teardown; nothing to save

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
