"""Sharded checkpoints: each rank writes only the blocks it holds.

The port of the JAX package's ``checkpoint/sharded.py``, with its
directory format, so the two packages read each other's checkpoints:

    dir/ckpt-<step>/
        manifest.json   # step, seed, input_shape, every leaf's full shape
                        # and dtype, nprocs (the commit marker)
        proc-<i>.npz    # rank i's blocks: "<path>@<starts>@<shape>" ->
                        # data, and "__crc__": JSON {block key: crc32}

- **Save.** Every rank writes the blocks it owns into its own
  ``proc-<rank>.npz``: its block of each sharded leaf (parameters under
  FSDP, optimizer statistics under ZeRO-1 and FSDP, Megatron blocks
  under ``DataTensorParallel`` by the first rank of each data line) and,
  on rank 0, each replicated leaf whole, so each unique block is written
  once. No rank gathers a full leaf. Each block carries a CRC32. The
  optimizer state is written under optax's paths
  (``interop.opt_state_to_tree``), as the npz ``Checkpointer`` writes it.
- **Commit.** ``manifest.json`` is written by rank 0 after every rank's
  write has landed (one all-reduce of the writers' outcomes doubles as
  the barrier); a directory without one is an aborted save and
  ``all_steps`` ignores it. ``async_save=True`` snapshots the blocks on
  the card and writes them on a background thread; the commit waits for
  the next ``save``, ``wait`` or ``restore_into`` on the calling thread,
  so no collective runs beside the training's.
- **Restore.** Each rank reads only the saved blocks that overlap its own
  block of each leaf under the live strategy (decided from the keys),
  so the world size and the strategy may differ from the saving run's:
  ZeRO-1 -> FSDP -> ``DataParallel``, 2 ranks -> 1 and 1 -> 2. A JAX
  save of 2 devices in one process holds both blocks in ``proc-0.npz``;
  the port reads it by key and overlap all the same. A block whose CRC
  does not match raises :class:`ShardCorruptionError` naming it; an
  auto-restore (``step=None``) skips that step and falls back to the
  previous one, agreed by every rank, and a named step raises.

The block machinery is shared with the buddy-redundancy tier
(``resilience/redundancy.py``): its in-memory mirrors hold exactly the
blocks :func:`extract_blocks` gives a save, and :func:`restore_from_index`
reassembles them through the same overlap reader a disk restore uses.
``read_stats`` counts every block read from DISK (the ``proc-*.npz``
reader only), which is how a buddy restore shows zero disk reads.

The directory must be visible to every rank (a shared file system).
"""

from __future__ import annotations

import json
import re
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import interop
from ..interop import iter_leaf_paths
from ..parallel.collectives import layout_of
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import logging as dlog
from .core import (_ASYNC_CHECKPOINTERS, _atomic_write, _comm_device,
                   _data_state_of, _device_snapshot, _is_chief, _map_tree,
                   broadcast_ints)

CRC_KEY = "__crc__"

# Every block read from a proc-*.npz lands here; a restore from the buddy
# tier's RAM mirrors reads none.
read_stats = {"block_reads": 0, "block_bytes": 0}
_KEY_RE = re.compile(r"^(?P<path>.*)@(?P<starts>[\d,]*)@(?P<shape>[\d,]*)$")


class ShardCorruptionError(RuntimeError):
    """A block of a sharded checkpoint failed validation (CRC mismatch,
    torn or garbage file); ``path`` and ``key`` name it."""

    def __init__(self, message: str, *, path=None, key: Optional[str] = None):
        super().__init__(message)
        self.path = str(path) if path is not None else None
        self.key = key


def _block_key(path: str, starts, shape) -> str:
    return (f"{path}@{','.join(map(str, starts))}@"
            f"{','.join(map(str, shape))}")


def _parse_key(key: str) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(f"malformed shard block key: {key!r}")

    def ints(s):
        return tuple(int(v) for v in s.split(",")) if s else ()

    return m.group("path"), ints(m.group("starts")), ints(m.group("shape"))


def block_crc(data: np.ndarray) -> int:
    """CRC32 of a block's bytes."""
    return zlib.crc32(np.ascontiguousarray(data).tobytes()) & 0xFFFFFFFF


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _any(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return bool(t.item())


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return np.dtype(str(leaf.dtype).replace("torch.", ""))
    return np.asarray(leaf).dtype


def _leaves(model):
    """``[(path, full shape, this rank's data, its layout)]`` for every
    leaf of a checkpoint of ``model``: the data a tensor (or numpy
    scalar), the layout None for a leaf held whole."""
    out = []
    for path, t in model.live_params().items():
        lay = layout_of(t)
        out.append((f"params/{path}", lay.shape if lay else tuple(t.shape),
                    t, lay))
    for path, t in model.state.items():
        out.append((f"state/{path}", tuple(t.shape), t, None))
    if model.opt_state is not None:
        from ..training.model import _LocalLeaf

        for path, leaf in iter_leaf_paths(model._opt_tree("local")):
            if isinstance(leaf, _LocalLeaf):
                lay = leaf.layout
                shape = lay.shape if lay else tuple(leaf.tensor.shape)
                out.append((f"opt_state/{path}", shape, leaf.tensor, lay))
            else:
                out.append((f"opt_state/{path}", tuple(np.shape(leaf)), leaf,
                            None))
    return out


def extract_blocks(model, rank: int):
    """``(blocks, leaves_meta)``: this rank's blocks of every leaf
    (``{key: tensor or array}``; a whole leaf only on rank 0) and every
    leaf's full shape and dtype (the manifest's ``leaves``, the same on
    every rank)."""
    blocks: Dict[str, Any] = {}
    meta: Dict[str, dict] = {}
    # A block split over some mesh axes (tensor parallelism) is held
    # alike by every rank of the others: the first of them writes it.
    for path, shape, data, lay in _leaves(model):
        meta[path] = {"shape": list(shape), "dtype": _np_dtype(data).name}
        if lay is not None:
            if model.strategy.writes_block(lay):
                blocks[_block_key(path, lay.starts, lay.local_shape)] = data
        elif rank == 0:
            blocks[_block_key(path, (0,) * len(shape), shape)] = data
    return blocks, meta


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").numpy()
    return np.asarray(leaf)


def _write_proc_npz(path: Path, blocks: Dict[str, np.ndarray]) -> int:
    """Atomic write of one rank's block file, its CRC map included;
    returns the largest block's bytes."""
    crcs = {k: block_crc(v) for k, v in blocks.items()}
    payload = dict(blocks)
    payload[CRC_KEY] = np.frombuffer(json.dumps(crcs).encode(),
                                     dtype=np.uint8).copy()
    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **payload)

    _atomic_write(path, write)
    return max((v.nbytes for v in blocks.values()), default=0)


class _BlockIndex:
    """Every saved block of one step: ``{leaf path: [(starts, shape, file,
    key)]}``, with the npz files opened when a block is read and each
    block's CRC checked."""

    def __init__(self, step_dir: Path, nprocs: int):
        self._files = [step_dir / f"proc-{i}.npz" for i in range(nprocs)]
        self._handles: Dict[int, Any] = {}
        self._crcs: Dict[int, Optional[dict]] = {}
        self.blocks: Dict[str, list] = {}
        for fi, f in enumerate(self._files):
            if not f.exists():
                raise FileNotFoundError(
                    f"checkpoint shard file missing: {f} (the manifest "
                    f"promises {nprocs} processes; is the directory "
                    "shared?)")
            try:
                with np.load(f, allow_pickle=False) as z:
                    names = list(z.files)
            except Exception as e:
                raise ShardCorruptionError(
                    f"checkpoint shard file {f} is unreadable "
                    f"({type(e).__name__}: {e})", path=f) from e
            for key in names:
                if key == CRC_KEY:
                    continue
                path, starts, shape = _parse_key(key)
                self.blocks.setdefault(path, []).append(
                    (starts, shape, fi, key))

    def _handle(self, fi: int):
        h = self._handles.get(fi)
        if h is None:
            try:
                h = np.load(self._files[fi], allow_pickle=False)
            except Exception as e:
                raise ShardCorruptionError(
                    f"checkpoint shard file {self._files[fi]} is unreadable "
                    f"({type(e).__name__}: {e})", path=self._files[fi]) from e
            self._handles[fi] = h
            crcs = None
            if CRC_KEY in h.files:
                try:
                    crcs = json.loads(bytes(h[CRC_KEY]).decode())
                except Exception as e:
                    raise ShardCorruptionError(
                        f"CRC map of {self._files[fi]} is unreadable "
                        f"({type(e).__name__}: {e})",
                        path=self._files[fi]) from e
            self._crcs[fi] = crcs
        return h

    def read(self, fi: int, key: str) -> np.ndarray:
        h = self._handle(fi)
        try:
            data = h[key]
        except Exception as e:
            raise ShardCorruptionError(
                f"block {key!r} of {self._files[fi]} failed to load "
                f"({type(e).__name__}: {e})", path=self._files[fi],
                key=key) from e
        want = (self._crcs.get(fi) or {}).get(key)
        if want is not None and block_crc(data) != int(want):
            raise ShardCorruptionError(
                f"CRC mismatch for block {key!r} in {self._files[fi]}: "
                f"stored {int(want)}, computed {block_crc(data)}; the block "
                "is corrupt on disk", path=self._files[fi], key=key)
        read_stats["block_reads"] += 1
        read_stats["block_bytes"] += int(data.nbytes)
        return data

    def close(self):
        for h in self._handles.values():
            h.close()
        self._handles.clear()


def _assemble(index, path: str, shape, dtype, region):
    """The ``region`` (slices of the full leaf) of leaf ``path``, from the
    saved blocks that overlap it (decided from their keys; only those are
    read). Returns ``(array, largest block's bytes)``."""
    req = [(0 if sl.start is None else sl.start,
            dim if sl.stop is None else sl.stop)
           for sl, dim in zip(region, shape)]
    out = np.empty(tuple(hi - lo for lo, hi in req), dtype)
    filled, biggest = 0, 0
    for starts, bshape, fi, key in index.blocks.get(path, []):
        dst = []
        for d, (lo, hi) in enumerate(req):
            b0 = starts[d] if d < len(starts) else 0
            s, e = max(b0, lo), min(b0 + bshape[d], hi)
            if s >= e:
                break
            dst.append((s - lo, e - lo, s - b0, e - b0))
        else:
            block = index.read(fi, key).reshape(bshape)
            biggest = max(biggest, block.nbytes)
            out_sel = tuple(slice(a, b) for a, b, _, _ in dst)
            blk_sel = tuple(slice(c, d) for _, _, c, d in dst)
            out[out_sel] = block[blk_sel]
            filled += int(np.prod(out[out_sel].shape))
    if filled < int(np.prod(out.shape)):
        raise ValueError(
            f"saved blocks for {path!r} do not cover the requested block "
            f"{req} (filled {filled} of {int(np.prod(out.shape))} elements)")
    return out, biggest


def _read_all(model, index, manifest: dict):
    """This rank's region of every leaf of ``model``'s checkpoint, read
    and checked: ``({path: array}, has the file an optimizer state, the
    largest block's bytes)``. Nothing of the model changes. ``index`` is
    anything with ``blocks`` (``{leaf path: [(starts, shape, handle,
    key)]}``) and ``read(handle, key)``: the disk's ``_BlockIndex`` or the
    buddy tier's mirror index."""
    leaves_meta = manifest["leaves"]
    step = int(manifest["step"])
    has_opt = any(p.startswith("opt_state/") for p in leaves_meta)
    got, biggest = {}, 0
    for path, shape, _, lay in _leaves(model):
        if path.startswith("opt_state/") and not (model.compiled and has_opt):
            continue
        meta = leaves_meta.get(path)
        if meta is None:
            raise KeyError(f"checkpoint step {step} has no leaf {path!r}; "
                           "wrong model or optimizer for this checkpoint")
        if tuple(meta["shape"]) != tuple(shape):
            raise ValueError(
                f"checkpoint leaf {path!r} has global shape "
                f"{tuple(meta['shape'])} but the model expects "
                f"{tuple(shape)}; wrong model for this checkpoint")
        if path not in index.blocks:
            raise KeyError(f"no saved blocks for leaf {path!r} in step {step}")
        region = (lay.index() if lay is not None
                  else tuple(slice(0, d) for d in shape))
        got[path], b = _assemble(index, path, shape,
                                 np.dtype(meta["dtype"]), region)
        biggest = max(biggest, b)
    return got, has_opt, biggest


def _apply_read(model, got: Dict[str, np.ndarray], manifest: dict) -> int:
    """Load the arrays :func:`_read_all` read (this rank's blocks) into
    ``model``; returns the step."""
    opt_flat = {p[len("opt_state/"):]: a for p, a in got.items()
                if p.startswith("opt_state/")}
    opt_state = None
    if opt_flat:
        opt_state = interop.opt_state_from_tree(
            model.tx, opt_flat, model.live_params(),
            layouts=model.opt_layouts, blocks=True)
    with torch.no_grad():
        for path, t in model.live_params().items():
            t.copy_(torch.from_numpy(got[f"params/{path}"]))
        for path, t in model.state.items():
            t.copy_(torch.from_numpy(got[f"state/{path}"]))
    if opt_state is not None:
        model.opt_state = opt_state
    model._decode_dtype = None
    step = int(manifest["step"])
    model.step = step
    model._seed = int(manifest.get("seed", model._seed))
    model._resumed_step = step
    # fit() moves an iterator source to this cursor (load_state).
    model._restored_data_state = manifest.get("data_state")
    return step


def restore_from_index(model, index, manifest: dict) -> Tuple[int, int]:
    """Load ``model`` (built from the manifest first if it is not) from a
    block index: the disk's ``_BlockIndex`` or the buddy tier's in-memory
    mirror index, through the same overlap reassembly, so a restore from
    RAM reshards across world sizes and strategies as a disk one does.
    ``manifest`` carries ``step``, ``seed``, ``input_shape`` and
    ``leaves`` (and may carry ``data_state``). Returns ``(step, the
    largest block's bytes)``. Nothing is agreed with the other ranks."""
    if not model.built:
        model.build(manifest["input_shape"], seed=manifest.get("seed", 0))
    got, _, biggest = _read_all(model, index, manifest)
    return _apply_read(model, got, manifest), biggest


class ShardedCheckpointer:
    """Per-rank sharded checkpoints whose restore does not depend on the
    saving run's world size or strategy (module docstring); the
    ``Checkpointer`` surface: ``save(model)``, ``restore_into(model)``,
    ``all_steps``, ``latest_step``, ``wait``. Every rank calls each of
    them (the commit and the restore's agreement are collectives)."""

    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.directory = Path(directory)
        self.keep = int(keep)
        self.async_save = bool(async_save)
        # The largest block the last save or restore touched on this rank
        # (a sharded leaf's block, never the whole leaf).
        self.last_max_block_bytes = 0
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._writer_lock = threading.Lock()
        self._pending: Optional[dict] = None  # manifest awaiting commit

    def wait(self) -> None:
        """Join the background write in flight, then run the deferred
        commit (on this thread); re-raise the writer's error, the pending
        step then abandoned on every rank."""
        with self._writer_lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._writer_error = self._writer_error, None
        self._finalize_pending(failed=err is not None)
        if err is not None:
            raise err

    # ------------------------------------------------------------- layout --
    def _step_dir(self, step: int) -> Path:
        return self.directory / f"ckpt-{step}"

    def all_steps(self):
        if not self.directory.is_dir():
            return []
        steps = []
        for p in self.directory.glob("ckpt-*"):
            m = re.fullmatch(r"ckpt-(\d+)", p.name)
            # manifest.json is the commit marker.
            if m and (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # --------------------------------------------------------------- save --
    def save(self, model, step: Optional[int] = None) -> Path:
        self.wait()
        step = int(model.step if step is None else step)
        step_dir = self._step_dir(step)
        step_dir.mkdir(parents=True, exist_ok=True)
        rank = _rank()
        blocks, leaves_meta = extract_blocks(model, rank)
        manifest = {"step": step, "seed": int(model._seed),
                    "input_shape": list(model.input_shape or ()),
                    "nprocs": _world(), "leaves": leaves_meta}
        dstate = _data_state_of(model, step)
        if dstate is not None:
            manifest["data_state"] = dstate
        target = step_dir / f"proc-{rank}.npz"
        if self.async_save:
            snap, device, event = _device_snapshot(blocks)

            def write():
                try:
                    if device is not None:
                        stream = torch.cuda.Stream(device=device)
                        with torch.cuda.stream(stream):
                            stream.wait_event(event)
                            host = _map_tree(_to_numpy, snap)
                    else:
                        host = _map_tree(_to_numpy, snap)
                    self.last_max_block_bytes = _write_proc_npz(target, host)
                except BaseException as e:  # raised at the next wait/save
                    self._writer_error = e

            self._pending = manifest
            writer = threading.Thread(target=write, name="dtpu-shard-writer",
                                      daemon=True)
            with self._writer_lock:
                self._writer = writer
            _ASYNC_CHECKPOINTERS.add(self)
            writer.start()
            return step_dir
        self.last_max_block_bytes = _write_proc_npz(
            target, {k: _to_numpy(v) for k, v in blocks.items()})
        self._pending = manifest
        self._finalize_pending(failed=False)
        return step_dir

    def _finalize_pending(self, *, failed: bool) -> None:
        """The deferred commit: every rank's write landed (an all-reduce
        of the outcomes, the barrier too), then rank 0 writes the manifest
        and collects old steps, and the ranks wait for it."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        if _any(failed):
            return
        if _is_chief():
            _atomic_write(
                self._step_dir(int(pending["step"])) / "manifest.json",
                lambda tmp: Path(tmp).write_text(json.dumps(pending)))
            self._gc()
        _any(False)  # a barrier: the step is committed when any rank returns

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------ restore --
    def restore_into(self, model, step: Optional[int] = None) -> int:
        """Restore this rank's blocks under ``model``'s live strategy;
        returns the step. ``step=None`` takes the newest committed step
        that every rank reads without corruption (rank 0's directory
        listing decides the candidates), skipping corrupt ones with a
        ``corrupt_checkpoint_skipped`` event; a named step raises
        :class:`ShardCorruptionError` instead."""
        self.wait()
        if step is not None:
            return self._restore_step(model, int(step), explicit=True)
        excluded: set = set()
        while True:
            cands = [s for s in self.all_steps() if s not in excluded]
            cand = broadcast_ints([cands[-1] if cands else -1])[0]
            if cand < 0:
                raise FileNotFoundError(
                    f"No sharded checkpoints in {self.directory}"
                    + (f" ({len(excluded)} step(s) present but corrupt)"
                       if excluded else ""))
            try:
                return self._restore_step(model, cand, explicit=False)
            except ShardCorruptionError as e:
                dlog.warning(
                    f"ShardedCheckpointer: skipping corrupt step {cand} "
                    f"({e}); falling back to the previous retained step")
                events_lib.emit(
                    evs.CORRUPT_CHECKPOINT_SKIPPED, step=int(cand),
                    path=e.path or str(self._step_dir(cand)), error=str(e))
                excluded.add(cand)

    def _restore_step(self, model, step: int, explicit: bool) -> int:
        """Read this rank's blocks of ``step``; when every rank read its
        own cleanly, load them. A corrupt block on any rank raises
        :class:`ShardCorruptionError` on every rank (the others' names the
        step), so the ranks fall back together."""
        step_dir = self._step_dir(step)
        error = None
        got = None
        try:
            try:
                manifest = json.loads(
                    (step_dir / "manifest.json").read_text())
            except FileNotFoundError:
                raise
            except (OSError, ValueError) as e:
                raise ShardCorruptionError(
                    f"manifest of {step_dir} is unreadable "
                    f"({type(e).__name__}: {e})",
                    path=step_dir / "manifest.json") from e
            if not model.built:
                model.build(manifest["input_shape"],
                            seed=manifest.get("seed", 0))
            index = _BlockIndex(step_dir, int(manifest["nprocs"]))
            try:
                got, _, biggest = _read_all(model, index, manifest)
            finally:
                index.close()
        except ShardCorruptionError as e:
            error = e
        if _any(error is not None):
            raise error or ShardCorruptionError(
                f"step {step} of {self.directory}: another rank read a "
                "corrupt block", path=step_dir)
        self.last_max_block_bytes = biggest
        return _apply_read(model, got, manifest)


__all__ = ["ShardCorruptionError", "ShardedCheckpointer", "block_crc",
           "extract_blocks", "read_stats", "restore_from_index"]
