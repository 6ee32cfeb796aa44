"""Checkpoints, HDF5 model export and artifact transport.

The counterpart of the JAX package's ``checkpoint/core.py``, with its
files: a checkpoint written by either package restores in the other.

- ``export_hdf5`` + ``artifact_encode``/``artifact_decode``: the
  reference's model retrieval (rank 0 saves the model as HDF5, the file
  travels back as base64 through the launcher's result channel, and the
  launching process decodes it into ``model.hdf5``).
- ``Checkpointer``: step-tagged ``ckpt-<step>.npz`` files of
  ``{"params", "state", "opt_state"}`` and a meta record (``step``,
  ``seed``, ``input_shape``), so a run that died resumes where it was;
  the reference cannot ("Workers will need to restart training if any
  fails").

Format: the tree flattened to ``{path: array}`` (sorted dict keys, ``#i``
for tuple entries, ``/`` between), the meta as JSON bytes under
``__meta__``, loaded with ``allow_pickle=False``. The port's parameters
and state are ``{path: tensor}`` under the JAX package's paths, and its
optimizer state is written under optax's (``interop.opt_state_to_tree``),
so the flat paths, dtypes and meta keys are the JAX package's.

Writes are chief-only (rank 0 of the ``torch.distributed`` group when one
is initialized). Under ``DataParallel`` every rank holds the whole
replica; under ``ZeroDataParallel`` and ``FSDP`` a save first gathers the
full leaves, parameters and optimizer state alike (every rank calls
``save``: the gathers are collectives), and a restore places each full
leaf into this rank's block under the live strategy, so a file moves
between strategies and world sizes (``checkpoint/sharded.py`` writes
blocks instead). ``h5py`` is imported by the HDF5 functions only, so the
package imports without it.
"""

from __future__ import annotations

import base64
import json
import os
import re
import tempfile
import threading
import weakref
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import interop
from ..interop import SEP, iter_leaf_paths
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import logging as dlog

# Checkpointers that have started a background save, so that
# ``wait_all_async`` can flush every pending write.
_ASYNC_CHECKPOINTERS: "weakref.WeakSet[Checkpointer]" = weakref.WeakSet()

# What a torn or garbage checkpoint file raises out of np.load and the
# meta's JSON decode. Anything else is a fault and propagates.
_CORRUPT_ERRORS = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def wait_all_async() -> None:
    """Block until the background save of every ``Checkpointer`` has
    landed (file, gc and ``latest`` pointer); a writer's error is raised."""
    for ck in list(_ASYNC_CHECKPOINTERS):
        ck.wait()


def _to_host(val) -> np.ndarray:
    """A leaf as a numpy array of its own (a tensor is copied off its
    device, a CPU tensor copied too, so the array never aliases it)."""
    if isinstance(val, torch.Tensor):
        return val.detach().to("cpu", copy=True).numpy()
    return np.asarray(val)


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    """``{path: numpy array}`` for every leaf of ``tree``."""
    return {p: _to_host(v) for p, v in iter_leaf_paths(tree, prefix)}


def unflatten_tree(flat: Dict[str, Any]):
    """The nested tree of ``{path: leaf}``: a node whose keys are all
    ``#i`` becomes a tuple, its entries in numeric order. Tuple entries
    that flatten to nothing (optax's empty states) leave gaps in the
    numbers, which are skipped, so the leaves keep their order."""
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return tuple(fix(node[f"#{i}"])
                         for i in sorted(int(k[1:]) for k in node))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _is_chief() -> bool:
    """Rank 0 of the process group, or True without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_ints(values: List[int]) -> List[int]:
    """Rank 0's ``values`` on every rank of the group (as given without
    one)."""
    if _world() < 2:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src=0)
    return [int(v) for v in t.tolist()]


def _atomic_write(path: Path, write_fn):
    """Write through a temporary file in the same directory, fsync it,
    then rename it into place: a crash leaves the old file or the new one,
    never a torn one under the real name."""
    tmp_fd, tmp_name = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    os.close(tmp_fd)
    try:
        write_fn(tmp_name)
        fd = os.open(tmp_name, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp_name, path)
    finally:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)


def _data_state_of(model, step: int) -> Optional[dict]:
    """The cursor of the data source ``fit`` is reading, for the meta: None
    when there is none (host arrays: their cursor is ``model.step``) or it
    has no ``state_dict``. ``step`` is the step the model trained to,
    which a prefetching fit's source may have run ahead of."""
    src = getattr(model, "_fit_source", None)
    if src is None or not hasattr(src, "state_dict"):
        return None
    state = src.state_dict(consumed_steps=step)
    json.dumps(state)
    return state


def _device_snapshot(tree):
    """(copy of ``tree``, its card or None, CUDA event or None) for a
    background writer: each tensor is cloned on the caller's current
    stream, now, so the copies are ordered before the next step's in-place
    update; the event is recorded after the clones, and the writer waits
    for it before it reads them. numpy leaves are copied on the host."""
    devices = set()

    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                devices.add(leaf.device)
            return leaf.detach().clone()
        return np.array(leaf, copy=True)

    snap = _map_tree(copy, tree)
    if len(devices) > 1:
        raise ValueError(f"a snapshot spans the cards {sorted(devices)}")
    if not devices:
        return snap, None, None
    device = devices.pop()
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return snap, device, event


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return None if tree is None else fn(tree)


# ---------------------------------------------------------------------- npz --
def save_npz(path, tree, meta: Optional[dict] = None):
    """Chief-only atomic save of a tree (params, or ``{params, state,
    ...}``) with an optional JSON meta record."""
    path = Path(path)
    if not _is_chief():
        return path
    flat = flatten_tree(tree)
    path.parent.mkdir(parents=True, exist_ok=True)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8).copy()
    _atomic_write(path, lambda tmp: np.savez(open(tmp, "wb"), **flat))
    return path


def _load_flat(path) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """({path: array}, meta) of a ``save_npz`` file: the paths as written,
    optax's tuple numbers and their gaps included."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if "__meta__" in flat:
        meta = json.loads(bytes(flat.pop("__meta__")).decode())
    return flat, meta


def load_npz(path) -> Tuple[Any, Optional[dict]]:
    """(tree, meta) of a file ``save_npz`` wrote (meta None without one)."""
    flat, meta = _load_flat(path)
    return unflatten_tree(flat), meta


def _section(flat: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The leaves of ``flat`` under ``name/``, with that prefix cut."""
    return {p[len(name) + 1:]: v for p, v in flat.items()
            if p.startswith(name + SEP)}


# --------------------------------------------------------------------- hdf5 --
def export_hdf5(path, params, attrs: Optional[dict] = None):
    """Model weights as HDF5, the reference's interchange format: one
    dataset per leaf under its path, ``attrs`` on the file. Chief-only."""
    import h5py

    path = Path(path)
    if not _is_chief():
        return path
    flat = flatten_tree(params)
    path.parent.mkdir(parents=True, exist_ok=True)

    def write(tmp):
        with h5py.File(tmp, "w") as f:
            for key, val in flat.items():
                f.create_dataset(key, data=val)
            for k, v in (attrs or {}).items():
                f.attrs[k] = v

    _atomic_write(path, write)
    return path


def import_hdf5(path):
    """(tree, attrs) of an HDF5 file ``export_hdf5`` wrote (by either
    package)."""
    import h5py

    flat = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                flat[name] = np.asarray(obj)

        f.visititems(visit)
        attrs = dict(f.attrs)
    return unflatten_tree(flat), attrs


# ----------------------------------------------------------------- artifact --
def artifact_encode(path) -> str:
    """A file as a base64 string, for returning a trained model through a
    text result channel (``launch.report_result``)."""
    return base64.b64encode(Path(path).read_bytes()).decode()


def artifact_decode(b64: str, out_path):
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_bytes(base64.b64decode(b64))
    return out_path


# ------------------------------------------------------------- checkpointer --
class Checkpointer:
    """Step-tagged training checkpoints with resume.

    Layout: ``dir/ckpt-<step>.npz`` holding params, state and opt_state
    with the meta record, and a ``latest`` pointer file (JSON ``{"step":
    N}``) written atomically after every completed save; ``keep`` files
    are kept, the older ones deleted. ``restore_into(model)`` loads the
    newest loadable file (a corrupt one is skipped with a warning) or the
    given step (which must load), into a model built from the meta if it
    is not built yet.

    Under a process group of more than one rank only rank 0 needs the
    files: it picks the step and broadcasts a header, then the leaves, so
    every rank ends with the same bits.

    ``async_save=True``: ``save`` clones the tree on the device and
    returns; a writer thread copies the clones to the host once they are
    done (it waits on a CUDA event recorded after them), writes the file,
    gcs and moves the pointer. A new ``save`` waits for the write before;
    ``wait()`` is the barrier, and a writer's error is raised by the next
    ``save`` or ``wait``.
    """

    LATEST_NAME = "latest"

    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.directory = Path(directory)
        self.keep = int(keep)
        self.async_save = bool(async_save)
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._writer_lock = threading.Lock()

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt-{step}.npz"

    def all_steps(self) -> List[int]:
        if not self.directory.is_dir():
            return []
        steps = []
        for p in self.directory.glob("ckpt-*.npz"):
            m = re.fullmatch(r"ckpt-(\d+)\.npz", p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    # -------------------------------------------------------- latest pointer
    def _write_latest_pointer(self, step: int):
        payload = json.dumps({"step": int(step)})
        self.directory.mkdir(parents=True, exist_ok=True)
        _atomic_write(self.directory / self.LATEST_NAME,
                      lambda tmp: Path(tmp).write_text(payload))

    def _read_latest_pointer(self) -> Optional[int]:
        try:
            rec = json.loads((self.directory / self.LATEST_NAME).read_text())
            return int(rec["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def latest_step(self) -> Optional[int]:
        """The newest step on disk: the pointer, unless the glob finds a
        newer file (a crash between the file's rename and the pointer's
        leaves the pointer one save behind) or the pointer's file is
        gone."""
        steps = self.all_steps()
        ptr = self._read_latest_pointer()
        if ptr is not None and self._path(ptr).exists():
            return max(ptr, steps[-1]) if steps else ptr
        return steps[-1] if steps else None

    # ------------------------------------------------------------- validity
    def is_valid(self, step: int) -> bool:
        """Whether the file opens as a zip whose member table reads (the
        arrays are not decompressed)."""
        try:
            with np.load(self._path(step), allow_pickle=False) as z:
                z.files  # noqa: B018 - reads the zip directory
            return True
        except _CORRUPT_ERRORS:
            return False

    def latest_valid_step(self) -> Optional[int]:
        for step in reversed(self.all_steps()):
            if self.is_valid(step):
                return step
        return None

    def _load_latest_valid(self) -> Tuple[int, Dict[str, np.ndarray], dict]:
        """(step, flat leaves, meta) of the newest file that loads; each
        corrupt one is skipped with a warning."""
        steps = self.all_steps()
        for step in reversed(steps):
            try:
                flat, meta = _load_flat(self._path(step))
                return step, flat, meta
            except _CORRUPT_ERRORS as e:
                dlog.warning(
                    f"Checkpointer: skipping corrupt checkpoint "
                    f"{self._path(step).name} ({type(e).__name__}: {e}); "
                    "falling back to the previous step")
                events_lib.emit(
                    evs.CORRUPT_CHECKPOINT_SKIPPED, step=int(step),
                    path=str(self._path(step)), error=str(e))
        raise FileNotFoundError(
            f"No loadable checkpoints in {self.directory} "
            f"({len(steps)} candidate file(s), all corrupt)"
            if steps else f"No checkpoints in {self.directory}")

    # ----------------------------------------------------------------- save
    def wait(self) -> None:
        """Block until the background save in flight (if any) has landed;
        raise its error if it failed."""
        with self._writer_lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def save(self, model, step: Optional[int] = None) -> Path:
        step = int(model.step if step is None else step)
        path = self._path(step)
        self.wait()
        # Full leaves on every rank (gathered where they are sharded).
        tree = {"params": model.params, "state": model.state}
        if model.opt_state is not None:
            tree["opt_state"] = model._opt_tree("full")
        if not _is_chief():
            return path
        meta = {"step": step, "seed": int(model._seed),
                "input_shape": list(model.input_shape or ())}
        dstate = _data_state_of(model, step)
        if dstate is not None:
            meta["data_state"] = dstate
        if self.async_save:
            return self._save_async(tree, meta, step)
        save_npz(path, tree, meta)
        self._gc()
        self._write_latest_pointer(step)
        return path

    def _save_async(self, tree, meta: dict, step: int) -> Path:
        snap, device, event = _device_snapshot(tree)
        path = self._path(step)

        def write():
            try:
                if device is not None:
                    stream = torch.cuda.Stream(device=device)
                    with torch.cuda.stream(stream):
                        stream.wait_event(event)
                        host = _map_tree(_to_host, snap)
                else:
                    host = snap
                save_npz(path, host, meta)
                self._gc()
                self._write_latest_pointer(step)
            except Exception as e:  # raised by the next save/wait
                self._writer_error = e

        writer = threading.Thread(target=write, name="dtpu-ckpt-writer",
                                  daemon=True)
        with self._writer_lock:
            self._writer = writer
        _ASYNC_CHECKPOINTERS.add(self)
        writer.start()
        return path

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.keep)]:
            try:
                self._path(s).unlink()
            except OSError:
                pass

    # -------------------------------------------------------------- restore
    def restore_into(self, model, step: Optional[int] = None) -> int:
        """Load params, state, the optimizer state (when the model is
        compiled and the file has one) and the step cursor; returns the
        step. ``model.step``, ``model._seed`` and ``model._resumed_step``
        are set. Without ``step``, corrupt files are skipped down to the
        newest loadable one; a given step loads exactly that file or
        raises."""
        if _world() > 1:
            return self._restore_multirank(model, step)
        if step is None:
            step, flat, meta = self._load_latest_valid()
        else:
            flat, meta = _load_flat(self._path(step))
        if not model.built:
            model.build(meta["input_shape"], seed=meta.get("seed", 0))
        _apply(model, flat, int(meta["step"]),
               int(meta.get("seed", model._seed)))
        # fit() moves an iterator source to this cursor (load_state).
        model._restored_data_state = meta.get("data_state")
        return model.step

    def _restore_multirank(self, model, step: Optional[int]) -> int:
        """Rank 0 loads the file and broadcasts a header (step, seed, the
        file's leaf counts, whether its paths and shapes fit the model),
        then the leaves: one flat buffer per dtype, in the order of the
        model's own paths. Every rank takes the same decision from the
        header (a file rank 0 could not load included), so an error is
        raised on all of them and none waits on a broadcast that never
        comes."""
        if not (model.built and model.compiled):
            raise RuntimeError(
                "Multi-rank restore needs a built and compiled model: the "
                "other ranks take the shapes from it (fit() builds before "
                "the callbacks run, so ModelCheckpoint(restore=True) "
                "satisfies this)")
        want = _full_specs(model)
        sections = ("params", "state", "opt_state")
        flat, error = None, None
        header = [-1, 0, 0, 0, 0, 0]
        if _is_chief():
            try:
                if step is None:
                    found, flat, meta = self._load_latest_valid()
                else:
                    flat, meta = _load_flat(self._path(step))
                    found = step
            except FileNotFoundError as e:  # the scan found none: -1
                if step is not None:
                    error = e
            except _CORRUPT_ERRORS as e:
                error = e
            if error is not None:
                header[0] = -2
            elif flat is not None:
                counts = [len(_section(flat, s)) for s in sections]
                if counts[2] == 0:  # saved uncompiled: keep the fresh state
                    want = _without_opt(want)
                fits = set(flat) == set(want) and all(
                    flat[p].shape == shape for p, (shape, _) in want.items())
                header = [found, int(meta.get("seed", model._seed)),
                          *counts, int(fits)]
        agreed, seed, n_p, n_s, n_o, fits = broadcast_ints(header)
        if agreed == -2:
            raise error or RuntimeError(
                f"rank 0 could not load step {step} from {self.directory}")
        if agreed < 0:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        if not fits:
            mine = [len(_section(want, s)) for s in sections]
            raise RuntimeError(
                f"Checkpoint step {agreed} has {n_p} param, {n_s} state and "
                f"{n_o} optimizer tensors but the model has {mine[0]}, "
                f"{mine[1]} and {mine[2]}, or their paths or shapes differ "
                "- wrong model or optimizer for this checkpoint")
        if n_o == 0:
            want = _without_opt(want)
        _apply(model, _broadcast_leaves(want, flat), agreed, seed)
        return model.step


def _full_specs(model) -> Dict[str, Any]:
    """``{path: (full shape, torch dtype)}`` of every leaf a checkpoint of
    ``model`` holds (no gather: the shapes come from the layouts)."""
    template = {"params": {p: torch.empty(s, dtype=t.dtype, device="meta")
                           for (p, s), t in zip(
                               model._param_shapes().items(),
                               model._param_list())},
                "state": model.state, "opt_state": model._opt_tree("meta")}
    return {p: (tuple(v.shape), torch.as_tensor(v).dtype)
            for p, v in iter_leaf_paths(template)}


def _without_opt(want: Dict[str, Any]) -> Dict[str, Any]:
    return {p: v for p, v in want.items()
            if not p.startswith("opt_state" + SEP)}


def _broadcast_leaves(want, flat) -> Dict[str, torch.Tensor]:
    """``{path: tensor on the comm device}`` for every path of ``want``
    (``{path: (shape, dtype)}``), rank 0's values from ``flat``: one
    broadcast per dtype, the leaves concatenated in sorted path order."""
    dev = _comm_device()
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for p in sorted(want):
        by_dtype.setdefault(want[p][1], []).append(p)
    out = {}
    for dtype, paths in by_dtype.items():
        sizes = [int(np.prod(want[p][0], dtype=np.int64)) for p in paths]
        if flat is not None:
            buf = torch.cat([torch.as_tensor(flat[p]).reshape(-1).to(dtype)
                             for p in paths]).to(dev)
        else:
            buf = torch.empty(sum(sizes), dtype=dtype, device=dev)
        dist.broadcast(buf, src=0)
        for p, piece in zip(paths, buf.split(sizes)):
            out[p] = piece.view(want[p][0])
    return out


def _apply(model, flat, step: int, seed: int) -> None:
    """Load a checkpoint's flat leaves (``params/...``, ``state/...`` and,
    when the model is compiled and the file has them, ``opt_state/...``)
    into ``model``, full leaves placed under its live strategy: everything
    is checked (paths, shapes, the optimizer's format) before anything is
    copied."""
    params, state = _section(flat, "params"), _section(flat, "state")
    model._check_tree(model._param_shapes(), params, "parameter")
    model._check_tree(model.state, state, "state")
    opt_flat = _section(flat, "opt_state")
    interop.place(model, params=params, state=state,
                  opt_state=opt_flat if model.compiled and opt_flat else None)
    model.step = step
    model._seed = seed
    model._resumed_step = step


__all__ = [
    "Checkpointer", "artifact_decode", "artifact_encode", "broadcast_ints",
    "export_hdf5", "flatten_tree", "import_hdf5", "load_npz", "save_npz",
    "unflatten_tree", "wait_all_async",
]
