"""Build and load the port's CUDA sources (``csrc/<name>.cu``).

Each source has a plain C interface and is compiled by one ``nvcc`` call
for ``sm_90a`` into the git-ignored ``_build/`` at first use, then loaded
with ``ctypes``. A build is keyed on a hash of the source, of every header
it includes from ``csrc/`` (``#include "name.cuh"``, followed through the
headers), and of the flags, so an edited source or header builds anew and
an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together; a failed build raises with the compiler's output.

The launch path, which every wrapper takes on every launch and which sets
the host's cost of a launch (the launch probe K15 measures it):

- :class:`Library` loads a source once a process and looks up its
  functions and constants (a kernel's limits) once;
- :func:`require` checks a tensor's device, dtype, rank and contiguity in
  one test on the way through;
- :func:`raw_stream` reads PyTorch's current stream as a raw handle,
  through the accessor CUDA builds of PyTorch expose, without building a
  ``torch.cuda.Stream`` object; it raises where the accessor is missing,
  and never passes 0 in place of the current stream;
- a launcher with many arguments takes them as one struct of 64-bit
  fields (:func:`packed`), packed by ``struct`` in one call and handed to
  ``ctypes`` as one pointer, instead of one converted argument each (K15,
  K1/K2, K13/K14);
- a kernel that merges its blocks' partial sums in one launch keeps its
  arrival counters and partials in a :func:`workspace` per (device,
  stream), and plans its grid from the card's :func:`sm_count` (K1/K2,
  K13/K14).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import struct
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "cannot be built"
    )


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def build_key(src: Path) -> str:
    """Hex digest of the source ``src``, of each header it includes by
    ``#include "..."`` (resolved beside the including file, each hashed
    once, its own includes followed), and of ``NVCC_FLAGS``."""
    h = hashlib.sha256()
    seen, todo = set(), [Path(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        h.update(str(len(data)).encode() + b":" + path.name.encode() + b":" + data)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(data)]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{build_key(source(name))[:16]}.so"


def build(*names: str):
    """Compile ``csrc/<name>.cu`` for each name not built yet, one
    ``nvcc`` process per source, all running at once. Returns ``{name:
    (library_path, compiler_output)}``; ``compiler_output`` holds ptxas's
    register and spill report of a fresh build, "" for a reused one.
    Raises ``RuntimeError`` with nvcc's output when a build fails."""
    out, running = {}, []
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) building "
                            f"{source(name)}:\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
#: The ``dtype`` argument of the launchers: 0 = float32, 1 = bfloat16,
#: 2 = float16.
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def packed(n: int) -> struct.Struct:
    """The layout of a launcher's packed arguments: ``n`` 64-bit fields
    (pointers, the stream handle and integers alike), which the C side
    reads as a struct of as many ``const void*``/``int64_t`` members."""
    return struct.Struct(f"={n}q")


class Library:
    """One built source, loaded once per process.

    ``signatures`` maps each exported function to its ctypes argument
    types; every function returns an int (for a launcher, 0 or the CUDA
    error of its launch). A launcher whose signature is a :func:`packed` layout
    takes its arguments as one ``bytes`` object from that layout's
    ``pack``, which ctypes hands over as a pointer with no conversion per
    argument; such a launcher ``dtt_x`` comes with ``dtt_x_args_bytes()``,
    checked against the layout when the library loads. Functions and
    :meth:`constant` values are looked up once per process."""

    def __init__(self, name: str, signatures):
        self.name = name
        self.signatures = dict(signatures)
        self._handle = None
        self._constants = {}

    def get(self):
        if self._handle is None:
            path, _ = build(self.name)[self.name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.restype = _I
                if isinstance(argtypes, struct.Struct):
                    size = getattr(lib, f"{fn}_args_bytes")()
                    if size != argtypes.size:
                        raise RuntimeError(
                            f"{fn} reads {size} bytes of arguments, the "
                            f"wrapper packs {argtypes.size}")
                else:
                    f.argtypes = list(argtypes)
            self._handle = lib
        return self._handle

    def constant(self, fn: str) -> int:
        """The int that the library's no-argument function ``fn``
        returns, called once per process."""
        value = self._constants.get(fn)
        if value is None:
            value = self._constants[fn] = int(getattr(self.get(), fn)())
        return value


_SMS = {}  # device index -> SM count


def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once a
    process."""
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def workspace(cache, dev, st, n_counters: int, n_floats: int):
    """``(counters, partials)`` for a kernel's launches on stream ``st`` of
    ``dev``: int32 arrival counters, which the kernel leaves at zero, and
    f32 partials. Kept in ``cache`` (one entry per device and stream, so
    launches on two streams never share counters) between calls, and
    grown when a call needs more."""
    ws = cache.get((dev.index, st))
    if ws is None or ws[0].numel() < n_counters or ws[1].numel() < n_floats:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = cache[(dev.index, st)] = (
            torch.zeros(max(n_counters, have[0]), dtype=torch.int32,
                        device=dev),
            torch.empty(max(n_floats, have[1]), dtype=torch.float32,
                        device=dev))
    return ws


def check_launch(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (0 is cudaSuccess)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def require(t, name, device, dtype=None, ndim=None):
    """Raise unless ``t`` is a contiguous tensor on ``device`` (and of
    ``dtype`` and ``ndim`` where given): what a kernel's pointers need.
    One test of the lot on the way through; the message names the first
    check that fails."""
    if (t.device == device and (dtype is None or t.dtype == dtype)
            and (ndim is None or t.dim() == ndim) and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    raise ValueError(f"{name} must be contiguous")


def _no_raw_stream(index):
    raise RuntimeError(
        "this PyTorch has no torch._C._cuda_getCurrentRawStream: the "
        "port's kernels need a CUDA build of PyTorch")


#: ``raw_stream(index)``: the raw handle of PyTorch's current stream on
#: CUDA device ``index`` — the accessor CUDA builds of PyTorch expose for
#: generated code, which builds no ``Stream`` object — or, where PyTorch
#: lacks it, a function that raises. A wrapper that knows its tensor is on
#: the card calls it with ``tensor.get_device()``.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _no_raw_stream)


def stream(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``, as
    the kernels take it: the stream a caller set with
    ``torch.cuda.stream(s)``, else the device's default. Raises for a
    device that is not CUDA, and where PyTorch lacks the accessor; it
    never stands 0 in for a stream it could not read."""
    if device.type != "cuda":
        raise ValueError(f"no CUDA stream on {device}")
    index = device.index
    return raw_stream(torch.cuda.current_device() if index is None else index)


def dispatch(x, cuda_fn, plain_fn, what: str):
    """The function to run on ``x``'s device, with no fallback: a CUDA
    tensor gets the kernel's wrapper (which launches it or raises), a CPU
    tensor the plain version; any other device raises."""
    if x.is_cuda:
        return cuda_fn
    if x.is_cpu:
        return plain_fn
    raise ValueError(f"{what}: unsupported device {x.device}")


__all__ = [
    "BUILD_DIR", "CSRC", "FLOAT_CODES", "Library", "NVCC_FLAGS", "build",
    "build_key", "check_launch", "dispatch", "packed", "raw_stream", "require",
    "sm_count", "source", "stream", "workspace",
]
