"""Build and load the port's CUDA sources (``csrc/<name>.cu``).

Each source has a plain C interface and is compiled by one ``nvcc`` call
for ``sm_90a`` into the git-ignored ``_build/`` at first use, then loaded
with ``ctypes``. A build is keyed on a hash of the source and the flags,
so an edited source builds anew and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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


def _library_path(name: str) -> Path:
    src = source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str):
    """Compile ``csrc/<name>.cu`` for each name not built yet, one
    ``nvcc`` process per source, all running at once. Returns
    ``{name: (library_path, compiler_output)}``; ``compiler_output`` holds
    ptxas's register and spill report of a fresh build, "" for a reused
    one. Raises ``RuntimeError`` with nvcc's output when a build fails."""
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
#: The ``dtype`` argument of every launcher: 0 = float32, 1 = bfloat16.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Library:
    """One built source, loaded once per process. ``signatures`` maps each
    exported function to its ctypes argument types; every function
    returns an int (a ``cudaError_t`` for the launchers)."""

    def __init__(self, name: str, signatures):
        self.name = name
        self.signatures = dict(signatures)
        self._handle = None

    def get(self):
        if self._handle is None:
            path, _ = build(self.name)[self.name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = _I
            self._handle = lib
        return self._handle


def check_launch(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (0 is cudaSuccess)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def require(t, name, device, dtype=None, ndim=None):
    """Raise unless ``t`` is a contiguous tensor on ``device`` (and of
    ``dtype`` and ``ndim`` where given): what a kernel's pointers need."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def dispatch(x, cuda_fn, plain_fn, what: str):
    """The function to run on ``x``'s device, with no fallback: a CUDA
    tensor gets the kernel's wrapper (which launches it or raises), a CPU
    tensor the plain version; any other device raises."""
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{what}: unsupported device {x.device}")


__all__ = [
    "BUILD_DIR", "CSRC", "DTYPE_CODES", "Library", "NVCC_FLAGS", "build", "check_launch",
    "dispatch", "require", "source", "stream",
]
