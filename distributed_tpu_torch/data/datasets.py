"""Dataset loaders: MNIST and CIFAR-10, offline.

A copy of the JAX package's ``data/datasets.py`` (which imports no JAX),
cut to what the port's CNN slice uses: ``load_mnist`` and
``load_cifar10`` with the reference's reshape-to-NHWC and /255 behind
``normalize=True``, and the synthetic stand-in ``synthetic_images``, whose
bytes are the JAX package's for the same arguments. Nothing is fetched:
there is no ``fetch_mnist``.

Resolution order per dataset:
1. explicit ``data_dir`` / ``$DTPU_DATA_DIR``
2. conventional caches (``~/.keras/datasets``, ``~/.cache/distributed_tpu``)
   in either npz (keras layout) or raw IDX / CIFAR-pickle form
3. deterministic synthetic data (unless ``synthetic_ok=False``): class-
   conditional templates plus noise, so models genuinely learn on it.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]


def _search_dirs(data_dir: Optional[str]):
    dirs = []
    if data_dir:
        dirs.append(Path(data_dir))
    env = os.environ.get("DTPU_DATA_DIR")
    if env:
        dirs.append(Path(env))
    dirs += [
        Path.home() / ".cache" / "distributed_tpu",
        Path.home() / ".keras" / "datasets",
    ]
    return [d for d in dirs if d.is_dir()]


# --------------------------------------------------------------------- IDX --
def _read_idx(path: Path) -> np.ndarray:
    """Parse an IDX file (optionally gzipped) — MNIST's native format."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0D: np.float32}[(magic >> 8) & 0xFF]
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=dtype)
    return data.reshape(shape)


_IDX_NAMES = {
    ("train", "x"): ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
    ("train", "y"): ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
    ("test", "x"): ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
    ("test", "y"): ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
}


def _try_idx(dirs, subdirs, split) -> Optional[Arrays]:
    for d in dirs:
        for sub in subdirs:
            base = d / sub if sub else d
            for xn in _IDX_NAMES[(split, "x")]:
                for ext in ("", ".gz"):
                    xp = base / (xn + ext)
                    if not xp.exists():
                        continue
                    for yn in _IDX_NAMES[(split, "y")]:
                        yp = base / (yn + ext)
                        if yp.exists():
                            return _read_idx(xp), _read_idx(yp)
    return None


def _try_npz(dirs, names, split) -> Optional[Arrays]:
    for d in dirs:
        for name in names:
            p = d / name
            if p.exists():
                with np.load(p, allow_pickle=False) as z:
                    if split == "train":
                        return z["x_train"], z["y_train"]
                    return z["x_test"], z["y_test"]
    return None


# --------------------------------------------------------------- synthetic --
def synthetic_images(
    n: int,
    shape: Tuple[int, ...],
    num_classes: int,
    seed: int,
    *,
    template_seed: Optional[int] = None,
) -> Arrays:
    """Learnable synthetic data: one smooth random template per class plus
    pixel noise. A small CNN separates these easily (>98% acc), which is what
    the accuracy-convergence tests need; deterministic in `seed`.

    ``template_seed`` defaults to ``seed``; train/test splits of one dataset
    must share it (same class templates) while drawing different noise."""
    rng = np.random.default_rng(seed)
    trng = np.random.default_rng(seed if template_seed is None else template_seed)
    # Templates are generated at reduced spatial resolution and upsampled
    # (nearest-neighbor): at ImageNet scale (1000 classes x 224x224x3) full-
    # resolution templates plus smoothing temporaries would peak at multiple
    # GB; 32x32 templates cost ~12MB and carry the same class signal.
    h, w = shape[0], shape[1]
    hs, ws = min(h, 32), min(w, 32)
    small = (num_classes, hs, ws) + tuple(shape[2:])
    templates = trng.uniform(0.0, 255.0, size=small).astype(np.float32)
    # Smooth the templates so convolutions have local structure to find, then
    # restore full contrast (smoothing alone collapses everything toward 127,
    # drowning the class signal in the pixel noise).
    for _ in range(2):
        templates = (
            templates
            + np.roll(templates, 1, axis=1)
            + np.roll(templates, -1, axis=1)
            + np.roll(templates, 1, axis=2)
            + np.roll(templates, -1, axis=2)
        ) / 5.0
    flat = templates.reshape(num_classes, -1)
    lo = flat.min(axis=1)[:, None]
    hi = flat.max(axis=1)[:, None]
    templates = ((flat - lo) / np.maximum(hi - lo, 1e-6) * 255.0).reshape(
        templates.shape
    )
    row_idx = (np.arange(h) * hs) // h  # nearest-neighbor upsample indices
    col_idx = (np.arange(w) * ws) // w
    y = rng.integers(0, num_classes, size=n)
    # Materialize samples in chunks, upsampling after the label lookup:
    # whole-set template lookup + noise would hold two full float32 copies
    # of the dataset (and upsampling all class templates first would cost
    # num_classes x full-res).
    x = np.empty((n,) + tuple(shape), np.uint8)
    # Budget ~128MB of float32 temporaries per chunk: each iteration holds
    # ~3 float32 copies of the chunk (upsampled templates, noise draw, sum).
    row_bytes = max(int(np.prod(shape)), 1) * 4 * 3
    chunk = max(1, min(n, (1 << 27) // row_bytes))
    for i in range(0, n, chunk):
        yi = y[i : i + chunk]
        t = templates[yi]
        if (hs, ws) != (h, w):
            t = t[:, row_idx][:, :, col_idx]
        noisy = t + 25.0 * rng.standard_normal(
            (len(yi),) + tuple(shape), dtype=np.float32
        )
        x[i : i + chunk] = np.clip(noisy, 0, 255).astype(np.uint8)
    return x, y.astype(np.int32)


def _synthetic_split(split, shape, num_classes, train_n, test_n, base_seed):
    # Same templates for both splits (template_seed), different noise draws.
    if split == "train":
        return synthetic_images(train_n, shape, num_classes, base_seed, template_seed=base_seed)
    return synthetic_images(test_n, shape, num_classes, base_seed + 1, template_seed=base_seed)


# ----------------------------------------------------------------- loaders --
def _finalize(x: np.ndarray, y: np.ndarray, normalize: bool, channels: int) -> Arrays:
    if x.ndim == 3:  # (N, H, W) -> NHWC, the reference's array_reshape
        x = x[..., None]
    if x.shape[-1] != channels:
        raise ValueError(
            f"Dataset has {x.shape[-1]} channels, expected {channels} "
            "(corrupt or mislabeled cache file?)"
        )
    if normalize:
        x = x.astype(np.float32) / 255.0  # README.md:56, 290
    return x, y.astype(np.int32)


def load_mnist(
    split: str = "train",
    *,
    normalize: bool = True,
    data_dir: Optional[str] = None,
    synthetic_ok: bool = True,
    force_synthetic: bool = False,
    synthetic_train_n: int = 60000,
    synthetic_test_n: int = 10000,
) -> Arrays:
    # force_synthetic exists so a caller that needs BOTH splits from the
    # same source (e.g. the convergence bench) can't end up training on a
    # cached real split and evaluating on a synthetic one when only one
    # split file is present on the machine.
    got = None
    if not force_synthetic:
        dirs = _search_dirs(data_dir)
        got = _try_npz(dirs, ["mnist.npz"], split) or _try_idx(
            dirs, ["mnist", "MNIST/raw", ""], split
        )
        if got is None and not synthetic_ok:
            raise FileNotFoundError(
                "MNIST not found in " + ", ".join(map(str, dirs)) + " and synthetic_ok=False"
            )
    if got is None:
        got = _synthetic_split(split, (28, 28), 10, synthetic_train_n, synthetic_test_n, 1234)
    return _finalize(*got, normalize=normalize, channels=1)


def _try_cifar(dirs, split) -> Optional[Arrays]:
    for d in dirs:
        for sub in ("cifar-10-batches-py", "cifar10/cifar-10-batches-py", ""):
            base = d / sub if sub else d
            names = (
                [f"data_batch_{i}" for i in range(1, 6)]
                if split == "train"
                else ["test_batch"]
            )
            if not all((base / n).exists() for n in names):
                continue
            xs, ys = [], []
            for n in names:
                with open(base / n, "rb") as f:
                    batch = pickle.load(f, encoding="bytes")
                xs.append(
                    batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                )
                ys.append(np.array(batch[b"labels"], np.uint8))
            return np.concatenate(xs), np.concatenate(ys)
    return None


def load_cifar10(
    split: str = "train",
    *,
    normalize: bool = True,
    data_dir: Optional[str] = None,
    synthetic_ok: bool = True,
) -> Arrays:
    dirs = _search_dirs(data_dir)
    got = _try_cifar(dirs, split)
    if got is None:
        if not synthetic_ok:
            raise FileNotFoundError("CIFAR-10 not found")
        got = _synthetic_split(split, (32, 32, 3), 10, 50000, 10000, 91011)
    return _finalize(*got, normalize=normalize, channels=3)


__all__ = ["load_cifar10", "load_mnist", "synthetic_images"]
