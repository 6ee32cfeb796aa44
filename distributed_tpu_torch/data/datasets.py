"""Dataset loaders: MNIST / Fashion-MNIST / CIFAR-10 / ImageNet / digits.

The port's copy of the JAX package's ``data/datasets.py`` (which imports
no JAX): the same arrays for the same arguments. The reference's
reshape-to-NHWC and /255 preprocessing sit behind ``normalize=True``.
``fetch_mnist`` is the one function that may use the network: it probes
the public mirrors with hard timeouts and returns None on any failure.

Resolution order per dataset:
1. explicit ``data_dir`` / ``$DTPU_DATA_DIR``
2. conventional caches (``~/.keras/datasets``, ``~/.cache/distributed_tpu``)
   in either npz (keras layout) or raw IDX / CIFAR-pickle form
3. deterministic synthetic data (unless ``synthetic_ok=False``) — class-
   conditional templates + noise, so models genuinely learn on it; built for
   hermetic CI/bench environments with no network egress.
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
        x = x.astype(np.float32) / 255.0  # the reference's /255
    return x, y.astype(np.int32)


_MNIST_MIRRORS = (
    # Public mirrors of the canonical IDX files, most reliable first.
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
)
_MNIST_FILES = (
    "train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte.gz",
)
_MNIST_SHAPES = {
    "train-images-idx3-ubyte.gz": (60000, 28, 28),
    "train-labels-idx1-ubyte.gz": (60000,),
    "t10k-images-idx3-ubyte.gz": (10000, 28, 28),
    "t10k-labels-idx1-ubyte.gz": (10000,),
}
# Canonical MD5 digests of the four gzipped IDX files (the widely-published
# values, e.g. torchvision.datasets.MNIST pins these same constants). A
# mirror that serves different bytes — truncated, altered, or substituted —
# is rejected before anything reaches the cache. ``DTPU_MNIST_NO_CHECKSUM=1``
# disables the pin (escape hatch in case a future canonical re-encoding
# changes the compressed bytes while the payload stays valid).
_MNIST_MD5 = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}
# Hard cap on bytes read per file: the largest real file (train images) is
# ~9.9MB compressed; a hostile or broken mirror can't exhaust host memory.
_MNIST_MAX_BYTES = 12 * 1024 * 1024


def fetch_mnist(dest_dir: Optional[str] = None,
                timeout: float = 20.0) -> Optional[Path]:
    """Network-guarded fetch of the real MNIST IDX files into the cache.

    Tries each public mirror with a hard per-request timeout, validates
    every file's IDX magic and shape before committing it (tmp-then-rename,
    so a partial download never poisons the cache), and returns the cache
    directory — or None on ANY failure (no network egress, bad mirror,
    corrupt payload). Never raises: hermetic environments fall through to
    the synthetic stand-in, which callers report via their ``data`` field
    (the convergence benchmark). Already-complete caches return immediately.
    """
    import socket
    import urllib.parse
    import urllib.request

    dest = (Path(dest_dir) if dest_dir
            else Path.home() / ".cache" / "distributed_tpu" / "mnist")
    if all((dest / f).exists() for f in _MNIST_FILES):
        return dest
    try:
        dest.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    # Cheap egress probe first: a firewall that silently DROPs packets would
    # otherwise stall every urlopen for the full timeout (2 mirrors x 4
    # files). The probes run in DAEMON threads with a hard join deadline:
    # socket timeouts do NOT bound the DNS lookup inside create_connection
    # (a blackholed resolver can block getaddrinfo for the system resolver
    # timeout), and daemon threads — unlike ThreadPoolExecutor workers —
    # are not joined at interpreter exit, so a stuck probe can't stall
    # process shutdown either.
    import threading

    results = {}

    def _probe(mirror):
        host = urllib.parse.urlparse(mirror).hostname
        port = 443 if mirror.startswith("https") else 80
        try:
            socket.create_connection((host, port), timeout=3.0).close()
            results[mirror] = True
        except OSError:
            results[mirror] = False

    threads = [
        # Named like every thread of the port: a probe stuck in the system
        # resolver is abandoned alive past the join deadline below, and a
        # test that leaves one behind has reached for the network, which
        # the tests' leak check then reports.
        threading.Thread(target=_probe, args=(m,), daemon=True,
                         name=f"dtpu-mirror-probe-{i}")
        for i, m in enumerate(_MNIST_MIRRORS)
    ]
    deadline = 4.0
    import time as _time

    t0 = _time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(0.0, deadline - (_time.monotonic() - t0)))
    # Mirror-preference order preserved: _MNIST_MIRRORS is most reliable
    # first, and the download loop tries `reachable` in order.
    reachable = [m for m in _MNIST_MIRRORS if results.get(m)]
    if not reachable:
        return None
    for fname in _MNIST_FILES:
        path = dest / fname
        if path.exists():
            continue
        check = os.environ.get("DTPU_MNIST_NO_CHECKSUM", "0") in ("", "0")
        payload = None
        for mirror in reachable:
            try:
                with urllib.request.urlopen(
                    mirror + fname, timeout=timeout
                ) as r:
                    # Bounded read: request one byte past the cap so an
                    # oversized body is detectable without buffering it.
                    payload = r.read(_MNIST_MAX_BYTES + 1)
                if len(payload) > _MNIST_MAX_BYTES:
                    payload = None
                    continue
                if check:
                    import hashlib

                    # A corrupt/tampered mirror is a per-mirror failure —
                    # fall through to the next one, like the size cap.
                    if hashlib.md5(payload).hexdigest() != _MNIST_MD5[fname]:
                        payload = None
                        continue
                break
            except Exception:
                continue
        if payload is None:
            return None
        # Per-process-unique temp name (concurrent fetches must not share a
        # partial file) with the .gz suffix kept so _read_idx's gzip
        # detection applies during validation.
        tmp = path.with_name(f"part-{os.getpid()}-{fname}")
        try:
            tmp.write_bytes(payload)
            arr = _read_idx(tmp)  # validates gzip + IDX magic + dtype
            if arr.shape != _MNIST_SHAPES[fname]:
                raise ValueError(f"{fname}: unexpected shape {arr.shape}")
            os.replace(tmp, path)
        except Exception:
            tmp.unlink(missing_ok=True)
            return None
    return dest


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


def load_digits_real(
    split: str = "train",
    *,
    normalize: bool = True,
    image_size: int = 28,
    test_fraction: float = 0.2,
    seed: int = 0,
) -> Arrays:
    """Real handwritten digits from scikit-learn's bundled UCI ML set.

    1,797 genuine 8x8 grayscale scans (sklearn ships them offline — no
    network needed), bilinearly upsampled to ``image_size`` and rescaled to
    0-255 so the reference's MNIST CNN input contract
    (reshape to NHWC, /255) applies unchanged. Split is a
    deterministic stratified holdout (same ``seed`` => same partition on
    every machine), so train/test never leak into each other.

    This is the real-data fallback for the convergence benchmark on
    machines where the MNIST IDX files are absent and there is no network
    egress: small, but every pixel was drawn by a human hand.
    """
    try:
        from sklearn.datasets import load_digits as _sk_load_digits
    except ImportError as e:  # pragma: no cover - sklearn is baked in here
        raise FileNotFoundError(
            "scikit-learn (which bundles the real digits set) is not "
            "installed"
        ) from e
    bunch = _sk_load_digits()
    imgs = bunch.images.astype(np.float32) * (255.0 / 16.0)
    labels = bunch.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    train_idx, test_idx = [], []
    for c in range(10):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        k = int(round(len(idx) * test_fraction))
        test_idx.append(idx[:k])
        train_idx.append(idx[k:])
    pick = np.concatenate(train_idx if split == "train" else test_idx)
    rng.shuffle(pick)
    imgs, labels = imgs[pick], labels[pick]
    if image_size != imgs.shape[1]:
        try:
            from scipy.ndimage import zoom
            scale = image_size / imgs.shape[1]
            imgs = zoom(imgs, (1, scale, scale), order=1)
        except ImportError:  # nearest-neighbor fallback, no scipy
            src = (np.arange(image_size) * imgs.shape[1]) // image_size
            imgs = imgs[:, src][:, :, src]
    x = np.clip(imgs, 0, 255).astype(np.uint8)
    return _finalize(x, labels, normalize=normalize, channels=1)


def load_fashion_mnist(split: str = "train", **kw) -> Arrays:
    dirs = _search_dirs(kw.pop("data_dir", None))
    got = _try_npz(dirs, ["fashion-mnist.npz", "fashion_mnist.npz"], split) or _try_idx(
        dirs, ["fashion-mnist", "fashion_mnist", "FashionMNIST/raw"], split
    )
    if got is None:
        if not kw.pop("synthetic_ok", True):
            raise FileNotFoundError("Fashion-MNIST not found")
        got = _synthetic_split(split, (28, 28), 10, 60000, 10000, 5678)
    return _finalize(*got, normalize=kw.pop("normalize", True), channels=1)


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


def load_imagenet(
    split: str = "train",
    *,
    normalize: bool = True,
    data_dir: Optional[str] = None,
    synthetic_ok: bool = True,
    image_size: int = 224,
    num_classes: int = 1000,
    synthetic_train_n: int = 1024,
    synthetic_test_n: int = 256,
) -> Arrays:
    """ImageNet-scale loader (the ResNet-50 ImageNet data-parallel
    configuration). Resolution order: npz cache (``imagenet.npz`` with
    x_train/y_train/x_test/y_test) else deterministic synthetic images at
    ``image_size``. Synthetic defaults are intentionally small — this backs
    input-pipeline/bench tests, not a real ImageNet epoch."""
    dirs = _search_dirs(data_dir)
    got = _try_npz(dirs, ["imagenet.npz", f"imagenet{image_size}.npz"], split)
    if got is None:
        if not synthetic_ok:
            raise FileNotFoundError(
                "ImageNet not found in " + ", ".join(map(str, dirs))
            )
        got = _synthetic_split(
            split, (image_size, image_size, 3), num_classes,
            synthetic_train_n, synthetic_test_n, 314159,
        )
    return _finalize(*got, normalize=normalize, channels=3)


_LOADERS = {
    "mnist": load_mnist,
    "fashion_mnist": load_fashion_mnist,
    "cifar10": load_cifar10,
    "imagenet": load_imagenet,
}


def load(name: str, split: str = "train", **kw) -> Arrays:
    try:
        loader = _LOADERS[name]
    except KeyError:
        raise ValueError(
            f"Unknown dataset {name!r}; known: {sorted(_LOADERS)}"
        ) from None
    # Loader call outside the try: its own KeyErrors (e.g. a malformed npz
    # cache missing x_test) must surface as themselves, not "unknown dataset".
    return loader(split, **kw)


__all__ = [
    "fetch_mnist", "load", "load_cifar10", "load_digits_real",
    "load_fashion_mnist", "load_imagenet", "load_mnist", "synthetic_images",
]
