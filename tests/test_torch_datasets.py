"""The port's dataset loaders against the JAX package's.

- The synthetic splits of ``load_fashion_mnist``, ``load_imagenet``,
  ``load_mnist`` and ``load_cifar10`` (reached through ``load``) equal
  JAX's arrays; ``load`` names the known datasets for an unknown one.
- ``load_digits_real`` equals JAX's where scikit-learn is installed and
  raises ``FileNotFoundError`` where it is not (simulated here).
- ``fetch_mnist`` touches no network in these tests: with the
  connection probe refused it returns None and leaves nothing behind; a
  complete cache short-circuits; a mirror serving other bytes than the
  pinned digests is rejected (the probe and the download patched).
"""

import gzip
import io
import socket
import struct
import sys
import urllib.request

import numpy as np
import pytest

from distributed_tpu.data import datasets as jds
from distributed_tpu_torch.data import datasets as pds


@pytest.fixture(autouse=True)
def no_caches(tmp_path, monkeypatch):
    """Both packages search the same places: point them at an empty home
    so every loader takes its synthetic split."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("DTPU_DATA_DIR", raising=False)


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("normalize", [False, True])
def test_fashion_mnist_synthetic_equals_jax(normalize):
    _same(pds.load_fashion_mnist("test", normalize=normalize),
          jds.load_fashion_mnist("test", normalize=normalize))


@pytest.mark.parametrize("split", ["train", "test"])
def test_imagenet_synthetic_equals_jax(split):
    kw = dict(image_size=40, num_classes=7, synthetic_train_n=24,
              synthetic_test_n=9, normalize=False)
    _same(pds.load_imagenet(split, **kw), jds.load_imagenet(split, **kw))


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(synthetic_test_n=50)), ("cifar10", {}),
    ("imagenet", dict(image_size=16, num_classes=3, synthetic_test_n=5))])
def test_load_dispatch_equals_jax(name, kw):
    _same(pds.load(name, "test", **kw), jds.load(name, "test", **kw))


def test_load_unknown_and_missing_match_jax():
    for fn, args in ((lambda m: m.load("svhn"), ()),
                     (lambda m: m.load_imagenet(synthetic_ok=False), ()),
                     (lambda m: m.load_fashion_mnist(synthetic_ok=False),
                      ())):
        errs = []
        for mod in (jds, pds):
            with pytest.raises((ValueError, FileNotFoundError)) as e:
                fn(mod, *args)
            errs.append((e.type, str(e.value)))
        assert errs[0] == errs[1]


def test_digits_real_equals_jax_or_raises_without_sklearn(monkeypatch):
    try:
        import sklearn.datasets  # noqa: F401
    except ImportError:
        pass
    else:
        _same(pds.load_digits_real("test", image_size=16),
              jds.load_digits_real("test", image_size=16))
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(FileNotFoundError, match="scikit-learn"):
        pds.load_digits_real()


@pytest.fixture
def no_network(monkeypatch):
    """Every connection refused before it is made."""

    def refuse(*a, **k):
        raise OSError("network disabled in this test")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_fetch_mnist_returns_none_without_network(tmp_path, no_network):
    out = pds.fetch_mnist(dest_dir=tmp_path / "cache", timeout=0.5)
    assert out is None
    assert list((tmp_path / "cache").glob("*")) == []


def _idx_gz(shape):
    arr = np.zeros(shape, np.uint8)
    header = struct.pack(f">I{arr.ndim}I", (0x08 << 8) | arr.ndim, *shape)
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as f:
        f.write(header + arr.tobytes())
    return buf.getvalue()


def test_fetch_mnist_short_circuits_on_complete_cache(tmp_path, no_network):
    d = tmp_path / "mnist"
    d.mkdir()
    for fname in pds._MNIST_FILES:
        (d / fname).write_bytes(_idx_gz(pds._MNIST_SHAPES[fname]))
    assert pds.fetch_mnist(dest_dir=d) == d
    assert pds._MNIST_MIRRORS == jds._MNIST_MIRRORS
    assert pds._MNIST_MD5 == jds._MNIST_MD5


def test_fetch_mnist_rejects_checksum_mismatch(tmp_path, monkeypatch):
    class _Conn:
        def close(self):
            pass

    class _Resp:
        def __init__(self, body):
            self.body = body

        def read(self, n=-1):
            return self.body if n < 0 else self.body[:n]

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(socket, "create_connection", lambda *a, **k: _Conn())
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=None:
                        _Resp(_idx_gz(pds._MNIST_SHAPES[
                            url.rsplit("/", 1)[1]])))
    monkeypatch.delenv("DTPU_MNIST_NO_CHECKSUM", raising=False)
    assert pds.fetch_mnist(dest_dir=tmp_path / "cache", timeout=0.5) is None
    assert list((tmp_path / "cache").glob("*.gz")) == []
