"""File shards, the native C++ ring and the Pipeline's paths against JAX's.

- ``write_shards``: both packages write the same files; shard sets
  written by either read in the other (``FileSource``: rows, labels,
  numeric shard order; Fortran-order and non-uint8 shards rejected with
  JAX's messages).
- The port's streams, on the ring (``use_native=True``, built here with
  ``g++``) and on the Python path, equal the JAX package's Python stream
  bit for bit (which the JAX package holds equal to its own ring) for an
  in-memory array, a ``FileSource`` and a shard directory path: across
  passes, under ``shard``, ``seek``, ``reshard`` and
  ``state_dict``/``load_state``; the ring's stream does not depend on its
  thread count, and reads memmaps that stay alive with the pipeline.
- ``DTPU_NATIVE_LEGACY_SHUFFLE=1``: the ring's own splitmix64
  Fisher-Yates order, held to a numpy transcription of it.
- ``use_native=True`` raises when the library cannot be built (a failing
  compiler), ``use_native=None`` then takes the Python path and
  ``is_native`` says so; ``DTPU_NO_NATIVE=1`` keeps the ring unloaded.
- Concurrent first builds (three processes at once, one fresh build
  directory) all load the one library the lock let through.
"""

import gc
import subprocess
import sys

import numpy as np
import pytest
import torch

import distributed_tpu.data as jdata
import distributed_tpu_torch as dtt
from distributed_tpu_torch.data import pipeline as ppipe

torch.set_num_threads(1)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
ROW = (6, 5, 3)


def _data(n=90, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n,) + ROW, dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.fixture
def shard_dirs(tmp_path):
    x, y = _data()
    jdata.write_shards(tmp_path / "jax", x, y, rows_per_shard=16)
    dtt.data.write_shards(tmp_path / "port", x, y, rows_per_shard=16)
    return tmp_path, x, y


def test_write_shards_same_files_and_cross_read(shard_dirs):
    tmp, x, y = shard_dirs
    names = sorted(p.name for p in (tmp / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp / "port").iterdir())
    for name in names:
        assert (tmp / "jax" / name).read_bytes() == (
            tmp / "port" / name).read_bytes()
    for src in (dtt.data.FileSource(tmp / "jax"),
                jdata.FileSource(tmp / "port")):
        assert src.n == 90 and src.row_shape == ROW
        assert src.span_rows == [16] * 5 + [10]
        idx = np.random.default_rng(1).permutation(90)[:40]
        np.testing.assert_array_equal(src.gather(idx), x[idx])
        np.testing.assert_array_equal(src.y, y)
        assert isinstance(src.x_shards[0], np.memmap)


def test_shards_sort_numerically(tmp_path):
    d = tmp_path / "s"
    d.mkdir()
    for i in (2, 10, 1):
        np.save(d / f"shard-{i}-x.npy", np.full((2, 3), i, np.uint8))
    for mod in (jdata, dtt.data):
        src = mod.FileSource(d)
        np.testing.assert_array_equal(src.gather(np.arange(6))[:, 0],
                                      [1, 1, 2, 2, 10, 10])


@pytest.mark.parametrize("case", ["fortran", "dtype", "rows", "labels",
                                  "empty_dir", "exists"])
def test_file_source_errors_match_jax(tmp_path, case):
    msgs = []
    for name, mod in (("j", jdata), ("p", dtt.data)):
        d = tmp_path / name
        d.mkdir()
        if case == "fortran":
            np.save(d / "shard-00000-x.npy",
                    np.asfortranarray(np.zeros((4, 3), np.uint8)))
        elif case == "dtype":
            np.save(d / "shard-00000-x.npy", np.zeros((4, 3), np.float32))
        elif case == "rows":
            np.save(d / "shard-00000-x.npy", np.zeros((4, 3), np.uint8))
            np.save(d / "shard-00001-x.npy", np.zeros((4, 2), np.uint8))
        elif case == "labels":
            np.save(d / "shard-00000-x.npy", np.zeros((4, 3), np.uint8))
            np.save(d / "shard-00000-y.npy", np.zeros(4, np.float32))
        elif case == "exists":
            mod.write_shards(d, np.zeros((4, 3), np.uint8))
        with pytest.raises(Exception) as e:
            if case == "exists":
                mod.write_shards(d, np.zeros((4, 3), np.uint8))
            else:
                mod.FileSource(d)
        msgs.append((e.type.__name__, str(e.value).replace(str(d), "D")))
    assert msgs[0] == msgs[1]


def _same(got, want):
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


def _take(p, n):
    return [next(p) for _ in range(n)]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("source", ["array", "file", "path"])
def test_stream_equals_jax(shard_dirs, native, source):
    tmp, x, y = shard_dirs
    arg = {"array": x, "file": dtt.data.FileSource(tmp / "jax"),
           "path": str(tmp / "port")}[source]
    jp = jdata.Pipeline(x, y, 16, seed=4, use_native=False)
    pp = dtt.data.Pipeline(arg, None if source != "array" else y, 16, seed=4,
                           use_native=native, prefetch=3)
    assert pp.is_native is native
    _same(_take(pp, 13), _take(jp, 13))  # 5 steps a pass: crosses passes
    jp.seek(23)
    pp.seek(23)
    _same(_take(pp, 4), _take(jp, 4))
    state = pp.state_dict()
    assert state == jp.state_dict()
    pp.close()
    jp.close()


@pytest.mark.parametrize("native", [True, False])
def test_shards_reshard_and_state(shard_dirs, native):
    tmp, x, y = shard_dirs
    jp = [jdata.Pipeline(x, y, 16, seed=2, use_native=False, shard=(i, 4))
          for i in range(4)]
    pp = [dtt.data.Pipeline(tmp / "port", None, 16, seed=2,
                            use_native=native, shard=(i, 4))
          for i in range(4)]
    for _ in range(6):
        for j, p in zip(jp, pp):
            _same([next(p)], [next(j)])
    for j, p in zip(jp, pp):
        j.reshard((0, 2) if j is jp[0] else (1, 2))
        p.reshard((0, 2) if p is pp[0] else (1, 2))
        _same(_take(p, 3), _take(j, 3))
    again = dtt.data.Pipeline(tmp / "port", None, 16, seed=2,
                              use_native=native, shard=(1, 2))
    again.load_state(pp[1].state_dict())
    _same(_take(again, 2), _take(jp[1], 2))
    with pytest.raises(ValueError, match="not divisible"):
        pp[0].reshard((0, 3))
    for p in pp + [again]:
        p.close()


def test_ring_independent_of_threads_and_keeps_memmaps_alive(shard_dirs):
    tmp, x, y = shard_dirs
    want = _take(jdata.Pipeline(x, y, 8, seed=9, use_native=False), 40)
    for threads in (1, 2, 4):
        p = dtt.data.Pipeline(dtt.data.FileSource(tmp / "port"), None, 8,
                              seed=9, use_native=True, num_threads=threads,
                              prefetch=6)
        gc.collect()  # the source object lives only inside the pipeline
        _same(_take(p, 40), want)
        out = p.next_k(3)
        assert out[0].shape == (3, 8) + ROW
        p.close()


def _splitmix_order(n, seed, pass_idx):
    """The ring's legacy permutation: splitmix64-seeded Fisher-Yates with
    rejection-sampled draws (native/pipeline.cc), in Python ints."""
    m = (1 << 64) - 1
    s = (seed * 0x9E3779B97F4A7C15 + pass_idx + 1) & m

    def nxt():
        nonlocal s
        s = (s + 0x9E3779B97F4A7C15) & m
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return z ^ (z >> 31)

    order = list(range(n))
    for i in range(n - 1, 0, -1):
        bound = i + 1
        threshold = ((1 << 64) - bound) % bound
        while True:
            r = nxt()
            if r >= threshold:
                break
        j = r % bound
        order[i], order[j] = order[j], order[i]
    return np.asarray(order)


def test_legacy_shuffle_is_the_rings_own_order(monkeypatch):
    x, y = _data(40)
    monkeypatch.setenv("DTPU_NATIVE_LEGACY_SHUFFLE", "1")
    p = dtt.data.Pipeline(x, y, 8, seed=3, use_native=True)
    assert p.is_native and not p._external_perms
    for pass_idx in range(2):
        order = _splitmix_order(40, 3, pass_idx)
        for step in range(5):
            xb, yb = next(p)
            rows = order[step * 8:(step + 1) * 8]
            np.testing.assert_array_equal(yb, y[rows])
            np.testing.assert_array_equal(
                xb, x[rows].astype(np.float32) * np.float32(1 / 255))
    p.close()


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(ppipe, "_lib", None)
    monkeypatch.setattr(ppipe, "_lib_tried", False)
    monkeypatch.setattr(ppipe, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")


def test_use_native_true_raises_when_the_build_fails(broken_compiler):
    x, y = _data(32)
    with pytest.raises(RuntimeError, match="Native pipeline requested but "
                                           "unavailable: false failed"):
        dtt.data.Pipeline(x, y, 8, use_native=True)
    p = dtt.data.Pipeline(x, y, 8, use_native=None)
    assert not p.is_native
    assert not dtt.data.native_available()


def test_no_native_env_keeps_the_ring_unloaded(monkeypatch):
    monkeypatch.setattr(ppipe, "_lib", None)
    monkeypatch.setattr(ppipe, "_lib_tried", False)
    monkeypatch.setenv("DTPU_NO_NATIVE", "1")
    x, y = _data(32)
    assert not dtt.data.Pipeline(x, y, 8).is_native
    with pytest.raises(RuntimeError, match="DTPU_NO_NATIVE=1"):
        dtt.data.Pipeline(x, y, 8, use_native=True)


BUILD = '''
import sys
from pathlib import Path
from distributed_tpu_torch.data import pipeline
pipeline.BUILD_DIR = Path(sys.argv[1])
print(pipeline._build_native())
'''


def test_concurrent_first_builds_share_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILD,
                               str(tmp_path / "b")], cwd=str(ROOT),
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    assert sorted(f.name for f in (tmp_path / "b").iterdir()) == [
        ".native.lock", outs[0].rsplit("/", 1)[1]]
