"""Record shards and the record decode pool of the port against JAX's.

- ``write_records``: both packages write the same bytes (shard and
  sidecar index); shards written by either read in the other.
- Corruption (a flipped payload bit, a truncated shard, a bad magic, a
  missing index) raises the JAX package's error type with its message,
  which names the shard file and the record.
- ``Pipeline(RecordSource(...))``: the port's stream at
  ``decode_workers`` 0, 1 and 3 equals JAX's (decode_workers 0) bit for
  bit, labelled and unlabelled, across passes, under ``shard``, ``seek``
  and ``state_dict``/``load_state``; a decode error reaches the consumer
  with its own type; a pool closed mid-pass joins within its timeout.
"""

import time

import numpy as np
import pytest
import torch

from distributed_tpu.data import Pipeline as JaxPipeline
from distributed_tpu.data import records as jrec
from distributed_tpu_torch.data import Pipeline
from distributed_tpu_torch.data import records as prec

torch.set_num_threads(1)

ROW_SHAPE = (4, 3)


def _records(n=100, seed=0, labels=True):
    """Variable-length records: [label byte][12 row bytes][random pad]."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (n,) + ROW_SHAPE, dtype=np.uint8)
    recs = []
    for i in range(n):
        pad = bytes(rng.integers(0, 256, int(rng.integers(0, 40))).tolist())
        label = bytes([i % 256]) if labels else b"\xff"
        recs.append(label + rows[i].tobytes() + pad)
    return rows, recs


def _decode(b):
    row = np.frombuffer(b[1:13], np.uint8).reshape(ROW_SHAPE)
    return row.astype(np.float32), b[0]


def _decode_unlabeled(b):
    return np.frombuffer(b[1:13], np.uint8).reshape(ROW_SHAPE)


@pytest.fixture
def shards(tmp_path):
    _, recs = _records()
    jrec.write_records(tmp_path / "jax", recs, records_per_shard=17)
    prec.write_records(tmp_path / "port", recs, records_per_shard=17)
    return tmp_path, recs


def test_both_packages_write_the_same_files(shards):
    tmp, _ = shards
    names = sorted(p.name for p in (tmp / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp / "port").iterdir())
    assert len(names) == 2 * 6  # 100 records, 17 a shard
    for name in names:
        assert (tmp / "jax" / name).read_bytes() == (
            tmp / "port" / name).read_bytes(), name


@pytest.mark.parametrize("writer,reader", [("jax", prec), ("port", jrec)])
def test_files_read_in_the_other_package(shards, writer, reader):
    tmp, recs = shards
    with reader.RecordSource(tmp / writer, decode_fn=_decode) as src:
        assert len(src) == len(recs)
        assert [src.read(i) for i in range(len(recs))] == recs
        assert src.probe() == (ROW_SHAPE, True)


def _corrupt(d, case):
    if case == "crc":
        path = d / "records-00002.drs"
        data = bytearray(path.read_bytes())
        data[-1] ^= 0xFF
        path.write_bytes(bytes(data))
    elif case == "truncated":
        path = d / "records-00003.drs"
        path.write_bytes(path.read_bytes()[:-5])
    elif case == "magic":
        path = d / "records-00001.drs"
        path.write_bytes(b"XXXX" + path.read_bytes()[4:])
    elif case == "index":
        (d / "records-00004-idx.npy").unlink()


@pytest.mark.parametrize("case", ["crc", "truncated", "magic", "index"])
def test_corruption_raises_as_jax(shards, case):
    tmp, recs = shards
    errors = {}
    for name, mod in (("jax", jrec), ("port", prec)):
        _corrupt(tmp / name, case)
        try:
            with mod.RecordSource(tmp / name) as src:
                for i in range(len(recs)):
                    src.read(i)
        except Exception as e:  # the type and message are compared below
            errors[name] = (type(e).__name__, str(e))
    assert errors["port"] == errors["jax"]
    assert "records-0000" in errors["port"][1]
    if case in ("crc", "truncated"):
        assert errors["port"][0] == "RecordCorruptionError"
        assert "record" in errors["port"][1]


def test_write_errors_match_jax(tmp_path):
    for mod in (jrec, prec):
        with pytest.raises(ValueError, match="record 1 is empty"):
            mod.write_records(tmp_path / mod.__name__, [b"a", b""])
    for mod in (jrec, prec):
        d = tmp_path / f"full-{mod.__name__}"
        mod.write_records(d, [b"a"])
        with pytest.raises(FileExistsError, match="already contains"):
            mod.write_records(d, [b"b"])


def _stream(p, steps):
    return [next(p) for _ in range(steps)]


def _same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("labels", [True, False])
def test_record_stream_equals_jax(shards, workers, labels):
    tmp, _ = shards
    if not labels:
        _, recs = _records(labels=False)
        jrec.write_records(tmp / "unlabeled", recs, records_per_shard=17)
    d = tmp / ("jax" if labels else "unlabeled")
    fn = _decode if labels else _decode_unlabeled
    kw = dict(seed=3, scale=0.5 if labels else None)
    with JaxPipeline(jrec.RecordSource(d, decode_fn=fn), None, 10,
                     **kw) as jp, \
            Pipeline(prec.RecordSource(d, decode_fn=fn), None, 10,
                     decode_workers=workers, **kw) as pp:
        assert not pp.is_native and pp.decode_workers == workers
        _same(_stream(pp, 25), _stream(jp, 25))  # crosses passes


@pytest.mark.parametrize("workers", [0, 3])
def test_record_stream_shard_seek_state(shards, workers):
    tmp, _ = shards
    d = tmp / "port"

    def make(mod, pipe, **kw):
        return pipe(mod.RecordSource(d, decode_fn=_decode), None, 20,
                    seed=5, **kw)

    for index in (0, 1):
        with make(jrec, JaxPipeline, shard=(index, 2)) as jp, \
                make(prec, Pipeline, shard=(index, 2),
                     decode_workers=workers) as pp:
            assert pp.batch_shape == jp.batch_shape == (10,) + ROW_SHAPE
            _same(_stream(pp, 7), _stream(jp, 7))
            jp.seek(11)
            pp.seek(11)
            _same(_stream(pp, 4), _stream(jp, 4))
            state = pp.state_dict()
            assert state == jp.state_dict()
            pp.reshard(None)
            jp.reshard(None)
            _same(_stream(pp, 3), _stream(jp, 3))
    with make(prec, Pipeline, decode_workers=workers) as pp, \
            make(jrec, JaxPipeline) as jp:
        pp.load_state(state)
        jp.load_state(state)
        _same(_stream(pp, 4), _stream(jp, 4))
        with pytest.raises(ValueError, match="iterator state mismatch"):
            pp.load_state(dict(state, seed=6))


def test_decode_error_reaches_the_consumer(shards):
    tmp, _ = shards
    _corrupt(tmp / "port", "crc")
    with Pipeline(prec.RecordSource(tmp / "port", decode_fn=_decode), None,
                  100, shuffle=False, decode_workers=2) as p:
        with pytest.raises(prec.RecordCorruptionError,
                           match=r"records-00002\.drs"):
            next(p)


def test_pool_closed_mid_pass_joins(shards):
    """A pool whose workers are busy in a slow decode when the pipeline
    closes: every worker thread ends within the close's join timeout."""
    tmp, _ = shards

    def slow(b):
        time.sleep(0.02)
        return _decode(b)

    p = Pipeline(prec.RecordSource(tmp / "port", decode_fn=slow), None, 10,
                 decode_workers=3, decode_readahead=6)
    next(p)
    threads = list(p._decode_pool._threads)
    t = time.perf_counter()
    p.close()
    assert time.perf_counter() - t < 10.0
    assert not any(th.is_alive() for th in threads)
    with pytest.raises(ValueError, match="closed"):
        next(p)


@pytest.mark.parametrize("case", ["native", "workers", "no_decode", "y"])
def test_record_pipeline_argument_errors_match_jax(shards, case):
    tmp, _ = shards
    msgs = []
    for mod, pipe in ((jrec, JaxPipeline), (prec, Pipeline)):
        src = mod.RecordSource(tmp / "port",
                               decode_fn=None if case == "no_decode"
                               else _decode)
        args, kw = (src, None, 10), {}
        if case == "native":
            kw["use_native"] = True
        elif case == "y":
            args = (src, np.zeros(100, np.int32), 10)
        elif case == "workers":
            args, kw = (np.zeros((32, 4, 3), np.uint8), None, 8), dict(
                decode_workers=2)
        with pytest.raises(ValueError) as e:
            pipe(*args, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_half_built_pipeline_tears_down(shards):
    """``__init__`` raising after the teardown fields are set: close()
    and ``__del__`` work on the half-built instance."""
    p = Pipeline.__new__(Pipeline)
    with pytest.raises(ValueError):
        p.__init__(np.zeros((4, 2), np.uint8), None, batch_size=9)
    p.close()
    p.__del__()
    assert p._handle is None and p._decode_pool is None
