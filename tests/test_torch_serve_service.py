"""The port's serving service against the JAX package's.

The pieces that need no model are held to the JAX package's byte for
byte: protocol frames (and their torn-frame and bad-magic errors),
``encode_payload`` of an f32 and an int8 payload, ``ShmTransport``
directories (each package's ``get`` reads the other's ``put``) and the
token-bucket quotas over one trace. Then the port's ``ServeService``
spawns REAL worker processes (``python -m
distributed_tpu_torch.serve_service.worker``, ``device="cpu"``) and its
streamed tokens must equal the port's ``Engine`` on the same spec. The
multi-process matrix (prefill over shm, a killed worker, a pool
mismatch, quotas with the live autoscaler) is marked slow, as JAX marks
it.
"""

import io
import os
import socket

import numpy as np
import pytest
import torch

import distributed_tpu_torch as dtt
from distributed_tpu.serve_service import protocol as jproto
from distributed_tpu.serve_service import quotas as jquotas
from distributed_tpu.serve_service import transport as jtr
from distributed_tpu_torch import fleet as pfleet
from distributed_tpu_torch.serve_service import (
    MAGIC, ServeService, ServeSpec, TenantQuotas, TokenBucket,
    TransportError, ShmTransport, decode_payload, encode_payload,
    handoff_to_payload, payload_to_handoff, recv_exact, recv_frame,
    send_frame,
)
from distributed_tpu_torch.serving import Request
from distributed_tpu_torch.serving.kv_cache import PagedKVCache
from distributed_tpu_torch.utils import event_schema as evs
from distributed_tpu_torch.utils.events import read_events

torch.set_num_threads(1)


class _Sink:
    def __init__(self):
        self.buf = io.BytesIO()

    def sendall(self, data):
        self.buf.write(data)


def _wire(send, header, blobs=()):
    sink = _Sink()
    send(sink, header, blobs)
    return sink.buf.getvalue()


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _recv_after(wire, recv, cut=None):
    """``recv`` over a socket that carried ``wire[:cut]`` then closed:
    its result, or the error it raised as (type name, message)."""
    a, b = _pair()
    a.sendall(wire if cut is None else wire[:cut])
    a.close()
    try:
        return recv(b)
    except ConnectionError as e:
        return type(e).__name__, str(e)
    finally:
        b.close()


# --------------------------------------------------------------- protocol --
FRAMES = [({"type": "submit", "request_id": 3, "prompt": [1, 2]},
           (b"\x00" * 17, b"payload-two", b"")),
          ({"type": "hello", "name": "decode-0", "pid": 7}, ()),
          ({"type": "token", "tokens": [], "x": None, "y": 1.5}, (b"kv",))]


@pytest.mark.parametrize("header,blobs", FRAMES)
def test_frames_byte_equal_to_jax(header, blobs):
    wire = _wire(send_frame, header, blobs)
    assert wire == _wire(jproto.send_frame, header, blobs)
    assert wire.startswith(MAGIC) and MAGIC == jproto.MAGIC
    want = (header, list(blobs))
    assert _recv_after(wire, recv_frame) == want
    assert _recv_after(wire, jproto.recv_frame) == want


@pytest.mark.parametrize("cut", [2, 4, 6, 10, -10])
def test_torn_frames_raise_as_jax(cut):
    """A peer dying inside the magic, after it, inside the header length,
    inside the header, and inside a blob: ProtocolError with JAX's text."""
    wire = _wire(send_frame, {"type": "submit", "request_id": 1},
                 (b"x" * 64,))
    got = _recv_after(wire, recv_frame, cut)
    assert got[0] == "ProtocolError"
    assert got == _recv_after(wire, jproto.recv_frame, cut)


@pytest.mark.parametrize("wire,match", [
    (b"HTTP" + b"\x00" * 16, "magic"),
    (MAGIC + b"\xff\xff\xff\xff", "header length"),
    (MAGIC + b"\x00\x00\x00\x02{]", "unparseable"),
    (MAGIC + b"\x00\x00\x00\x02[]", "must be an object"),
    (b"", None),
])
def test_bad_frames_raise_as_jax(wire, match):
    got = _recv_after(wire, recv_frame)
    assert got == _recv_after(wire, jproto.recv_frame)
    if match is None:
        assert got is None  # clean EOF between frames
    else:
        assert got[0] == "ProtocolError" and match in got[1]


def test_recv_exact_short_read_as_jax():
    got = _recv_after(b"abc", lambda s: recv_exact(s, 5))
    assert got == _recv_after(b"abc", lambda s: jproto.recv_exact(s, 5))
    assert "3 of 5" in got[1]


# -------------------------------------------------------------- transport --
def _payload(int8, seed=0):
    rng = np.random.default_rng(seed)
    blocks = {}
    for i in range(2):
        path = f"residual_{i}/main/multi_head_attention"
        for name in ("k", "v"):
            if int8:
                blocks[f"{path}/{name}/q@0,0,0,0@3,4,2,8"] = rng.integers(
                    -127, 128, (3, 4, 2, 8)).astype(np.int8)
                blocks[f"{path}/{name}/scale@0,0,0,0@3,4,2,1"] = rng.random(
                    (3, 4, 2, 1)).astype(np.float32)
            else:
                blocks[f"{path}/{name}@0,0,0,0@3,4,2,8"] = (
                    rng.standard_normal((3, 4, 2, 8)).astype(np.float32))
    return {"blocks": blocks, "cached_len": 9, "block_size": 4,
            "dtype": "float32", "prefix_hashes": ["ab", "cd"],
            "skip_blocks": 1, "weights_version": None}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_encode_payload_bytes_equal_to_jax(int8):
    p = _payload(int8)
    meta, blobs = encode_payload(p)
    assert (meta, blobs) == jtr.encode_payload(p)
    for dec in (decode_payload, jtr.decode_payload):
        out = dec(meta, blobs)
        assert {k: out[k] for k in out if k != "blocks"} == {
            k: p[k] for k in p if k != "blocks"}
        for key, arr in p["blocks"].items():
            assert out["blocks"][key].dtype == arr.dtype
            np.testing.assert_array_equal(out["blocks"][key], arr)


def test_decode_payload_errors_as_jax():
    meta, blobs = encode_payload(_payload(False))
    for dec, err in ((decode_payload, TransportError),
                     (jtr.decode_payload, jtr.TransportError)):
        with pytest.raises(err, match="names 4 blocks"):
            dec(meta, blobs[:-1])
        with pytest.raises(err, match="corrupt .npy block"):
            dec(meta, [b"not-an-npy"] + list(blobs[1:]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shm_payload_crosses_packages(tmp_path, writer):
    """A payload directory written by either package's ShmTransport is
    read by the other's, manifest and blocks; an uncommitted one (no
    manifest) is a TransportError in both."""
    put_cls, get_cls = ((ShmTransport, jtr.ShmTransport) if writer == "port"
                        else (jtr.ShmTransport, ShmTransport))
    p = _payload(True, seed=1)
    store = put_cls(tmp_path / "kv", owner=True)
    ref = store.put(p)
    out = get_cls(tmp_path / "kv", owner=False).get(ref)
    assert {k: out[k] for k in out if k != "blocks"} == {
        k: p[k] for k in p if k != "blocks"}
    for key, arr in p["blocks"].items():
        np.testing.assert_array_equal(np.asarray(out["blocks"][key]), arr)
    os.unlink(os.path.join(ref["path"], "manifest.json"))
    for cls, err in ((ShmTransport, TransportError),
                     (jtr.ShmTransport, jtr.TransportError)):
        with pytest.raises(err, match="missing or uncommitted"):
            cls(tmp_path / "kv", owner=False).get(ref)
    store.delete(ref)
    store.close()
    assert not (tmp_path / "kv").exists()


def test_payload_handoff_roundtrip():
    """KVHandoff -> dict payload -> frame encoding -> KVHandoff keeps
    every block byte and the trim metadata (the port's pool)."""
    pm = dtt.Model(dtt.models.transformer_lm(
        32, num_layers=1, d_model=16, num_heads=2, max_len=64),
        device="cpu").build((64,))
    kv = PagedKVCache(pm.module, max_slots=2, block_size=4,
                      max_blocks_per_seq=8, num_blocks=9,
                      dtype=torch.float32, device="cpu")
    assert kv.reserve(0, 10)
    gen = torch.Generator().manual_seed(0)
    for leaf in kv.caches["residual"]["main"]["multi_head_attention"].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    h = pfleet.pack_kv(kv, 0, 10, tokens=np.arange(10) % 32)
    meta, blobs = encode_payload(handoff_to_payload(h))
    back = payload_to_handoff(decode_payload(meta, blobs))
    assert (back.cached_len, back.block_size, back.dtype,
            back.prefix_hashes) == (h.cached_len, h.block_size, h.dtype,
                                    h.prefix_hashes)
    assert set(back.blocks) == set(h.blocks)
    for key in h.blocks:
        np.testing.assert_array_equal(back.blocks[key], h.blocks[key])


# ----------------------------------------------------------------- quotas --
def _drive_quotas(mod):
    b = mod.TokenBucket(rate=10.0, burst=20.0)
    out = [b.try_take(20.0, now=0.0), b.try_take(1.0, now=0.0),
           b.retry_after(1.0), b.try_take(1.0, now=0.2),
           b.retry_after(10_000.0), b.level]
    q = mod.TenantQuotas({"flood": (2.0, 12.0), "tier": (5.0, 6.0)})
    rng = np.random.default_rng(4)
    for i in range(40):
        tenant = ("flood", "tier", "anyone")[i % 3]
        out.append(q.admit(tenant, float(rng.integers(1, 9)), now=0.1 * i))
    out.append(q.telemetry())
    out.append(q.rejected)
    return out


def test_quotas_decide_as_jax():
    assert _drive_quotas(dtt.serve_service) == _drive_quotas(jquotas)
    with pytest.raises(ValueError, match="rate and burst"):
        TokenBucket(0.0, 1.0)


# ---------------------------------------------------------------- service --
_MODEL = dict(vocab_size=32, num_layers=1, d_model=16, num_heads=2,
              max_len=64)


def _spec(**kw):
    kw.setdefault("model", dict(_MODEL))
    kw.setdefault("build_len", 64)
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("device", "cpu")
    return ServeSpec(**kw)


def _engine_outputs(spec, prompts, news):
    """The port's Engine on the model a worker builds from ``spec``."""
    m = dtt.Model(dtt.models.transformer_lm(**spec.model),
                  device=spec.device)
    m.compile(optimizer=spec.optimizer, loss=spec.loss)
    m.build((spec.build_len,), seed=0)
    engine = dtt.serving.Engine(m, max_slots=spec.max_slots,
                                block_size=spec.block_size,
                                max_len=spec.max_len)
    return engine.run([Request(p, n, seed=0) for p, n in zip(prompts, news)])


def _requests(n, seed=3, m=6):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 32, (int(t),)).astype(np.int32)
               for t in rng.integers(2, 7, n)]
    return prompts, [m] * n


def test_spec_carries_the_device_to_workers():
    import json

    blob = json.loads(_spec().worker_blob("decode-0", "decode",
                                          transport="shm", shm_root="/x"))
    assert blob["device"] == "cpu" and blob["model"] == _MODEL
    assert json.loads(ServeSpec(model={}, build_len=8).worker_blob(
        "d", "decode", transport="none", shm_root=None))["device"] is None
    with pytest.raises(ValueError, match="transport"):
        ServeService(_spec(), transport="carrier-pigeon")


def test_service_streams_the_engine_tokens(tmp_path, monkeypatch):
    """One real decode worker process on the CPU, inline transport: every
    stream yields exactly the port Engine's generated tokens on the same
    spec, and the run's telemetry is on wall time."""
    monkeypatch.setenv("DTPU_EVENT_LOG", str(tmp_path / "events.jsonl"))
    prompts, news = _requests(3)
    spec = _spec()
    svc = ServeService(spec, decode_replicas=1, transport="inline",
                       log_dir=tmp_path)
    with svc:
        streams = []
        for p, m in zip(prompts, news):
            adm, stream = svc.submit(Request(p, m, seed=0))
            assert adm.accepted
            streams.append(stream)
        got = [list(iter(s)) for s in streams]
        outs = [s.result() for s in streams]
        res = svc.run([Request(p, m, seed=0) for p, m in zip(prompts, news)])
        spinup = [h.spinup_s for h in svc._handles.values()]
    for want, o, toks, r, p in zip(_engine_outputs(spec, prompts, news),
                                   outs, got, res, prompts):
        np.testing.assert_array_equal(want, o)
        np.testing.assert_array_equal(want, r)
        assert toks == [int(t) for t in o[len(p):]]
    tel = res.telemetry
    assert tel["clock"] == "wall" and tel["lost_requests"] == 0
    assert tel["tokens_per_sec"] > 0 and tel["time_to_first_token"]["p50_s"]
    assert spinup and all(s > 0 for s in spinup)
    evts = read_events(tmp_path / "events.jsonl")
    assert {"service_start", "replica_spawn", "stream_open"} <= {
        e["event"] for e in evts}
    assert all(evs.check(e) == [] for e in evts)


@pytest.mark.slow
def test_service_prefill_handoff_over_shm(tmp_path):
    """A prefill worker and a decode worker: KV rides /dev/shm as .npy
    blocks and installs without a re-prefill, token-exact."""
    prompts, news = _requests(3, seed=5)
    spec = _spec()
    svc = ServeService(spec, decode_replicas=1, prefill_replicas=1,
                       transport="shm", log_dir=tmp_path)
    with svc:
        res = svc.run([Request(p, m, seed=0)
                       for p, m in zip(prompts, news)], deadline_s=180)
        stats = svc.collect_stats()
    for want, o in zip(_engine_outputs(spec, prompts, news), res):
        np.testing.assert_array_equal(want, o)
    decode = [s for s in stats.values() if s.get("role") == "decode"]
    assert sum(s["handoffs_installed"] for s in decode) == 3
    assert sum(s["handoffs_fallback"] for s in decode) == 0
    prefill = [s for s in stats.values() if s.get("role") == "prefill"]
    assert sum(s["prefills"] for s in prefill) == 3
    assert res.telemetry["lost_requests"] == 0


@pytest.mark.slow
def test_service_kill_replica_recovers_token_exact(tmp_path, monkeypatch):
    """Kill a decode worker mid-decode: nothing lost, token-exact, and
    the dead worker's flight dump is readable through the port's CLI."""
    from distributed_tpu_torch.obs.cli import summarize

    monkeypatch.setenv("DTPU_EVENT_LOG", str(tmp_path / "events.jsonl"))
    prompts, news = _requests(6, seed=7, m=8)
    spec = _spec()
    svc = ServeService(spec, decode_replicas=2, transport="none",
                       respawn=False, log_dir=tmp_path)
    with svc:
        streams = [svc.submit(Request(p, m, seed=0))[1]
                   for p, m in zip(prompts, news)]
        while svc.streamed_tokens < 6:
            svc._pump(0.02)
        svc.kill_replica("decode-1")
        outs = [s.result() for s in streams]
        kills = svc.kills
    for want, o in zip(_engine_outputs(spec, prompts, news), outs):
        np.testing.assert_array_equal(want, o)
    assert kills == 1
    evts = read_events(tmp_path / "events.jsonl")
    dead = [e for e in evts if e["event"] == "fleet_replica_killed"]
    assert dead and dead[0]["replica"] == "decode-1"
    flight = summarize(evts)["flight_dumps"]
    assert flight and flight[0]["readable"]
    assert flight[0]["reason"] == "replica_kill"


@pytest.mark.slow
def test_service_pool_mismatch_falls_back_to_reprefill(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("DTPU_EVENT_LOG", str(tmp_path / "events.jsonl"))
    prompts, news = _requests(2, seed=9)
    spec = _spec()
    svc = ServeService(spec, decode_replicas=1, prefill_replicas=1,
                       transport="shm", log_dir=tmp_path,
                       engine_overrides={"decode": {"block_size": 8}})
    with svc:
        res = svc.run([Request(p, m, seed=0)
                       for p, m in zip(prompts, news)], deadline_s=180)
        stats = svc.collect_stats()
    for want, o in zip(_engine_outputs(spec, prompts, news), res):
        np.testing.assert_array_equal(want, o)
    decode = [s for s in stats.values() if s.get("role") == "decode"][0]
    assert decode["handoffs_installed"] == 0
    assert decode["handoffs_fallback"] == 2
    falls = [e for e in read_events(tmp_path / "events.jsonl")
             if e["event"] == "transport_fallback"]
    assert len(falls) == 2 and all("block_size" in f["reason"]
                                   for f in falls)


@pytest.mark.slow
def test_service_quotas_and_autoscaler_live(tmp_path):
    prompts, news = _requests(10, seed=11, m=8)
    svc = ServeService(
        _spec(max_slots=1), decode_replicas=1, transport="none",
        quotas=TenantQuotas({"flood": (1.0, 12.0)}),
        autoscaler=pfleet.QueueAutoscaler(min_replicas=1, max_replicas=2,
                                          queue_high=1.5, queue_low=0.25,
                                          cooldown_s=0.5),
        log_dir=tmp_path,
    )
    with svc:
        res = svc.run([Request(p, m, seed=0) for p, m in zip(prompts, news)],
                      tenants=["flood"] * 8 + ["paying", "paying"],
                      deadline_s=180)
    tel = res.telemetry
    assert tel["quotas"]["rejected"] > 0
    assert tel["lost_requests"] == 0
    assert res[8] is not None and res[9] is not None
    assert tel["decode_pool"]["spawns"] >= 2
    assert any(e["to"] > e["from"] for e in tel["decode_pool"]["events"])
