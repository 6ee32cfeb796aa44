"""The port's serving fleet against the JAX package's.

The same tiny LM (vocab 32, 2 layers, d 16, 2 heads, max_len 64) in both
packages, its weights carried from JAX by ``interop``. The router and the
autoscaler are driven over the same synthetic traces and must decide the
same; the KV handoff packs the same keys and arrays after the same
prefill (f32, int8 and a scanned model's stacked pool), a payload packed
by either package decodes the same greedy tokens in the other, and a bf16
payload round-trips bit for bit in the port. The fleets run on the same
requests with each package's replica clock patched to a fixed cost per
dispatch (the ``time`` that ``fleet.replica`` and ``fleet.core`` see), so
the schedule itself is comparable: the tokens, the handoff and fallback
counts, ``pool_events``, the per-replica rows and the rest of the
telemetry must be equal. No wall-clock figure is compared.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu import fleet as jfleet
from distributed_tpu import resilience as jres
from distributed_tpu.fleet import core as jcore
from distributed_tpu.fleet import replica as jreplica
from distributed_tpu.serving import Request as JRequest
from distributed_tpu.serving import Sequence as JSequence
from distributed_tpu.serving.kv_cache import PagedKVCache as JKV
from distributed_tpu.utils import event_schema as jevs
from distributed_tpu_torch import fleet as pfleet
from distributed_tpu_torch import resilience as pres
from distributed_tpu_torch.fleet import core as pcore
from distributed_tpu_torch.fleet import replica as preplica
from distributed_tpu_torch.serving import Request as PRequest
from distributed_tpu_torch.serving import Sequence as PSequence
from distributed_tpu_torch.serving.kv_cache import PagedKVCache as PKV
from distributed_tpu_torch.utils import event_schema as pevs
from distributed_tpu_torch.utils.events import read_events
from torch_parity import FixedClock, lm_pair

torch.set_num_threads(1)

VOCAB = 32
LM = dict(num_layers=2, d_model=16, num_heads=2, max_len=64)
FLEET = dict(max_slots=2, block_size=4, max_len=64)


@pytest.fixture
def fixed_clock(monkeypatch):
    for mod in (jreplica, jcore, preplica, pcore):
        monkeypatch.setattr(mod, "time", FixedClock())


@pytest.fixture(scope="module")
def pair():
    return lm_pair(vocab=VOCAB, **LM)


@pytest.fixture(scope="module")
def programs(pair):
    jm, pm = pair
    return jfleet.EnginePrograms(jm), pfleet.EnginePrograms(pm)


def _requests(seed=0, n=6, p_range=(2, 9), m_range=(4, 10)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, (int(t),)).astype(np.int32)
               for t in rng.integers(*p_range, n)]
    return prompts, [int(m) for m in rng.integers(*m_range, n)]


def _reqs(cls, prompts, news):
    return [cls(p, m, seed=i, request_id=i)
            for i, (p, m) in enumerate(zip(prompts, news))]


def _strip_wall(tel):
    return {k: v for k, v in tel.items() if k != "wall_s"}


def _both_fleets(pair, programs, prompts, news, *, jkw=None, pkw=None,
                 run_kw=None, **kw):
    """Run the same requests through both packages' fleets; returns
    (JAX fleet, its outputs, port fleet, its outputs)."""
    jm, pm = pair
    out = []
    for pkg, model, prog, req, extra in (
            (jfleet, jm, programs[0], JRequest, jkw or {}),
            (pfleet, pm, programs[1], PRequest, pkw or {})):
        fl = pkg.ServingFleet(model, programs=prog, **FLEET, **kw, **extra)
        out += [fl, fl.run(_reqs(req, prompts, news), **(run_kw or {}))]
    return out


def _assert_same_run(jf, jo, pf, po):
    for i, (a, b) in enumerate(zip(jo, po)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"request {i}")
    jt, pt = jf.last_run_telemetry, pf.last_run_telemetry
    assert pt["handoffs"] == jt["handoffs"]
    assert pt["decode_pool"]["events"] == jt["decode_pool"]["events"]
    assert pt["decode_pool"]["replicas"] == jt["decode_pool"]["replicas"]
    assert pt["requests"] == jt["requests"]
    assert _strip_wall(pt) == _strip_wall(jt)


# ------------------------------------------------------------------ events --
KINDS = ["FLEET_REPLICA_KILLED", "PREFIX_GOSSIP_ADVERTISE",
         "PREFIX_GOSSIP_ADOPT", "SERVICE_START", "REPLICA_SPAWN",
         "STREAM_OPEN", "QUOTA_REJECT", "TRANSPORT_FALLBACK"]


@pytest.mark.parametrize("kind", KINDS)
def test_fleet_and_service_event_rows_are_jax(kind):
    name = getattr(pevs, kind)
    assert name == getattr(jevs, kind)
    for field in ("required", "optional"):
        assert tuple(pevs.EVENTS[name][field]) == tuple(
            jevs.EVENTS[name][field])


# ------------------------------------------------------------------ router --
def _drive_router(pkg, req):
    """One synthetic trace through a Router: WFQ order over weighted
    tenants, a bounded queue, SLO admission on an observed rate, requeue
    at the head, ``peek`` and ``place``. Returns every decision."""
    log = []
    r = pkg.Router(max_queue=6, slo_ttft_s=1.0,
                   tenant_weights={"a": 2.0, "b": 1.0})
    rid = iter(range(100))
    for i in range(8):
        tenant = "ab"[i % 2] if i < 6 else "c"
        adm, seq = r.submit(req(np.array([1] * (i % 3 + 1), np.int32),
                                4 + i, request_id=next(rid)),
                            tenant=tenant, now=0.1 * i)
        log.append(("submit", adm.accepted, adm.reason,
                    None if seq is None else round(seq.vft, 6)))
    log.append(("peek", r.peek().request.request_id))
    popped = [r.next_request() for _ in range(3)]
    log.append(("pop", [(s.tenant, s.request.request_id) for s in popped]))
    r.requeue(popped[:2], now=1.0)
    log.append(("after_requeue", r.peek().request.request_id, r.requeues))
    for t in (2.0, 12.0, 22.0):
        r.observe_finish(t)
    log.append(("rate", r.service_rate(), r.predicted_ttft()))
    adm, _ = r.submit(req(np.array([1], np.int32), 2, request_id=next(rid)),
                      tenant="b", now=23.0)
    log.append(("slo", adm.accepted, adm.reason))
    order = []
    while r.peek() is not None:
        s = r.next_request()
        order.append((s.tenant, s.request.request_id))
    log.append(("drain", order))

    class Rep:
        def __init__(self, name, queue_depth, in_flight, holds=False,
                     prefix=False):
            self.name = name
            self.queue_depth = queue_depth
            self.in_flight = in_flight
            self.holds_prefix = lambda seq: holds
            self.kv = type("KV", (), {"prefix": {} if prefix else None})()

    _, seq = r.submit(req(np.array([1, 2], np.int32), 4,
                          request_id=next(rid)), now=30.0)
    reps = [Rep("a", 5, 0), Rep("b", 2, 3), Rep("w", 9, 9, holds=True),
            Rep("v", 1, 9, holds=True), Rep("c2", 1, 1), Rep("c1", 1, 1),
            Rep("g", 7, 7, prefix=True)]
    for pick in ([0, 1], [1, 0], [0, 1, 2], [2, 3], [4, 5], [0, 6]):
        for gossip in (False, True):
            cands = [reps[k] for k in pick]
            log.append(("place", pick, gossip,
                        r.place(seq, cands, gossip_adoptable=gossip).name))
    log.append(("empty", r.place(seq, [])))
    log.append(("telemetry", r.telemetry()))
    return log


def test_router_decides_as_jax():
    assert _drive_router(pfleet, PRequest) == _drive_router(jfleet, JRequest)


def test_router_rejects_bad_arguments_as_jax():
    for pkg, req in ((jfleet, JRequest), (pfleet, PRequest)):
        with pytest.raises(ValueError, match="max_queue"):
            pkg.Router(max_queue=0)
        with pytest.raises(ValueError, match="tenant weight"):
            pkg.Router(tenant_weights={"a": 0.0}).submit(
                req(np.array([1], np.int32), 2), tenant="a")


# -------------------------------------------------------------- autoscaler --
def _drive_autoscaler(pkg):
    asc = pkg.QueueAutoscaler(1, 3, queue_high=2.0, queue_low=0.5,
                              slo_ttft_s=0.5, cooldown_s=1.0,
                              spinup_s=0.25)
    rng = np.random.default_rng(5)
    out = []
    for i in range(40):
        out.append(asc.decide(
            0.3 * i, queue_depth=int(rng.integers(0, 10)),
            replicas=asc.target, free_slots=int(rng.integers(0, 9)),
            slots_per_replica=4,
            recent_p99_ttft=(None if i % 3 else float(rng.random()))))
        out.append(asc.probe())
    return out, asc.events, asc.spinup_s


def test_autoscaler_targets_and_probe_as_jax():
    assert _drive_autoscaler(pfleet) == _drive_autoscaler(jfleet)
    # The ElasticPolicy capacity seam takes the port's probe, as JAX's.
    asc = pfleet.QueueAutoscaler(1, 4, queue_high=100.0, queue_low=0.1,
                                 slo_ttft_s=0.5, cooldown_s=0.0)
    asc.decide(0.0, queue_depth=1, replicas=1, recent_p99_ttft=2.0)
    policy = pres.ElasticPolicy(min_workers=1, max_workers=4,
                                probe=asc.probe)
    assert policy.snap(policy.probe(), default_max=4) == 2


@pytest.mark.parametrize("args,kw,match", [
    ((1, 2), dict(queue_high=1.0, queue_low=1.0), "queue_low"),
    ((3, 2), {}, "max_replicas"),
    ((0, 2), {}, "min_replicas"),
])
def test_autoscaler_validation_as_jax(args, kw, match):
    for pkg in (jfleet, pfleet):
        with pytest.raises(ValueError, match=match):
            pkg.QueueAutoscaler(*args, **kw)


# ----------------------------------------------------------------- handoff --
def _prefilled(pkg, model, prog, seq_cls, req_cls, prompt, kv_dtype=None):
    """A prefill replica of ``pkg`` after prefilling ``prompt``: (the
    sequence, the payload). ``kv_dtype="int8"`` swaps in an int8 pool."""
    rep = pkg.PrefillReplica("prefill-0", prog, block_size=4, max_len=64)
    if kv_dtype is not None:
        if pkg is jfleet:
            rep.kv = JKV(model.module, model.params, max_slots=1,
                         block_size=4, max_blocks_per_seq=16, num_blocks=17,
                         dtype=jax.numpy.int8)
        else:
            rep.kv = PKV(model.module, max_slots=1, block_size=4,
                         max_blocks_per_seq=16, num_blocks=17,
                         dtype=torch.int8, device="cpu")
    seq = seq_cls(req_cls(prompt, 6, seed=0, request_id=0))
    _, payload = rep.prefill(seq)
    return seq, payload


def _assert_same_payload(jp, pp):
    assert sorted(pp.blocks) == sorted(jp.blocks)
    assert (pp.cached_len, pp.block_size, pp.dtype, pp.prefix_hashes) == (
        jp.cached_len, jp.block_size, jp.dtype, jp.prefix_hashes)
    for key, want in jp.blocks.items():
        got = pp.blocks[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if key.split("@")[0].endswith("/q"):
            # int8 rows: each side rounds x / scale itself, so an entry
            # at a rounding tie may land one step apart.
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pack_kv_same_keys_and_arrays_as_jax(pair, programs, kv_dtype):
    jm, pm = pair
    prompt = np.random.default_rng(1).integers(0, VOCAB, 11).astype(np.int32)
    jseq, jp = _prefilled(jfleet, jm, programs[0], JSequence, JRequest,
                          prompt, kv_dtype)
    pseq, pp = _prefilled(pfleet, pm, programs[1], PSequence, PRequest,
                          prompt, kv_dtype)
    assert pseq.tokens == jseq.tokens
    _assert_same_payload(jp, pp)
    assert pp.nbytes == jp.nbytes


def test_pack_kv_stacked_pool_as_jax():
    """A scanned LM's pool keeps its blocks on axis 1 under ``stacked``:
    the same keys (logical start on axis 1) and arrays in both."""
    jm, pm = lm_pair(vocab=VOCAB, scan=True, **LM)
    prompt = np.random.default_rng(2).integers(0, VOCAB, 9).astype(np.int32)
    _, jp = _prefilled(jfleet, jm, jfleet.EnginePrograms(jm), JSequence,
                       JRequest, prompt)
    _, pp = _prefilled(pfleet, pm, pfleet.EnginePrograms(pm), PSequence,
                       PRequest, prompt)
    assert all("/stacked/" in k for k in pp.blocks)
    _assert_same_payload(jp, pp)


def _decode_with(pkg, prog, seq_cls, req_cls, prompt, first, payload,
                 n=6):
    """A decode replica of ``pkg`` that installs ``payload`` for a
    sequence whose first token is ``first``, decoded to the end."""
    rep = pkg.DecodeReplica("decode-0", prog, max_slots=2, block_size=4,
                            max_len=64)
    seq = seq_cls(req_cls(prompt, n, seed=0, request_id=0))
    seq.tokens.append(int(first))
    seq.num_generated = 1
    rep.submit(seq, 0.0, payload=payload)
    done = []
    while not done:
        _, done = rep.step(0.0)
    return rep, done[0].output()


def test_payload_crosses_packages_both_ways(pair, programs):
    """A payload packed by either package, installed by the other,
    decodes the greedy tokens of the sender's own decode replica."""
    jm, pm = pair
    prompt = np.random.default_rng(3).integers(0, VOCAB, 10).astype(np.int32)
    jseq, jp = _prefilled(jfleet, jm, programs[0], JSequence, JRequest,
                          prompt)
    pseq, pp = _prefilled(pfleet, pm, programs[1], PSequence, PRequest,
                          prompt)
    first = jseq.tokens[-1]
    _, jj = _decode_with(jfleet, programs[0], JSequence, JRequest, prompt,
                         first, jp)
    _, pp_out = _decode_with(pfleet, programs[1], PSequence, PRequest,
                             prompt, first, pp)
    jrep, jx = _decode_with(jfleet, programs[0], JSequence, JRequest,
                            prompt, first, pp)
    prep, px = _decode_with(pfleet, programs[1], PSequence, PRequest,
                            prompt, first, jp)
    assert jrep.handoffs_installed == prep.handoffs_installed == 1
    assert jrep.handoffs_fallback == prep.handoffs_fallback == 0
    for got in (pp_out, jx, px):
        np.testing.assert_array_equal(got, jj)


def test_bf16_payload_round_trips_bit_for_bit():
    """A bf16 pool's blocks travel as their 16 bits with dtype bfloat16
    named, through the transport's frame encoding too, and install into
    another pool's blocks exactly."""
    from distributed_tpu_torch.fleet.handoff import _gather
    from distributed_tpu_torch.serve_service import transport as tr

    pm = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16", **LM),
                   device="cpu").build((16,))
    assert pm.decode_dtype() == torch.bfloat16
    prog = pfleet.EnginePrograms(pm)
    prompt = np.random.default_rng(4).integers(0, VOCAB, 13).astype(np.int32)
    seq, payload = _prefilled(pfleet, pm, prog, PSequence, PRequest, prompt)
    assert payload.dtype == "bfloat16"
    assert all(a.dtype == np.uint16 for a in payload.blocks.values())
    meta, blobs = tr.encode_payload(tr.handoff_to_payload(payload))
    back = tr.payload_to_handoff(tr.decode_payload(meta, blobs))
    dst = PKV(pm.module, max_slots=2, block_size=4, max_blocks_per_seq=16,
              num_blocks=17, dtype=torch.bfloat16, device="cpu")
    assert dst.reserve(1, 7) and dst.reserve(0, 13)
    assert pfleet.install_kv(dst, 0, back) == 4 * len(back.blocks)
    got, dtype = _gather(dst, dst._slot_blocks[0][:4])
    assert dtype == "bfloat16"
    for key, bits in payload.blocks.items():
        np.testing.assert_array_equal(got[key], bits)
    # And the pool decodes the same tokens as a replica that prefilled.
    _, via = _decode_with(pfleet, prog, PSequence, PRequest, prompt,
                          seq.tokens[-1], back)
    rep = pfleet.DecodeReplica("decode-0", prog, max_slots=2, block_size=4,
                               max_len=64)
    ref = PSequence(PRequest(prompt, 6, seed=0, request_id=0))
    rep.submit(ref, 0.0)
    done = []
    while not done:
        _, done = rep.step(0.0)
    np.testing.assert_array_equal(via, done[0].output())


def _payload_pair(pair, programs, prompt):
    jm, pm = pair
    _, jp = _prefilled(jfleet, jm, programs[0], JSequence, JRequest, prompt)
    _, pp = _prefilled(pfleet, pm, programs[1], PSequence, PRequest, prompt)
    return jp, pp


def test_handoff_incompatible_as_jax(pair, programs):
    """Block size, dtype and layer-structure mismatches raise
    HandoffIncompatible in both packages, before any block is written."""
    jm, pm = pair
    prompt = np.arange(10, dtype=np.int32) % VOCAB
    jp, pp = _payload_pair(pair, programs, prompt)
    jkv = JKV(jm.module, jm.params, max_slots=2, block_size=4,
              max_blocks_per_seq=16, num_blocks=17, dtype=np.float32)
    pkv = PKV(pm.module, max_slots=2, block_size=4, max_blocks_per_seq=16,
              num_blocks=17, dtype=torch.float32, device="cpu")
    for kv in (jkv, pkv):
        assert kv.reserve(0, 10)
    one = lm_pair(vocab=VOCAB, **dict(LM, num_layers=1))
    _, jp1 = _prefilled(jfleet, one[0], jfleet.EnginePrograms(one[0]),
                        JSequence, JRequest, prompt)
    _, pp1 = _prefilled(pfleet, one[1], pfleet.EnginePrograms(one[1]),
                        PSequence, PRequest, prompt)
    for pkg, kv, payload, other in ((jfleet, jkv, jp, jp1),
                                    (pfleet, pkv, pp, pp1)):
        bad = pkg.KVHandoff(**{**vars(payload), "block_size": 8})
        with pytest.raises(pkg.HandoffIncompatible, match="block_size"):
            pkg.install_kv(kv, 0, bad)
        key = sorted(payload.blocks)[0]
        blocks = dict(payload.blocks)
        blocks[key] = blocks[key].astype(np.float64)
        with pytest.raises(pkg.HandoffIncompatible, match="dtype"):
            pkg.install_kv(kv, 0, pkg.KVHandoff(**{**vars(payload),
                                                   "blocks": blocks}))
        with pytest.raises(pkg.HandoffIncompatible, match="layer structure"):
            pkg.install_kv(kv, 0, other)
        with pytest.raises(ValueError, match="reserve"):
            pkg.install_kv(kv, 1, payload)
    assert not pkv.caches["residual"]["main"]["multi_head_attention"][
        "k"].any()


def test_trim_kv_and_stale_trim_as_jax(pair, programs):
    """trim_kv drops the leading blocks a store holds (same keys and
    skip in both); an evicted prefix between trim and admission falls
    back to re-prefill (``handoffs_trim_stale``) in both."""
    from distributed_tpu.fleet.handoff import trim_kv as jtrim
    from distributed_tpu_torch.fleet.handoff import trim_kv as ptrim

    prompt = np.random.default_rng(6).integers(0, VOCAB, 14).astype(np.int32)
    jp, pp = _payload_pair(pair, programs, prompt)
    held = set(pp.prefix_hashes[:2])
    jt, jskip = jtrim(jp, held)
    pt, pskip = ptrim(pp, held)
    assert pskip == jskip == 2
    assert sorted(pt.blocks) == sorted(jt.blocks)
    assert pt.skip_blocks == jt.skip_blocks == 2
    assert ptrim(pp, None) == (pp, 0)
    rows = []
    for pkg, prog, seq_cls, req_cls, payload in (
            (jfleet, programs[0], JSequence, JRequest, jt),
            (pfleet, programs[1], PSequence, PRequest, pt)):
        rep = pkg.DecodeReplica("decode-0", prog, max_slots=2, block_size=4,
                                max_len=64, prefix_cache=True)
        seq = seq_cls(req_cls(prompt, 4, seed=0, request_id=0))
        seq.tokens.append(1)
        seq.num_generated = 1
        rep.submit(seq, 0.0, payload=payload)  # the store is empty: stale
        done = []
        while not done:
            _, done = rep.step(0.0)
        rows.append((rep.handoffs_trim_stale, rep.handoffs_fallback,
                     rep.handoffs_installed, rep.prefills_full,
                     list(done[0].output())))
    assert rows[1] == rows[0] and rows[0][:2] == (1, 1)


# -------------------------------------------------------------------- e2e --
def test_engine_programs_validation_as_jax(pair):
    jm, pm = pair
    for pkg, model in ((jfleet, jm), (pfleet, pm)):
        with pytest.raises(ValueError, match="decode_kernel must be one of"):
            pkg.EnginePrograms(model, decode_kernel="bogus")
    with pytest.raises(RuntimeError, match="not built"):
        pfleet.EnginePrograms(dtt.Model(dtt.models.transformer_lm(
            VOCAB, **LM), device="cpu"))
    for kw, match in ((dict(decode_replicas=0), "decode_replicas"),
                      (dict(prefill_replicas=-1), "prefill_replicas"),
                      (dict(transfer="rdma"), "transfer"),
                      (dict(prefix_gossip=True), "prefix_cache"),
                      (dict(max_len=128), "max_len")):
        for pkg, model in ((jfleet, jm), (pfleet, pm)):
            with pytest.raises(ValueError, match=match):
                pkg.ServingFleet(model, **{**FLEET, **kw})


@pytest.mark.parametrize("case", [
    dict(seed=0, decode_replicas=2, prefill_replicas=1),
    dict(seed=1, decode_replicas=2, prefill_replicas=1, transfer="none"),
    dict(seed=2, decode_replicas=2, prefill_replicas=0, n=4),
], ids=["transfer", "transfer_none", "colocated"])
def test_fleet_matches_jax(pair, programs, fixed_clock, case):
    case = dict(case)
    prompts, news = _requests(seed=case.pop("seed"), n=case.pop("n", 6))
    jf, jo, pf, po = _both_fleets(pair, programs, prompts, news, **case)
    _assert_same_run(jf, jo, pf, po)
    t = pf.last_run_telemetry
    assert t["lost_requests"] == 0
    if case.get("transfer") == "none":
        assert t["handoffs"]["installed"] == 0
        assert t["handoffs"]["fallback_reprefill"] == len(prompts)
    elif case["prefill_replicas"]:
        assert t["handoffs"]["installed"] == len(prompts)
        assert t["handoffs"]["bytes_shipped"] > 0
    # The port's fleet serves what its Engine serves on these weights.
    engine = dtt.serving.Engine(pair[1], max_slots=2, block_size=4,
                                max_len=64)
    for a, b in zip(engine.run(_reqs(PRequest, prompts, news)), po):
        np.testing.assert_array_equal(a, b)


def test_fleet_arrivals_and_tenants_match_jax(pair, programs, fixed_clock):
    prompts, news = _requests(seed=8, n=8)
    run_kw = dict(arrival_times=[0.015 * i for i in range(8)],
                  tenants=["a", "b"] * 4)
    jr = jfleet.Router(max_queue=5, tenant_weights={"a": 2.0})
    pr = pfleet.Router(max_queue=5, tenant_weights={"a": 2.0})
    _assert_same_run(*_both_fleets(pair, programs, prompts, news,
                                   decode_replicas=2, prefill_replicas=1,
                                   run_kw=run_kw, jkw=dict(router=jr),
                                   pkw=dict(router=pr)))


def test_replica_kill_matches_jax(pair, programs, fixed_clock, tmp_path,
                                  monkeypatch):
    """FaultInjector(mode="replica_kill", replica="decode-1") in both:
    the same requeues, the same tokens, the same respawn; the port's
    ``fleet_replica_killed`` record conforms to the schema."""
    monkeypatch.setenv("DTPU_EVENT_LOG", str(tmp_path / "ev.jsonl"))
    prompts, news = _requests(seed=3, n=6, m_range=(6, 12))
    jfault = jres.FaultInjector("replica_kill", replica="decode-1",
                                at_step=2, once_marker=tmp_path / "j")
    pfault = pres.FaultInjector("replica_kill", replica="decode-1",
                                at_step=2, once_marker=tmp_path / "p")
    jf, jo, pf, po = _both_fleets(
        pair, programs, prompts, news, decode_replicas=2,
        prefill_replicas=1, jkw=dict(fault=jfault), pkw=dict(fault=pfault))
    _assert_same_run(jf, jo, pf, po)
    t = pf.last_run_telemetry
    (kill,) = t["decode_pool"]["kills"]
    assert kill["replica"] == "decode-1" and kill["requeued"] >= 1
    assert t["lost_requests"] == 0
    assert any(e["event"] == "spawn" for e in t["decode_pool"]["events"])
    assert pfault.fired and (tmp_path / "p").exists()
    events = read_events(tmp_path / "ev.jsonl")
    killed = [e for e in events if e["event"] == pevs.FLEET_REPLICA_KILLED]
    assert [e["replica"] for e in killed] == ["decode-1", "decode-1"]
    assert all(pevs.check(e) == [] for e in killed)


def test_killed_replica_pool_is_dropped(pair, programs, fixed_clock):
    """A killed replica's pool leaves with it: nothing in the fleet keeps
    the pool tensors alive (on a card, device memory returns)."""
    import gc
    import weakref

    prompts, news = _requests(seed=3, n=6, m_range=(6, 12))
    fault = pres.FaultInjector("replica_kill", replica="decode-1",
                               at_step=2)
    fl = pfleet.ServingFleet(pair[1], programs=programs[1], **FLEET,
                             decode_replicas=2, prefill_replicas=1,
                             fault=fault)
    rep = fl.decode_pool["decode-1"]
    pool = weakref.ref(rep.kv.caches["residual"]["main"][
        "multi_head_attention"]["k"])
    fl.run(_reqs(PRequest, prompts, news))
    gc.collect()
    assert "decode-1" not in fl.decode_pool and rep.kv is None
    assert pool() is None


def test_autoscaled_fleet_matches_jax(pair, programs, fixed_clock):
    prompts, news = _requests(seed=4, n=8, m_range=(6, 12))

    def asc(pkg):
        return pkg.QueueAutoscaler(1, 3, queue_high=1.5, queue_low=0.25,
                                   cooldown_s=0.0, spinup_s=0.005)

    jf, jo, pf, po = _both_fleets(
        pair, programs, prompts, news, decode_replicas=1,
        prefill_replicas=1, jkw=dict(autoscaler=asc(jfleet)),
        pkw=dict(autoscaler=asc(pfleet)))
    _assert_same_run(jf, jo, pf, po)
    t = pf.last_run_telemetry
    assert [e for e in t["autoscaler"]["events"] if e["to"] > e["from"]]
    assert any(e["event"] == "spawn" for e in t["decode_pool"]["events"])


def test_fleet_serves_the_live_model_after_fit(fixed_clock):
    """Both fleets dispatch the model's live weights: a ``fit`` after the
    fleet was built is what the fleet serves next (each equals an Engine
    built after the fit), in both packages."""
    jm, pm = lm_pair(vocab=VOCAB, **LM)
    pm.compile(optimizer=dtt.optim.Adam(1e-3),
               loss="sparse_categorical_crossentropy")
    prompts, news = _requests(seed=9, n=4)
    rng = np.random.default_rng(0)
    xs = rng.integers(0, VOCAB, (32, 16)).astype(np.int32)
    for pkg, eng_pkg, model, req in ((jfleet, dtpu, jm, JRequest),
                                     (pfleet, dtt, pm, PRequest)):
        fl = pkg.ServingFleet(model, decode_replicas=2, prefill_replicas=1,
                              **FLEET)
        before = fl.run(_reqs(req, prompts, news))
        model.fit(xs, np.roll(xs, -1, axis=1), batch_size=32, epochs=20,
                  verbose=0)
        after = fl.run(_reqs(req, prompts, news))
        fresh = eng_pkg.serving.Engine(model, max_slots=2, block_size=4,
                                       max_len=64)
        for a, b in zip(fresh.run(_reqs(req, prompts, news)), after):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert any(not np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(before, after))


def test_fleet_telemetry_lands_in_the_registry(pair, programs, fixed_clock):
    from distributed_tpu_torch.obs import registry

    prompts, news = _requests(seed=0, n=3)
    fl = pfleet.ServingFleet(pair[1], programs=programs[1], **FLEET)
    out = fl.run(_reqs(PRequest, prompts, news))
    reg = registry.default_registry()
    assert reg.get_report("fleet.run") == fl.last_run_telemetry
    assert out.telemetry is fl.last_run_telemetry
    assert reg.gauge_value("fleet/decode_replicas") == 2


# ------------------------------------------------------------------- @slow --
@pytest.mark.slow
@pytest.mark.parametrize("replicas,transfer,at_step", [
    (2, "blocks", 1), (2, "none", 4), (3, "blocks", 4), (3, "none", 1),
])
def test_fleet_kill_matrix_matches_jax(pair, programs, fixed_clock, tmp_path,
                                       replicas, transfer, at_step):
    prompts, news = _requests(seed=10 + replicas, n=8, m_range=(6, 14))
    faults = [pkg.FaultInjector("replica_kill", replica="decode-1",
                                at_step=at_step) for pkg in (jres, pres)]
    jf, jo, pf, po = _both_fleets(
        pair, programs, prompts, news, decode_replicas=replicas,
        prefill_replicas=1, transfer=transfer,
        run_kw=dict(arrival_times=[0.001 * i for i in range(len(news))]),
        jkw=dict(fault=faults[0]), pkw=dict(fault=faults[1]))
    _assert_same_run(jf, jo, pf, po)
    assert pf.last_run_telemetry["lost_requests"] == 0
    assert len(pf.last_run_telemetry["decode_pool"]["kills"]) == 1
