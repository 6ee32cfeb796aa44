"""The port's prefix gossip against the JAX package's.

A tiny LM trained in JAX (untrained d_model=16 logits are near-tied, and
their argmax would turn placement differences into token noise), its
weights carried into the port by ``interop``. The index protocol decides
the same over the same calls; ``pack_prefix``/``adopt_prefix`` move a
warm engine's prefix into a cold one across the packages, token-exact,
and refuse a stale ``weights_version`` stamp in both; the gossiping fleets
(each package's replica clock patched to a fixed cost per dispatch) adopt,
advertise and place alike and serve the same tokens; ``update_weights``
flushes every store, withdraws every advertisement and serves the moved
weights as a fresh Engine does. No wall-clock figure is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu import fleet as jfleet
from distributed_tpu.fleet import core as jcore
from distributed_tpu.fleet import replica as jreplica
from distributed_tpu.fleet.gossip import PrefixGossipIndex as JIndex
from distributed_tpu.serving import Request as JRequest
from distributed_tpu.serving.kv_cache import _chain_hashes
from distributed_tpu_torch import fleet as pfleet
from distributed_tpu_torch.fleet import core as pcore
from distributed_tpu_torch.fleet import replica as preplica
from distributed_tpu_torch.fleet.gossip import PrefixGossipIndex as PIndex
from distributed_tpu_torch.serve_service import transport as tr
from distributed_tpu_torch.serving import Request as PRequest
from distributed_tpu_torch.utils import event_schema as evs
from distributed_tpu_torch.utils.events import read_events
from torch_parity import FixedClock, lm_pair

torch.set_num_threads(1)

VOCAB = 32
LM = dict(num_layers=2, d_model=16, num_heads=2, max_len=64)
ENGINE = dict(max_slots=4, block_size=16, max_len=64, prefix_cache=True)


@pytest.fixture
def fixed_clock(monkeypatch):
    for mod in (jreplica, jcore, preplica, pcore):
        monkeypatch.setattr(mod, "time", FixedClock())


@pytest.fixture(scope="module")
def pair():
    jm, pm = lm_pair(vocab=VOCAB, **LM)
    xs = np.random.default_rng(0).integers(0, VOCAB, (32, 16)).astype(
        np.int32)
    jm.fit(xs, np.roll(xs, -1, axis=1), batch_size=32, epochs=25, verbose=0)
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    return jm, pm


def _shared(rng, n=3, new=16, seed0=0, shared=None):
    """``n`` requests over one shared 2-block prefix + distinct tails,
    as ``(prompt, new, seed, request_id)`` rows for either package."""
    if shared is None:
        shared = rng.integers(0, VOCAB, 32).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, VOCAB, 3 + i).astype(
        np.int32)]), new, seed0 + i, seed0 + i) for i in range(n)]


def _as(cls, rows):
    return [cls(p, n, seed=s, request_id=r) for p, n, s, r in rows]


# ------------------------------------------------------------------ index --
def _drive_index(cls):
    g = cls()
    out = [g.advertise("r0", ["a", "b", "c"], weights_version=0),
           g.advertise("r1", ["a", "b"], weights_version=0),
           g.best_peer(["a", "b", "c", "d"], weights_version=0),
           g.best_peer(["x", "a"], weights_version=0),
           g.best_peer(["a", "b"], weights_version=0),
           g.best_peer(["a", "b"], weights_version=0, exclude=("r0",)),
           g.advertise("r0", ["a", "b"], weights_version=0),
           g.best_peer(["a", "b", "c"], weights_version=0),
           g.advertise("r0", ["a", "b"], weights_version=1),
           g.best_peer(["a", "b"], weights_version=1),
           g.best_peer(["a", "b"], weights_version=2),
           g.best_peer(["a", "b"]),
           g.holders("a", weights_version=1), g.holders("a"),
           g.withdraw("r0"), g.withdraw("r0"), g.telemetry()]
    return out


def test_gossip_index_protocol_as_jax():
    got = _drive_index(PIndex)
    assert got == _drive_index(JIndex)
    assert got[2] == ("r0", 3) and got[3] == (None, 0)


# ----------------------------------------------------------- pack / adopt --
def test_pack_adopt_cross_packages_token_exact_and_stamp(pair):
    """A warm engine's prefix blocks, packed by either package, adopted
    into the OTHER package's cold engine, make it admit with a cached
    prefix and decode the warm engine's tokens; a weights-version
    mismatch is refused in both, and nothing leaks past the stamp."""
    jm, pm = pair
    rows = _shared(np.random.default_rng(1))
    keys = _chain_hashes(list(rows[0][0][:32]), 16)
    jwarm = dtpu.serving.Engine(jm, **ENGINE)
    pwarm = dtt.serving.Engine(pm, **ENGINE)
    want = [np.asarray(o) for o in jwarm.run(_as(JRequest, rows))]
    got = pwarm.run(_as(PRequest, rows))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    jpay = jfleet.pack_prefix(jwarm.kv, keys, weights_version=0)
    ppay = pfleet.pack_prefix(pwarm.kv, keys, weights_version=0)
    assert sorted(ppay.blocks) == sorted(jpay.blocks)
    assert (ppay.cached_len, ppay.prefix_hashes, ppay.weights_version) == (
        jpay.cached_len, jpay.prefix_hashes, jpay.weights_version) == (
        32, tuple(keys), 0)
    for key, a in jpay.blocks.items():
        np.testing.assert_allclose(ppay.blocks[key], a, rtol=1e-5,
                                   atol=1e-5)
    assert pfleet.pack_prefix(pwarm.kv, ["nope"]) is None
    for cold_fleet, cold_pkg, model, req, pay in (
            (pfleet, dtt, pm, PRequest, jpay),
            (jfleet, dtpu, jm, JRequest, ppay)):
        cold = cold_pkg.serving.Engine(model, **ENGINE)
        with pytest.raises(cold_fleet.HandoffIncompatible,
                           match="stale gossip"):
            cold_fleet.adopt_prefix(cold.kv, pay, weights_version=1)
        assert len(cold.kv.prefix) == 0
        assert cold_fleet.adopt_prefix(cold.kv, pay, weights_version=0) == 2
        outs = cold.run(_as(req, rows))
        for a, b in zip(want, outs):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert cold.kv.prefix.hits > 0
        assert cold_fleet.adopt_prefix(cold.kv, pay, weights_version=0) == 0


def test_adopt_prefix_refusals_as_jax(pair):
    """No prefix store, or another block size: HandoffIncompatible in
    both; an empty payload adopts nothing."""
    for fl, pkg, model in ((jfleet, dtpu, pair[0]), (pfleet, dtt, pair[1])):
        plain = pkg.serving.Engine(model, max_slots=2, block_size=16,
                                   max_len=64)
        pay = fl.KVHandoff(blocks={}, cached_len=16, block_size=16,
                           dtype="float32", prefix_hashes=("k",))
        with pytest.raises(fl.HandoffIncompatible, match="prefix store"):
            fl.adopt_prefix(plain.kv, pay)
        cold = pkg.serving.Engine(model, **ENGINE)
        with pytest.raises(fl.HandoffIncompatible, match="block_size"):
            fl.adopt_prefix(cold.kv, fl.KVHandoff(
                blocks={}, cached_len=8, block_size=8, dtype="float32"))
        assert fl.adopt_prefix(cold.kv, pay) == 0  # nothing travels


def test_transport_carries_weights_version(pair, tmp_path):
    """The stamp rides both encodings; a manifest written without it
    decodes to None."""
    import json
    from pathlib import Path

    _, pm = pair
    warm = dtt.serving.Engine(pm, **ENGINE)
    rows = _shared(np.random.default_rng(2), n=2)
    warm.run(_as(PRequest, rows))
    keys = _chain_hashes(list(rows[0][0][:32]), 16)
    d = tr.handoff_to_payload(pfleet.pack_prefix(warm.kv, keys,
                                                 weights_version=3))
    meta, blobs = tr.encode_payload(d)
    assert tr.payload_to_handoff(
        tr.decode_payload(meta, blobs)).weights_version == 3
    shm = tr.ShmTransport(tmp_path / "shm")
    ref = shm.put(d)
    assert tr.payload_to_handoff(shm.get(ref)).weights_version == 3
    mpath = Path(ref["path"]) / tr.MANIFEST
    m = json.loads(mpath.read_text())
    del m["weights_version"]
    mpath.write_text(json.dumps(m))
    assert shm.get(ref)["weights_version"] is None
    shm.close()


# ------------------------------------------------------------------ fleet --
def _warm_then_wave(pkg, model, req, rng_seed, gossip):
    """One request warms decode-0; a 3-request shared-prefix wave then
    arrives at the same instant."""
    rng = np.random.default_rng(rng_seed)
    fl = pkg.ServingFleet(model, decode_replicas=2, prefill_replicas=0,
                          max_slots=2, block_size=16, max_len=64,
                          prefix_cache=True, prefix_gossip=gossip)
    shared = rng.integers(0, VOCAB, 32).astype(np.int32)
    warm = _shared(rng, n=1, seed0=100, shared=shared)
    wave = _shared(rng, n=3, shared=shared)
    fl.run(_as(req, warm))
    return fl, fl.run(_as(req, wave))


def test_gossiping_fleet_matches_jax(pair, fixed_clock, tmp_path,
                                     monkeypatch):
    """The gossiping fleets adopt the warm replica's prefix onto the cold
    one (no full re-prefill in the wave), with the same adoptions,
    advertisements, placements and telemetry, and serve the tokens of the
    gossip-off fleet; the adopt and advertise events conform to the
    schema."""
    monkeypatch.setenv("DTPU_EVENT_LOG", str(tmp_path / "ev.jsonl"))
    jm, pm = pair
    jf, jo = _warm_then_wave(jfleet, jm, JRequest, 7, gossip=True)
    pf, po = _warm_then_wave(pfleet, pm, PRequest, 7, gossip=True)
    _, off = _warm_then_wave(pfleet, pm, PRequest, 7, gossip=False)
    for a, b, c in zip(jo, po, off):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, c)
    jt, pt = jf.last_run_telemetry, pf.last_run_telemetry
    assert {k: v for k, v in pt.items() if k != "wall_s"} == {
        k: v for k, v in jt.items() if k != "wall_s"}
    assert pt["gossip"]["adoptions"] >= 1
    assert pt["gossip"]["adopted_blocks"] >= 2
    assert pt["gossip"]["stale_rejected"] == 0
    rows = pt["decode_pool"]["replicas"]
    assert sum(r["prefills_full"] for r in rows.values()) == 1
    assert sum(r["gossip_serves"] for r in rows.values()) >= 1
    events = read_events(tmp_path / "ev.jsonl")
    adopts = [e for e in events if e["event"] == evs.PREFIX_GOSSIP_ADOPT]
    assert adopts and adopts[0]["transport"] == "inproc"
    assert any(e["event"] == evs.PREFIX_GOSSIP_ADVERTISE for e in events)
    for e in events:
        assert evs.check(e) == [], e


def _moved(jm, by=0.05):
    new = jax.tree_util.tree_map(lambda a: a + by * jnp.ones_like(a),
                                 jm.params)
    return new, dtt.interop.params_from_jax(jax.device_get(new))


def test_update_weights_invalidates_gossip_as_jax(pair, fixed_clock):
    """A swap flushes every prefix store, withdraws every advertisement
    and bumps the version in both; a mismatched tree fails loud with the
    version unmoved; the fleets then serve the moved weights alike, as a
    fresh Engine on them does."""
    jm, pm = pair
    old_j = jm.params
    old_p = {k: v.clone() for k, v in pm.params.items()}
    new_j, new_p = _moved(jm)
    rows = _shared(np.random.default_rng(10), n=2, seed0=50)
    outs = []
    try:
        for pkg, model, req, new in ((jfleet, jm, JRequest, new_j),
                                     (pfleet, pm, PRequest, new_p)):
            fl, _ = _warm_then_wave(pkg, model, req, 9, gossip=True)
            assert fl.gossip.telemetry()["keys_live"] > 0
            assert fl.update_weights(new) == 1
            assert fl.weights_version == 1
            assert fl.gossip.telemetry()["keys_live"] == 0
            for rep in fl.decode_pool.values():
                assert len(rep.kv.prefix) == 0
            outs.append(fl.run(_as(req, rows)))
            tel = fl.last_run_telemetry
            assert tel["gossip"]["weights_version"] == 1
            assert tel["gossip"]["stale_rejected"] == 0
            assert fl.gossip.telemetry()["keys_live"] > 0
        bad = {k: torch.zeros(2, 2) for k in new_p}
        with pytest.raises(ValueError, match="fleet.update_weights"):
            fl.update_weights(bad)
        assert fl.weights_version == 1
        fresh = dtt.serving.Engine(pm, max_slots=2, block_size=16,
                                   max_len=64).run(_as(PRequest, rows))
    finally:
        jm.params = old_j
        pm.load_params(old_p)
    for a, b, c in zip(outs[0], outs[1], fresh):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, c)
