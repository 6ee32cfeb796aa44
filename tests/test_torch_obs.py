"""The port's engine telemetry, registry, spans, events and step timer
against the JAX package's.

- ``last_run_telemetry`` has exactly the JAX engine's key tree, at every
  depth, for a plain, a speculative and an adaptive run on the same
  requests; it is the registry's stored ``engine.run`` report.
- The registry's counters, gauges, histograms and rings, the spans and
  ``StepTimer.stall_report`` behave as the JAX package's on the same
  calls.
- Every event the engine emits passes the port's schema check, and the
  port's schema rows equal the JAX package's for those events (one event
  file reads the same with either package's tools).
"""

import numpy as np
import pytest
import torch

from distributed_tpu.obs.registry import MetricsRegistry as JaxRegistry
from distributed_tpu.serving import Request as JaxRequest
from distributed_tpu.utils import event_schema as jax_evs
from distributed_tpu.utils.profiler import StepTimer as JaxStepTimer
from distributed_tpu_torch import obs
from distributed_tpu_torch.obs.registry import MetricsRegistry
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.utils import event_schema as evs
from distributed_tpu_torch.utils.events import EventLog, read_events
from distributed_tpu_torch.utils.profiler import StepTimer
from torch_parity import jax_engine, lm_pair

torch.set_num_threads(1)

VOCAB = 64
ENGINE = dict(max_slots=2, block_size=4, max_len=64)


@pytest.fixture(scope="module")
def pair():
    return lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                   max_len=64)


def key_tree(x):
    """The nested key structure of a report: dicts by key, lists by
    element, leaves as their kind (number, string, None, ...)."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [key_tree(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return "bool"
    if isinstance(x, (int, float, np.integer, np.floating)):
        return "number"
    return type(x).__name__


RUNS = {
    # name: engine kwargs (the draft is the target itself), run kwargs
    "plain": ({}, {}),
    "spec": (dict(spec_k=3, prefix_cache=True), {"return_logprobs": True}),
    "adaptive": (dict(spec_k="adaptive"), {"tenants": ["a", "b", "a"]}),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_report_has_the_jax_engines_key_tree(pair, run):
    eng_kw, run_kw = RUNS[run]
    rng = np.random.default_rng(3)
    shared = rng.integers(0, VOCAB, (8,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, (int(t),))
                               .astype(np.int32)])
               for t in rng.integers(1, 6, 3)]
    news = [int(m) for m in rng.integers(4, 9, 3)]
    reports = []
    for engine_cls, req_cls, model in ((jax_engine, JaxRequest, pair[0]),
                                       (Engine, Request, pair[1])):
        draft = {"draft_model": model} if eng_kw else {}
        eng = engine_cls(model, **ENGINE, **draft, **eng_kw)
        eng.run([req_cls(p, m) for p, m in zip(prompts, news)], **run_kw)
        reports.append(eng.last_run_telemetry)
    want, got = reports
    assert key_tree(got) == key_tree(want)
    assert got is obs.default_registry().get_report("engine.run")
    for key in ("generated_tokens", "decode_steps", "prefill_dispatches",
                "preemptions", "weights_version", "weight_swaps",
                "free_blocks_min", "kv_utilization", "queue_depth"):
        assert got[key] == want[key], key
    if "speculative" in want:
        assert got["speculative"] == want["speculative"]


def test_engine_publishes_gauges_counters_ring_and_spans(pair):
    reg = obs.default_registry()
    reg.reset()
    eng = Engine(pair[1], draft_model=pair[1], spec_k=3, **ENGINE)
    news = [5, 7]
    eng.run([Request(np.arange(1, 4, dtype=np.int32), n) for n in news])
    tel = eng.last_run_telemetry
    snap = reg.snapshot()
    assert snap["counters"]["engine/generated_tokens"] == sum(news)
    assert snap["counters"]["engine/requests"] == 2
    assert snap["gauges"]["engine/tokens_per_sec"] == pytest.approx(
        tel["tokens_per_sec"])
    assert snap["gauges"]["engine/spec_accept_rate"] == pytest.approx(
        tel["speculative"]["accept_rate"])
    ring = reg.ring("engine/step_seconds")
    assert [r["step"] for r in ring] == list(range(1, tel["decode_steps"] + 1))
    for name in ("prefill", "draft", "decode"):
        hist = snap["histograms"][f"span_seconds/{name}"]
        assert hist["count"] == snap["counters"][f"span_calls/{name}"] > 0
        assert tel[name] == pytest.approx(hist["sum"], abs=1e-5)
        assert snap["counters"][f"stall_seconds/{name}"] == pytest.approx(
            tel[name], abs=1e-5)
    assert snap["histograms"]["span_seconds/decode"]["count"] == \
        tel["decode_steps"]
    assert eng.queue_depth == 0
    assert eng.free_blocks == eng.kv.num_blocks - 1


def _exercise(reg):
    """The same calls on a registry of either package; its snapshot less
    the time stamp."""
    reg.counter("a", 2)
    reg.counter("a", 3)
    reg.gauge("g", 1.5)
    reg.gauge("g", 2.5)  # last value wins
    reg.observe("h", 0.003)
    reg.observe("h", 999.0)  # overflow bucket
    for i in range(50):
        reg.ring_append("r", {"i": i})
    report = {"x": 1}
    assert reg.set_report("rep", report) is report
    snap = reg.snapshot()
    snap.pop("ts")
    return snap


def test_registry_semantics_match_the_jax_registry():
    reg = MetricsRegistry(ring_size=8)
    snap = _exercise(reg)
    assert snap == _exercise(JaxRegistry(ring_size=8))
    assert [r["i"] for r in reg.ring("r")] == list(range(42, 50))
    assert snap["histograms"]["h"]["overflow"] == 1
    assert reg.counter_value("a") == 5.0 and reg.gauge_value("g") == 2.5


def test_disabled_registry_records_nothing_but_spans_still_time():
    reg = MetricsRegistry()
    timer = StepTimer()
    prev = obs.set_enabled(False)
    try:
        reg.counter("a")
        reg.gauge("g", 1.0)
        reg.ring_append("r", {"i": 1})
        with obs.span("x", timer=timer, registry=reg) as sp:
            pass
    finally:
        obs.set_enabled(prev)
    snap = reg.snapshot()
    assert not snap["counters"] and not snap["gauges"] and not snap["rings"]
    assert sp.seconds >= 0.0 and timer.stalls["x"] == sp.seconds


def test_spans_nest_and_attribute_into_the_timer():
    reg = MetricsRegistry()
    timer = StepTimer()
    with obs.span("decode", timer=timer, registry=reg):
        assert obs.current_span() == "decode"
        with obs.span("sample", registry=reg) as inner:
            assert obs.current_span() == "decode/sample"
    assert obs.current_span() is None
    snap = reg.snapshot()
    assert snap["counters"]["span_calls/decode"] == 1
    assert snap["counters"]["span_calls/decode/sample"] == 1
    assert snap["histograms"]["span_seconds/decode/sample"]["sum"] == \
        pytest.approx(inner.seconds, abs=1e-6)
    assert set(timer.stalls) == {"decode"}


def test_stall_report_keys_match_the_jax_timer():
    reports = []
    for cls in (StepTimer, JaxStepTimer):
        t = cls()
        t.attribute("queue_wait", 0.25)
        t.attribute("decode", 0.5)
        t.attribute("decode", 0.25)
        reports.append(t.stall_report())
    got, want = reports
    assert list(got) == list(want)
    assert got["decode"] == want["decode"] == 0.75
    assert got["queue_wait"] == 0.25 and got["dispatch"] == 0.0


def test_events_pass_both_schemas(pair, tmp_path, monkeypatch):
    """Every record a speculating, adaptive, prefix-caching run emits
    conforms to the port's schema, and the port's rows equal the JAX
    package's for the same names."""
    path = tmp_path / "ev.jsonl"
    monkeypatch.setenv("DTPU_EVENT_LOG", str(path))
    rng = np.random.default_rng(4)
    shared = rng.integers(0, VOCAB, (8,)).astype(np.int32)
    prompts = [np.concatenate([shared, np.array([i], np.int32)])
               for i in range(3)]
    eng = Engine(pair[1], draft_model=pair[1], spec_k="adaptive",
                 prefix_cache=True, **ENGINE)
    eng.run([Request(p, 20) for p in prompts], tenants=["a", "a", "b"])
    eng.update_weights(draft_params=dict(pair[1].params))
    events = read_events(path)
    kinds = {e["event"] for e in events}
    assert {evs.DECODE_KERNEL_SELECTED, evs.PREFIX_CACHE_HIT,
            evs.SPEC_VERIFY, evs.DRAFT_SYNC} <= kinds
    for e in events:
        assert evs.check(e) == [], e
    for name, row in evs.EVENTS.items():
        assert tuple(row["required"]) == jax_evs.required_keys(name)
        assert tuple(row["optional"]) == jax_evs.optional_keys(name)
    assert evs.check({"event": evs.SPEC_VERIFY, "rounds": 1}) == [
        "spec_verify: missing 'accepted'", "spec_verify: missing 'proposed'"]
    assert evs.check({"event": "bogus"}) == ["undeclared event 'bogus'"]


def test_event_log_appends_whole_records_and_skips_a_torn_tail(tmp_path):
    log = EventLog(tmp_path / "ev.jsonl")
    log.emit(evs.SPEC_VERIFY, rounds=1, proposed=2, accepted=1)
    log.emit(evs.DRAFT_SYNC, weights_version=3)
    with open(tmp_path / "ev.jsonl", "a") as f:
        f.write('{"event": "torn')
    recs = log.read()
    log.close()
    assert [r["event"] for r in recs] == [evs.SPEC_VERIFY, evs.DRAFT_SYNC]
    assert all({"ts", "pid"} <= set(r) for r in recs)
