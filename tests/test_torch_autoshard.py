"""The port's auto-shard planner (``distributed_tpu_torch/parallel/
auto_shard.py``) and ``Model.compile(strategy="auto")`` against the JAX
package's.

- Plan parity: for the rows of ``tests/test_autoshard.py`` (uncapped DP,
  pinned dimensions, a cap that keeps FSDP, no feasible candidate, an
  indivisible batch, the capped awkward pipelined LM, PP rows gated on
  pipe hints, PP divisibility) at 1, 2, 4 and 8 ranks, the port's
  ``plan_sharding(devices=list(range(n)), device="cpu").summary()`` equals
  JAX's on ``jax.devices()[:n]``, JSON-equal with floats at a relative
  1e-12 (or both raise the same ``ValueError`` text). Planning forms no
  process group and calls no collective.
- On 2 gloo ranks (one group for the module): the bytes a rank holds
  once built under dp, zero1, fsdp, tp2 and pp2 equal the plan's row,
  less the 12 bytes of optax's Adam scalars the port holds as no tensor
  (``HOST_LEAVES``: its two counts, host integers here, and ``eps_root``,
  fixed at 0 here); ``compile(strategy=
  "auto")`` plans at build, commits DP's row, trains 3 steps to JAX's
  losses (rtol 1e-5, the DP tests' gate), reports JAX's plan in
  ``last_fit_telemetry["plan"]`` and an ``auto_shard_plan`` event; pinned
  precision and K survive; a cap that only FSDP's state and activations
  fit commits FSDP, which trains; compile after
  build moves the live parameters; a strategy instance replaces the
  scope; ``measure=True`` commits the same, fastest measured candidate on
  both ranks.
"""

import json
import math
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.parallel import plan_sharding as jax_plan
from distributed_tpu_torch.parallel import auto_shard
from distributed_tpu_torch.parallel import plan_sharding as port_plan

from torch_parity import ROOT

torch.set_num_threads(1)

SEQ = 16
LM_KW = dict(vocab=128, num_layers=1, d_model=32, num_heads=2, max_len=SEQ)
AWKWARD = dict(vocab=331, num_layers=4, d_model=36, num_heads=2, d_ff=84,
               max_len=33, pipeline=True)
FIXED = dict(grad_accums=(1,), steps_per_execution=(1,))


def lm_pair(**overrides):
    """The same LM configuration in both packages."""
    kw = dict(LM_KW)
    kw.update(overrides)
    vocab = kw.pop("vocab")
    jmod = dtpu.models.transformer_lm(vocab, **kw)
    if jmod.name is None:
        jmod.name = jmod.default_name()
    return jmod, dtt.models.transformer_lm(vocab, **kw)


def plans(n, lm_kw, plan_kw):
    """(JAX's, the port's) plan summary, or ("raise", text) for each."""
    jmod, tmod = lm_pair(**lm_kw)
    out = []
    for fn, mod, devices, extra in (
            (jax_plan, jmod, jax.devices()[:n], {}),
            (port_plan, tmod, list(range(n)), {"device": "cpu"})):
        try:
            out.append(json.loads(json.dumps(fn(
                mod, (SEQ,), optimizer="adam", devices=devices,
                **plan_kw, **extra).summary())))
        except ValueError as e:
            out.append(("raise", str(e)))
    return out


def assert_same(a, b, path="plan"):
    """JSON-equal, floats at a relative 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and math.isclose(a, b, rel_tol=1e-12), (
            path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _cap_dp_fsdp(n, lm_kw, kw):
    """Halfway between DP's and FSDP's state bytes (JAX's pre-plan), or
    half of one device's state at n = 1 (nothing fits)."""
    pre = jax_plan(lm_pair(**lm_kw)[0], (SEQ,), optimizer="adam",
                   devices=jax.devices()[:n], **kw).summary()
    by = {r["config"]["strategy"]: r for r in pre["candidates"]}
    if n == 1:
        return by["single_device"]["state_bytes_per_device"] // 2
    return (by["dp"]["state_bytes_per_device"]
            + by["fsdp"]["state_bytes_per_device"]) // 2


def _cap_pp2(n, lm_kw, kw):
    """Halfway between the best pp2 need and the best flat need (the
    JAX test's cap), or no cap where no pp2 row exists."""
    pre = jax_plan(lm_pair(**lm_kw)[0], (SEQ,), optimizer="adam",
                   devices=jax.devices()[:n], **kw).summary()
    need = {r["label"]: r["state_bytes_per_device"]
            + r["activation_bytes_per_device"]
            for r in pre["candidates"] + [p for p in pre["pruned"]
                                          if "state_bytes_per_device" in p]}
    pp2 = [v for k, v in need.items() if k.startswith("pp2")]
    if not pp2:
        return None
    rest = min(v for k, v in need.items() if not k.startswith("pp2"))
    return (min(pp2) + rest) // 2


# name: (LM overrides, plan keywords, cap rule or None)
CASES = {
    "uncapped_picks_dp": (dict(vocab=512, d_model=64),
                          dict(batch_size=16, **FIXED), None),
    "pinned_dimensions": ({}, dict(batch_size=16,
                                   precisions=("mixed_bfloat16",),
                                   grad_accums=(2,),
                                   steps_per_execution=(4,)), None),
    "cap_keeps_fsdp": (dict(vocab=512, d_model=64),
                       dict(batch_size=16, include_tp=False, **FIXED),
                       _cap_dp_fsdp),
    "no_feasible_raises": ({}, dict(batch_size=16, hbm_cap_bytes=16), None),
    "indivisible_batch": ({}, dict(batch_size=3, include_tp=False, **FIXED),
                          None),
    "indivisible_batch_tp": ({}, dict(batch_size=3, **FIXED), None),
    "awkward_pp2_capped": (AWKWARD, dict(batch_size=16, **FIXED), _cap_pp2),
    "pp_rows_gated": ({}, dict(batch_size=16), None),
    "pp_rows_gated_off": (dict(num_layers=4, pipeline=True),
                          dict(batch_size=16, include_pp=False, **FIXED),
                          None),
    "pp_divisibility": (dict(num_layers=6, pipeline=True),
                        dict(batch_size=16, **FIXED), None),
}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_jax(case, n):
    lm_kw, plan_kw, cap = CASES[case]
    plan_kw = dict(plan_kw)
    if cap is not None:
        plan_kw["hbm_cap_bytes"] = cap(n, lm_kw, plan_kw)
    want, got = plans(n, lm_kw, plan_kw)
    assert_same(want, got)
    if case == "uncapped_picks_dp" and n > 1:
        assert got["chosen"]["config"]["strategy"] == "dp"
    if case == "cap_keeps_fsdp" and n == 8:  # the JAX test's 8 devices
        assert got["chosen"]["config"]["strategy"] == "fsdp"
    if case == "awkward_pp2_capped" and n == 8:  # dims no 8-divisor splits
        assert got["chosen"]["config"]["strategy"] == "pp"
    if case == "no_feasible_raises":
        assert got[0] == "raise" and "NO feasible" in got[1]


def test_planning_forms_no_group_and_calls_no_collective(monkeypatch):
    """8 ranks planned in a process without a process group: no group is
    formed, no collective or group constructor is called."""
    def refuse(*a, **k):
        raise AssertionError("the planner called torch.distributed")

    for name in ("init_process_group", "new_group", "all_reduce",
                 "all_gather_into_tensor", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    assert not dist.is_initialized()
    plan = port_plan(lm_pair(num_layers=4, pipeline=True)[1], (SEQ,),
                     optimizer="adam", batch_size=16,
                     devices=list(range(8)), device="cpu")
    assert plan.devices == 8 and not dist.is_initialized()
    labels = {r["label"] for r in plan.candidates}
    assert {"dp", "zero1", "fsdp", "tp2", "pp2/m2"} <= labels


def test_card_prunes_graph_blocked_candidates(monkeypatch):
    """The port-only rule on the card: a K > 1 candidate whose strategy's
    forward issues collectives is pruned with that strategy's reason;
    SingleDevice and DP keep their K = 8 rows. Off the card nothing is
    pruned for it."""
    monkeypatch.setattr(auto_shard, "_backend", lambda device: "gpu")
    plan = port_plan(lm_pair(num_layers=4, pipeline=True)[1], (SEQ,),
                     optimizer="adam", batch_size=16, devices=[0, 1],
                     grad_accums=(1,), steps_per_execution=(1, 8))
    pruned = {r["label"]: r["reason"] for r in plan.pruned}
    for label, cls in (("fsdp/k8", "FSDP"),
                       ("tp2/k8", "DataTensorParallel"),
                       ("pp2/m2/k8", "DataPipelineParallel")):
        assert label in pruned and cls in pruned[label], pruned
        assert "1.3a" in pruned[label]
    kept = {r["label"] for r in plan.candidates}
    assert {"single_device/k8", "dp/k8", "zero1/k8"} <= kept
    assert plan.backend == "gpu"


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="no cost constants"):
        auto_shard._backend_constants("tpu")


def test_compile_rejects_garbage():
    m = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    with pytest.raises(ValueError, match="strategy must be None, the "
                       "string 'auto', or a parallel.Strategy instance"):
        m.compile(optimizer="adam", strategy="autoo")


def test_plain_recompile_drops_pending_plan():
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=1, d_model=16,
                                            num_heads=2, max_len=SEQ),
                  device="cpu")
    m.compile(optimizer="adam", strategy="auto",
              auto_options=dict(batch_size=4))
    assert m._auto_shard is not None
    m.compile(optimizer="adam")
    m.build((SEQ,))
    assert m.last_plan is None and isinstance(m.strategy, dtt.SingleDevice)


def test_single_process_auto_commits_single_device():
    """One process: the only candidate family is single_device; the plan
    is committed at build and its K and grad_accum become the defaults."""
    m = dtt.Model(dtt.models.transformer_lm(32, num_layers=1, d_model=16,
                                            num_heads=2, max_len=SEQ),
                  device="cpu")
    m.compile(optimizer="adam", strategy="auto",
              auto_options=dict(batch_size=4, grad_accums=(2,)))
    m.build((SEQ,))
    cfg = m.last_plan.chosen["config"]
    assert cfg["strategy"] == "single_device" and cfg["grad_accum"] == 2
    assert isinstance(m.strategy, dtt.SingleDevice)
    assert m.steps_per_execution == cfg["steps_per_execution"]
    assert m._auto_grad_accum == 2
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 32, (8, SEQ + 1)).astype(np.int32)
    hist = m.fit(tok[:, :-1], tok[:, 1:], batch_size=4, epochs=1,
                 steps_per_epoch=2, verbose=0)
    assert np.isfinite(hist.history["loss"][-1])
    assert m.last_fit_telemetry["plan"]["chosen"]["label"] == \
        m.last_plan.chosen["label"]


# ------------------------------------------------------------- two ranks --
WORKER = '''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch import interop
from distributed_tpu_torch.parallel import plan_sharding
from distributed_tpu_torch.utils.events import read_events
from distributed_tpu_torch.utils.profiler import tree_bytes_per_device

spec = dtt.cluster.initialize(device="cpu", timeout=60)
rank = spec.index
data = np.load(sys.argv[1])
tmp = sys.argv[2]
SEQ = 16
out = {}

def lm(**kw):
    kw2 = dict(num_layers=1, d_model=32, num_heads=2, max_len=SEQ)
    kw2.update(kw)
    return dtt.models.transformer_lm(128, **kw2)

def held(m):
    return tree_bytes_per_device(m._param_list(), list(m.state.values()),
                                 m.opt_state)["max_bytes_per_device"]

# Live equals abstract.
for label, make, mod_kw in (
        ("dp", lambda: dtt.DataParallel(device="cpu"), {}),
        ("zero1", lambda: dtt.ZeroDataParallel(device="cpu"), {}),
        ("fsdp", lambda: dtt.FSDP(device="cpu"), {}),
        ("tp2", lambda: dtt.DataTensorParallel(model_parallel=2,
                                               device="cpu"), {}),
        ("pp2/m2", lambda: dtt.DataPipelineParallel(pipeline_parallel=2,
                                                    device="cpu"),
         dict(num_layers=4, pipeline=True))):
    with make().scope():
        m = dtt.Model(lm(**mod_kw))
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    m.build((SEQ,))
    plan = plan_sharding(lm(**mod_kw), (SEQ,), tx=m.tx, batch_size=16,
                         devices=[0, 1], device="cpu", include_tp=True,
                         grad_accums=(1,), steps_per_execution=(1,))
    rows = {r["label"]: r for r in plan.candidates + plan.pruned}
    host = {path: np.asarray(leaf).itemsize
            for path, leaf in plan._ctx["abstracts"]["opt"]
            if isinstance(leaf, np.generic)}
    out["bytes/" + label] = [rows[label]["state_bytes_per_device"],
                             held(m), host]
    del m

x, y = data["x"], data["y"]
jax_params = {k[2:]: data[k] for k in data.files if k.startswith("p:")}

def fit3(m):
    return m.fit(x, y, batch_size=16, epochs=1, steps_per_epoch=3,
                 verbose=0, seed=0).history["loss"]

# compile(strategy="auto") end to end.
os.environ["DTPU_EVENT_LOG"] = os.path.join(tmp, f"events-{rank}.jsonl")
m = dtt.Model(lm(), device="cpu")
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
          strategy="auto", auto_options=dict(batch_size=16, devices=[0, 1]))
m.build((SEQ,))
interop.place(m, params=jax_params)
out["e2e/strategy"] = type(m.strategy).__name__
out["e2e/k"] = m.steps_per_execution
out["e2e/loss"] = fit3(m)
out["e2e/plan"] = m.last_fit_telemetry["plan"]
out["e2e/events"] = [e["event"] for e in read_events(
    os.environ.pop("DTPU_EVENT_LOG"))]
out["e2e/state_bytes"] = [m.last_plan.chosen["state_bytes_per_device"],
                          held(m)]
del m

# Compile after build: the live parameters move to the winner.
m = dtt.Model(lm(), device="cpu")
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
m.build((SEQ,))
interop.place(m, params=jax_params)
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
          strategy="auto", auto_options=dict(batch_size=16, devices=[0, 1]))
out["late/strategy"] = type(m.strategy).__name__
out["late/loss"] = fit3(m)
del m

# Pinned precision and K.
m = dtt.Model(lm(), device="cpu")
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
          strategy="auto", precision="mixed_bfloat16", steps_per_execution=2,
          auto_options=dict(batch_size=16, devices=[0, 1]))
m.build((SEQ,))
out["pinned"] = [m.precision.name, m.steps_per_execution,
                 m.last_plan.chosen["config"]]
del m

# A cap between ZeRO-1's and FSDP's need commits FSDP, which trains.
pre = plan_sharding(lm(), (SEQ,), optimizer="adam", batch_size=16,
                    devices=[0, 1], device="cpu", include_tp=False, **{
                        "grad_accums": (1,), "steps_per_execution": (1,)})
need = {r["config"]["strategy"]: r["state_bytes_per_device"]
        + r["activation_bytes_per_device"] for r in pre.candidates}
cap = (need["zero1"] + need["fsdp"]) // 2
m = dtt.Model(lm(), device="cpu")
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
          strategy="auto", hbm_cap_bytes=cap,
          auto_options=dict(batch_size=16, grad_accums=(1,),
                            steps_per_execution=(1,), include_tp=False))
m.build((SEQ,))
out["cap"] = [type(m.strategy).__name__, fit3(m),
              m.last_plan.chosen["state_bytes_per_device"], held(m)]
del m

# A strategy instance replaces the scope.
m = dtt.Model(lm(), device="cpu")
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
          strategy=dtt.FSDP(device="cpu"))
m.build((SEQ,))
out["instance"] = [type(m.strategy).__name__, fit3(m)]
del m

# measure=True: the shortlist timed on both ranks, the same winner.
m = dtt.Model(lm(), device="cpu")
m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
          strategy="auto", measure=True,
          auto_options=dict(batch_size=16, grad_accums=(1,),
                            steps_per_execution=(1,), include_tp=False,
                            top_k=2))
m.build((SEQ,))
out["measure"] = [m.last_plan.tie_break, m.last_plan.measured,
                  m.last_plan.chosen["config"], type(m.strategy).__name__]
out["measure/loss"] = fit3(m)
dtt.launch.report_result(out)
dtt.cluster.shutdown()
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The worker's results on 2 gloo ranks, and JAX's auto-compiled LM on
    2 devices from the same parameters and tokens."""
    tmp = tmp_path_factory.mktemp("autoshard")
    jmod, _ = lm_pair()
    jm = dtpu.Model(jmod)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               strategy="auto",
               auto_options=dict(batch_size=16, devices=jax.devices()[:2]))
    jm.build((SEQ,))
    params = {f"p:{k}": v for k, v in dtt.interop.flatten_tree(
        jax.device_get(jm.params)).items()}
    rng = np.random.default_rng(0)
    tok = rng.integers(0, LM_KW["vocab"], (64, SEQ + 1)).astype(np.int32)
    x, y = tok[:, :-1], tok[:, 1:]
    jhist = jm.fit(x, y, batch_size=16, epochs=1, steps_per_epoch=3,
                   verbose=0, seed=0)
    np.savez(tmp / "data.npz", x=x, y=y, **params)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    rows = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": str(ROOT)}).run(
        [sys.executable, str(script), str(tmp / "data.npz"), str(tmp)], 2,
        timeout=240)
    for r in rows:
        assert r.ok, f"worker {r.index}: {r.error}\n{r.log_tail}"
    return ({r.index: r.value for r in rows},
            {"loss": jhist.history["loss"],
             "plan": json.loads(json.dumps(jm.last_fit_telemetry["plan"])),
             "config": jm.last_plan.chosen["config"]})


#: Leaves of optax's Adam tree that JAX holds as device scalars and the
#: port does not hold as tensors: the inject count and Adam's step count
#: (host integers in the port) and ``eps_root`` (fixed at 0 in the port).
HOST_LEAVES = {"#0": 4, "#1/eps_root": 4, "#3/#0/#0": 4}


@pytest.mark.parametrize("label", ["dp", "zero1", "fsdp", "tp2", "pp2/m2"])
def test_live_bytes_equal_plan(two_ranks, label):
    """What a rank holds once built equals the plan's row, less the 12
    bytes of ``HOST_LEAVES``."""
    ranks, _ = two_ranks
    for out in ranks.values():
        planned, live, host = out[f"bytes/{label}"]
        assert host == HOST_LEAVES
        assert planned - sum(HOST_LEAVES.values()) == live, (
            label, planned, live)


def test_auto_compile_trains_to_jax_losses(two_ranks):
    ranks, jax_run = two_ranks
    for out in ranks.values():
        assert out["e2e/strategy"] == "DataParallel"
        assert out["e2e/k"] == jax_run["config"]["steps_per_execution"]
        np.testing.assert_allclose(out["e2e/loss"], jax_run["loss"],
                                   rtol=1e-5)
        planned, live = out["e2e/state_bytes"]
        assert planned - sum(HOST_LEAVES.values()) == live


def test_auto_telemetry_and_event_equal_jax(two_ranks):
    ranks, jax_run = two_ranks
    for out in ranks.values():
        assert_same(jax_run["plan"], out["e2e/plan"])
        assert "auto_shard_plan" in out["e2e/events"]


def test_compile_after_build_moves_live_params(two_ranks):
    ranks, jax_run = two_ranks
    for out in ranks.values():
        assert out["late/strategy"] == "DataParallel"
        np.testing.assert_allclose(out["late/loss"], jax_run["loss"],
                                   rtol=1e-5)


def test_pinned_precision_and_k_survive(two_ranks):
    ranks, _ = two_ranks
    for out in ranks.values():
        name, k, cfg = out["pinned"]
        assert name == "mixed_bfloat16" and k == 2
        assert cfg["precision"] == "mixed_bfloat16"
        assert cfg["steps_per_execution"] == 2


def test_cap_commits_fsdp_and_trains(two_ranks):
    ranks, _ = two_ranks
    for out in ranks.values():
        strategy, losses, planned, live = out["cap"]
        assert strategy == "FSDP" and np.all(np.isfinite(losses))
        assert planned - sum(HOST_LEAVES.values()) == live


def test_strategy_instance_replaces_scope(two_ranks):
    ranks, _ = two_ranks
    for out in ranks.values():
        assert out["instance"][0] == "FSDP"
        assert np.all(np.isfinite(out["instance"][1]))


def test_measure_commits_same_fastest_candidate(two_ranks):
    ranks, _ = two_ranks
    assert ranks[0]["measure"] == ranks[1]["measure"]
    tie_break, measured, chosen, _ = ranks[0]["measure"]
    assert tie_break == "measured" and len(measured) == 2
    timed = [r for r in measured if r["seconds_per_step"] is not None]
    assert timed
    assert chosen == min(timed, key=lambda r: r["seconds_per_step"])["config"]
    for out in ranks.values():
        assert np.all(np.isfinite(out["measure/loss"]))
