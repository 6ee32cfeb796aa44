"""The port's public surface against the JAX package's.

- Every module of ``distributed_tpu`` (``pkgutil.walk_packages``; private
  modules skipped) has its counterpart in ``distributed_tpu_torch``, with
  each public name (``__all__``, else the classes and functions the
  module defines), each public method of those classes and each keyword
  parameter (``inspect.signature``). The only exceptions are the rows of
  ``DESIGN``: a design difference each, with its reason.
- What the repairs added behaves as JAX's on the same inputs:
  ``utils.tree`` on the same numpy trees, ``Model.summary()``'s text and
  ``Sequential.add``'s names on the same models, ``StepTimer``'s rates on
  the same clock, the JSONL events, ``EmaBaseline.update(reward_mean=)``,
  ``BlockAllocator.free`` and ``PrefixStore.blocks``.
"""

import fnmatch
import importlib
import inspect
import json
import pkgutil
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.serving import kv_cache as jkv
from distributed_tpu.utils import logging as jlog
from distributed_tpu.utils import profiler as jprof
from distributed_tpu.utils import tree as jtree
from distributed_tpu_torch.serving import kv_cache as pkv
from distributed_tpu_torch.utils import logging as plog
from distributed_tpu_torch.utils import profiler as pprof
from distributed_tpu_torch.utils import tree as ptree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: The declared design differences: (reason, patterns over the entries the
#: walk reports, which are ``<module>.<name>``, ``<module>.<Class>.<method>``
#: or ``<callable>(<keyword>=)``, module paths without the package name).
DESIGN = [
    ("the port's layers are torch.nn.Modules: a layer holds its "
     "parameters and state and runs forward(x), so the functional "
     "init/apply/param_spec and the params/state arguments of the cache "
     "paths have no counterpart",
     ["nn.*.init", "nn.*.param_spec", "nn.*.apply(*=)",
      "nn.core.apply_layers(*=)", "nn.*.init_cache(params=)",
      "nn.*.decode(params=)", "nn.*.decode(state=)",
      "nn.*.init_paged_cache(params=)", "nn.*.paged_*(params=)",
      "nn.*.paged_*(state=)", "serving*.PagedKVCache.__init__(params=)"]),
    ("the strategies' GSPMD placement (shardings, device_put of batches "
     "and parameters, sharding constraints in the traced step): the port "
     "runs one process per card and places each rank's blocks itself",
     ["parallel*.put_batch", "parallel*.put_params",
      "parallel*.params_sharding", "parallel*.batch_sharding",
      "parallel*.constrain_step", "parallel*.constrain_compute_params(*=)",
      "parallel*.opt_state_sharding(*=)"]),
    ("auto_shard.shard_rows/ambient_mesh (a decision in ROADMAP): JAX "
     "needs them because XLA's partitioner cannot see inside a Pallas "
     "kernel",
     ["parallel.auto_shard.shard_rows", "parallel.auto_shard.ambient_mesh"]),
    ("the planner's forward probe runs a fake copy of the module "
     "(abstract_model_state), not a functional (module, params, state)",
     ["parallel.auto_shard.probe_forward(*=)"]),
    ("utils.compile_cache (a decision in ROADMAP): the port compiles "
     "nothing at run time; its kernels are built once a checkout",
     ["utils.compile_cache"]),
    ("ops.paged_attention's ambient decode-kernel scope: the port's "
     "layers take decode_kernel= as an argument",
     ["ops.paged_attention.decode_kernel_scope",
      "ops.paged_attention.current_decode_kernel"]),
    ("functional helpers of the stacked and sample-weighted paths: the "
     "port's ScannedBlocks runs its slices itself, draws from a "
     "torch.Generator, and its losses take the weights as arguments",
     ["nn.scan.stacked_*", "nn.scan.scan_stacked",
      "nn.scan.init_stacked_blocks(key=)", "nn.core.*_sample_weights"]),
    ("the fused Adam optimizer is optim.fused_adam/fused_adamw (an "
     "optimizer owning its state dict); ops.fused_update holds the "
     "kernel's wrapper",
     ["ops.fused_update.FusedAdamState", "ops.fused_update.fused_adam",
      "ops.fused_update.fused_adamw"]),
]


def _modules():
    names = ["distributed_tpu"]
    for info in pkgutil.walk_packages(dtpu.__path__, "distributed_tpu."):
        if not any(p.startswith("_") for p in info.name.split(".")):
            names.append(info.name)
    return sorted(names)


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return {n: getattr(mod, n) for n in names}
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isclass(v) or inspect.isfunction(v))
            and getattr(v, "__module__", None) == mod.__name__}


def _keywords(f):
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
            and p.name not in ("self", "cls")]


def _missing_keywords(jf, pf, label):
    jk, pk = _keywords(jf), _keywords(pf)
    if jk is None or pk is None:
        return []
    return [f"{label}({k}=)" for k in jk if k not in pk]


def _short(module_name: str) -> str:
    return module_name[len("distributed_tpu"):].lstrip(".")


def missing(jax_name: str):
    """What the port lacks of JAX module ``jax_name``, as entries."""
    short = _short(jax_name)
    prefix = f"{short}." if short else ""
    jm = importlib.import_module(jax_name)
    try:
        pm = importlib.import_module(
            "distributed_tpu_torch" + jax_name[len("distributed_tpu"):])
    except ModuleNotFoundError:
        return [short]
    out = []
    for name, jv in _public(jm).items():
        if not hasattr(pm, name):
            out.append(prefix + name)
            continue
        pv = getattr(pm, name)
        if isinstance(jv, types.ModuleType):
            continue
        # A re-exported class or function is reported where it is defined.
        home = getattr(jv, "__module__", None) or ""
        label = (_short(home) + "." + jv.__qualname__
                 if home.startswith("distributed_tpu.") else prefix + name)
        if inspect.isclass(jv):
            for meth, jmv in vars(jv).items():
                if meth.startswith("_") and meth != "__init__":
                    continue
                if not (callable(jmv) or isinstance(
                        jmv, (property, staticmethod, classmethod))):
                    continue
                if not hasattr(pv, meth):
                    out.append(f"{label}.{meth}")
                elif not isinstance(jmv, property):
                    out += _missing_keywords(getattr(jv, meth),
                                             getattr(pv, meth),
                                             f"{label}.{meth}")
        elif callable(jv):
            out += _missing_keywords(jv, pv, label)
    return out


def _declared(entry):
    return any(fnmatch.fnmatchcase(entry, pat)
               for _, pats in DESIGN for pat in pats)


@pytest.mark.parametrize("jax_name", _modules())
def test_port_has_every_public_name_and_keyword(jax_name):
    undeclared = [e for e in missing(jax_name) if not _declared(e)]
    assert not undeclared, (
        f"the port lacks, of {jax_name}: {undeclared} (port them, or "
        "declare a design difference in DESIGN with its reason)")


def test_every_design_row_is_used_and_gives_a_reason():
    """No stale row: each pattern excuses something the walk finds."""
    found = [e for name in _modules() for e in missing(name)]
    for reason, pats in DESIGN:
        assert len(reason) > 40, reason
        for pat in pats:
            assert any(fnmatch.fnmatchcase(e, pat) for e in found), pat


def test_top_level_names_and_version():
    for name in ("Policy", "losses", "metrics", "make_mesh", "Strategy",
                 "current_strategy", "__version__"):
        assert hasattr(dtt, name), name
    assert dtt.__version__ == dtpu.__version__
    text = (ROOT / "pyproject.toml").read_text()
    assert re.search(r'^version = "([^"]+)"', text, re.M).group(1) == \
        dtt.__version__
    assert dtt.parallel.AXES == dtpu.parallel.AXES
    assert dtt.cluster.ELASTIC_WORLD_ENV == dtpu.cluster.ELASTIC_WORLD_ENV
    assert dtt.Policy is dtt.precision.Policy
    assert dtt.current_strategy() is None


# ----------------------------------------------------------------- trees
def _trees():
    rng = np.random.default_rng(0)
    a = {"b": [rng.standard_normal((3, 2)).astype(np.float32),
               np.arange(5, dtype=np.int32)],
         "a": {"k": rng.standard_normal((4,)).astype(np.float32),
               "none": None},
         "c": (np.float16(1.5) * np.ones((2, 2), np.float16),)}
    return a


@pytest.mark.parametrize("fn", ["tree_size", "tree_bytes", "tree_count"])
def test_tree_sizes_match_jax(fn):
    a = _trees()
    as_torch = {"b": [torch.from_numpy(a["b"][0]), torch.from_numpy(a["b"][1])],
                "a": {"k": torch.from_numpy(a["a"]["k"]), "none": None},
                "c": (torch.from_numpy(a["c"][0]),)}
    want = getattr(jtree, fn)(a)
    assert getattr(ptree, fn)(a) == want
    assert getattr(ptree, fn)(as_torch) == want


@pytest.mark.parametrize("change", [None, "small", "large", "leaf", "dtype"])
def test_tree_comparisons_match_jax(change):
    a = _trees()
    b = _trees()
    if change == "small":
        b["a"]["k"] = b["a"]["k"] + np.float32(1e-7)
    elif change == "large":
        b["b"][0] = b["b"][0] + np.float32(1e-2)
    elif change == "leaf":
        b["b"].append(np.zeros(1, np.float32))
    elif change == "dtype":
        b["b"][1] = b["b"][1].astype(np.float64)
    assert ptree.tree_allclose(a, b) == bool(jtree.tree_allclose(a, b))
    assert ptree.tree_equal(a, b) == bool(jtree.tree_equal(a, b))
    tb = {k: v for k, v in b.items()}
    tb["b"] = [torch.from_numpy(np.asarray(v)) for v in b["b"]]
    assert ptree.tree_equal(a, tb) == bool(jtree.tree_equal(a, b))


# ------------------------------------------------ summary() and add()
def _mlp(pkg, explicit=False):
    seq = pkg.nn.Sequential([
        pkg.nn.Dense(8, activation="relu"),
        pkg.nn.Dense(8, name="dense_1") if explicit else pkg.nn.Dense(8),
    ])
    seq.add(pkg.nn.Dense(4))
    seq.add(pkg.nn.Dropout(0.1))
    seq.add(pkg.nn.Dense(3))
    return seq


@pytest.mark.parametrize("explicit", [False, True])
def test_sequential_add_names_as_jax(explicit):
    js, ps = _mlp(dtpu, explicit), _mlp(dtt, explicit)
    assert [l.name for l in ps.layers] == [l.name for l in js.layers]
    assert [n for n, _ in ps.named_children()] == [l.name for l in js.layers]


@pytest.mark.parametrize("name,shape", [
    ("mnist_cnn", (28, 28, 1)), ("cifar_cnn", (32, 32, 3)), ("mlp", (5,)),
])
def test_summary_text_matches_jax(name, shape, capsys):
    def module(pkg):
        return _mlp(pkg) if name == "mlp" else getattr(pkg.models, name)()

    jm = dtpu.Model(module(dtpu), name="net")
    jm.build(shape)
    want = jm.summary()
    capsys.readouterr()
    pm = dtt.Model(module(dtt), name="net", device="cpu").build(shape)
    before = {k: v.clone() for k, v in pm.params.items()}
    assert pm.summary() == want
    assert capsys.readouterr().out == want + "\n"
    assert all(torch.equal(before[k], v) for k, v in pm.params.items())
    with pytest.raises(ValueError, match="before summary"):
        dtt.Model(module(dtt), device="cpu").summary()


# --------------------------------------------------- StepTimer and events
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize("warmup,ticks", [(1, [1, 1, 1, 1]), (3, [2, 4, 1]),
                                          (5, [1, 1])])
def test_step_timer_rates_match_jax(warmup, ticks, tmp_path, monkeypatch):
    rates, records = [], []
    for prof, log in ((jprof, jlog), (pprof, plog)):
        monkeypatch.setattr(prof.time, "perf_counter", _Clock())
        path = tmp_path / f"{prof.__name__}.jsonl"
        log.set_jsonl(str(path))
        try:
            t = prof.StepTimer(warmup=warmup)
            for k in ticks:
                t.tick(k)
            rates.append((t.steps, t.steps_per_sec, t.report(tag="x")))
        finally:
            log.set_jsonl(None)
        rec = json.loads(path.read_text())
        rec.pop("ts")
        records.append(rec)
    assert rates[0] == rates[1]
    assert records[0] == records[1]
    assert records[1]["event"] == "step_rate" and records[1]["tag"] == "x"


def test_events_match_jax(tmp_path):
    records = []
    for log in (jlog, plog):
        log.event("anything", a=1)  # no sink: nothing written
        path = tmp_path / f"{log.__name__}.jsonl"
        log.set_jsonl(str(path))
        try:
            log.event("kind", a=1, b=[2.5, "x"])
        finally:
            log.set_jsonl(None)
        (rec,) = [json.loads(l) for l in path.read_text().splitlines()]
        assert isinstance(rec.pop("ts"), float)
        records.append(rec)
    assert records[0] == records[1]
    assert (records[1]["process_index"], records[1]["world_size"]) == (0, 1)


def test_profiler_hooks_on_the_cpu(tmp_path):
    with pprof.trace(str(tmp_path / "trace")):
        with pprof.annotate("region"):
            torch.ones(4).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json*"))
    assert len(files) == 1
    assert "region" in files[0].read_text()
    assert pprof.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert pprof.device_memory_stats() is None


# ------------------------------------------------------- small repairs
def test_ema_baseline_takes_reward_mean():
    from distributed_tpu import optim as jopt

    j, p = jopt.EmaBaseline(0.8), dtt.optim.EmaBaseline(0.8)
    for r in (1.0, 0.5, -2.0, 3.25):
        assert p.update(reward_mean=r) == pytest.approx(
            j.update(reward_mean=r), rel=1e-12)


def test_optim_get_and_initializers_get_keywords():
    assert isinstance(dtt.optim.get(name_or_tx="sgd", learning_rate=0.1),
                      type(dtt.optim.get("sgd", learning_rate=0.1)))
    init = dtt.nn.initializers.get("zeros", dtype=torch.float32)
    assert init is not None
    with pytest.raises(ValueError, match="Unknown initializer"):
        dtt.nn.initializers.get("nope", dtype=torch.float32)


def _allocator_script(mod):
    a = mod.BlockAllocator(8)
    out = []
    b = a.allocate(3)
    a.incref(b[:1])
    for blocks in ([b[0]], b[1:], b[1:], [b[0]], [b[0]]):
        try:
            out.append(("ok", a.free(blocks), a.num_free))
        except ValueError as e:
            out.append(("err", str(e)))
        if out[-1][0] == "err" and "shared" in out[-1][1]:
            a.decref(blocks)
    return out


def test_block_allocator_free_as_jax():
    assert _allocator_script(pkv) == _allocator_script(jkv)


def test_prefix_store_blocks_as_jax():
    stores = []
    for mod in (jkv, pkv):
        s = mod.PrefixStore()
        for key, block in (("a", 3), ("b", 5), ("a", 7), ("c", 1)):
            s.insert(key, block)
        s.lookup(["b"])
        stores.append((len(s), s.blocks))
    assert stores[0] == stores[1] == (3, [3, 1, 5])


def test_sync_check_cross_host_keyword():
    # Without a group there is nothing to compare either way.
    params = {"w": torch.ones(2)}
    dtt.utils.assert_replicas_identical(params, cross_host=False)
    dtt.utils.assert_replicas_identical(params, cross_host=True)
    assert dtt.utils.replica_drift(params) == {}
