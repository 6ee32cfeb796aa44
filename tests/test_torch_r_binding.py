"""The port's R binding (``r/distributedtputorch/``) against the
reference's (``r/distributedtpu/``), both run on the simulated R runtime.

- The three example flows run against the port on the CPU through
  ``tests/torch_r_sim.py`` (the R option ``distributedtputorch.device`` set
  to "cpu"), the reference's through ``tests/r_interp.py``:
  ``local.R`` in this process; ``distributed.R`` on 2 gloo ranks (the
  script's worker-address and index lines rewritten to the launcher's
  127.0.0.1 workers); ``spark_barrier.R`` with sparklyr mocked as the
  reference's test mocks it, its 3 partitions on 3 gloo ranks (one process
  a partition, as Spark's executors). Both packages start from the same
  weights (the JAX model's seed-0 draw, loaded into the port after its
  build) and their epoch losses agree at rtol 1e-5.
- ``dtpu_version()``, the HDF5 export read back by
  ``dtt.checkpoint.import_hdf5``, and float64 arrays from R taken as the
  model's float32 by ``fit``/``evaluate``/``predict``.
- The R sources parse, and import only ``distributed_tpu_torch``.
"""

import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
import r_interp
import r_lang
import torch_r_sim
from r_interp import RList, _scalar
from reticulate_sim import RArray, r_character, r_int
from torch_parity import no_cluster_env, run_ranks  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = REPO / "r" / "examples"
PORT = REPO / "r" / "distributedtputorch"
RTOL = 1e-5


@pytest.fixture(autouse=True)
def no_data_caches(tmp_path, monkeypatch):
    """Both packages (and the ranks, which inherit the environment) load
    the same synthetic MNIST: no cache to find in an empty home."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("DTPU_DATA_DIR", raising=False)
    yield
    monkeypatch.delenv("DTPU_CONFIG", raising=False)


def jax_start_params():
    """The parameters the JAX R flows train from: mnist_cnn built by
    ``fit`` from seed 0, as flat numpy leaves."""
    m = dtpu.Model(dtpu.models.mnist_cnn(10))
    m.build((28, 28, 1), seed=0)
    return {k: np.array(v) for k, v in
            dtt.interop.flatten_tree(jax.device_get(m.params)).items()}


class Recorder:
    """Patches ``Model.fit`` of a package to keep each call's epoch
    losses, and (the port) ``Model.build`` to load ``params`` after it."""

    def __init__(self, monkeypatch, model_cls, params=None):
        self.losses = []
        fit, build = model_cls.fit, model_cls.build

        def recording_fit(model, *a, **k):
            h = fit(model, *a, **k)
            self.losses.append([float(v) for v in h.history["loss"]])
            return h

        def loading_build(model, *a, **k):
            out = build(model, *a, **k)
            dtt.interop.place(model, params=params)
            return out

        monkeypatch.setattr(model_cls, "fit", recording_fit)
        if params is not None:
            monkeypatch.setattr(model_cls, "build", loading_build)


def assert_losses_match(port, ref):
    assert len(port) == len(ref) == 3, (port, ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)


# --------------------------------------------------------------- sources
def test_r_sources_parse_and_bind_only_the_port():
    files = sorted((PORT / "R").glob("*.R")) + sorted(
        (PORT / "examples").glob("*.R"))
    assert [f.name for f in files] == [
        "data.R", "model.R", "package.R", "strategy.R",
        "distributed.R", "local.R", "spark_barrier.R"]
    for path in files:
        text = path.read_text()
        assert r_lang.parse_file(path), path
        assert not re.search(r"import\(\"distributed_tpu\"|"
                             r"library\(distributedtpu\)", text), path
    imports = re.findall(r'reticulate::import\("([^"]+)"',
                         (PORT / "R" / "package.R").read_text())
    assert imports == ["distributed_tpu_torch", "distributed_tpu_torch"]
    desc = (PORT / "DESCRIPTION").read_text()
    assert desc.startswith("Package: distributedtputorch\n")
    namespace = (PORT / "NAMESPACE").read_text()
    ref = (REPO / "r" / "distributedtpu" / "NAMESPACE").read_text()
    assert set(ref.splitlines()) <= set(namespace.splitlines())


def test_version_through_r():
    interp = torch_r_sim.TorchInterp(device="cpu")
    interp.run_source("library(distributedtputorch)\nv <- dtpu_version()")
    ref = r_interp.make_interp()
    ref.run_source("library(distributedtpu)\nv <- dtpu_version()")
    got = _scalar(interp.global_env.lookup("v"))
    assert got == _scalar(ref.global_env.lookup("v")) == dtt.__version__


def test_library_of_the_reference_is_not_the_port():
    interp = torch_r_sim.TorchInterp(device="cpu")
    with pytest.raises(r_interp.RError, match="no package"):
        interp.run_source("library(distributedtpu)")
    with pytest.raises(r_interp.RError, match="cannot import"):
        interp.run_source('reticulate::import("distributed_tpu")')


def test_device_null_means_the_card():
    """Without the option the examples pass device = NULL: the card,
    which this box lacks, so the port refuses rather than run on the CPU."""
    interp = torch_r_sim.TorchInterp()
    interp.run_source("library(distributedtputorch)")
    assert r_interp.is_null(interp.run_source(
        'getOption("distributedtputorch.device")'))
    if not torch.cuda.is_available():
        with pytest.raises(r_interp.RError,
                           match="RuntimeError: .*torch.cuda.is_available"):
            interp.run_source("m <- dtpu_model(mnist_cnn(10L))")


# ------------------------------------------------------------- local.R
def test_local_flow_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jrec = Recorder(monkeypatch, dtpu.Model)
    ref = r_interp.make_interp()
    ref.run_file(JAX_EXAMPLES / "local.R")
    prec = Recorder(monkeypatch, dtt.Model, jax_start_params())
    interp = torch_r_sim.run_example("local", device="cpu")
    model = interp.global_env.lookup("model")
    assert "dtpu_model" in r_interp.r_class(model).values
    assert model.value._obj.step == 15
    assert model.value._obj.device.type == "cpu"
    assert_losses_match(prec.losses[0], jrec.losses[0])


def test_float64_from_r_is_taken_as_float32(tmp_path, monkeypatch):
    """R hands doubles over as float64; fit, evaluate and predict take
    them as float32, as JAX does, and agree with JAX on the same data."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    x = rng.random((32, 28, 28, 1))
    y = rng.integers(0, 10, (32,)).astype(np.int32)
    src = """
    {lib}
    m <- dtpu_model(mnist_cnn(10L){dev})
    m %>% compile(optimizer = "sgd", learning_rate = 0.05,
                  loss = "sparse_categorical_crossentropy",
                  metrics = c("accuracy"))
    h <- m %>% fit(x, y, batch_size = 16L, epochs = 2L, verbose = 0L)
    hl <- h$metrics$loss
    ev <- evaluate(m, x, y, batch_size = 16L)
    p <- predict_on_batch(m, x, batch_size = 16L)
    save_model_hdf5(m, "m.h5")
    """
    out = {}
    for pkg, interp, lib, dev in (
            (dtpu, r_interp.make_interp(), "library(distributedtpu)", ""),
            (dtt, torch_r_sim.TorchInterp(device="cpu"),
             "library(distributedtputorch)", ", device = \"cpu\"")):
        if pkg is dtt:
            Recorder(monkeypatch, dtt.Model, jax_start_params())
        interp.global_env.define("x", RArray(x, "double"))
        interp.global_env.define("y", RArray(y, "integer"))
        interp.run_source(src.format(lib=lib, dev=dev))
        g = interp.global_env.lookup
        out[pkg.__name__] = (
            g("hl").values,
            {n: _scalar(g("ev").get(n)) for n in g("ev").names},
            g("p").array)
    jl, jev, jp = out["distributed_tpu"]
    pl, pev, pp = out["distributed_tpu_torch"]
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    for name in jev:
        assert pev[name] == pytest.approx(jev[name], rel=RTOL, abs=1e-6)
    assert pp.dtype == np.float32 or pp.dtype == np.float64
    np.testing.assert_allclose(pp, jp, rtol=1e-4, atol=1e-6)
    tree, _ = dtt.checkpoint.import_hdf5("m.h5")
    assert set(tree) == {"params"} or set(tree) == {"params", "state"}


# ------------------------------------------------------- distributed.R
WORKER = r'''
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
import torch_r_sim
import distributed_tpu_torch as dtt
from r_interp import RList, _scalar
from reticulate_sim import r_character, r_int

flow, params_npz, out = sys.argv[1], sys.argv[2], Path(sys.argv[3])
spec = json.loads(os.environ["DTPU_CONFIG"])
WORKERS, RANK = spec["cluster"]["worker"], spec["task"]["index"]
PARAMS = dict(np.load(params_npz))
LOSSES = []
_fit, _build = dtt.Model.fit, dtt.Model.build


def fit(model, *a, **k):
    h = _fit(model, *a, **k)
    LOSSES.append([float(v) for v in h.history["loss"]])
    return h


def build(model, *a, **k):
    res = _build(model, *a, **k)
    dtt.interop.place(model, params=PARAMS)
    return res


dtt.Model.fit, dtt.Model.build = fit, build
(out / f"rank{{RANK}}").mkdir(parents=True, exist_ok=True)
os.chdir(out / f"rank{{RANK}}" if flow == "spark_barrier" else out)
text = (torch_r_sim.EXAMPLES / f"{{flow}}.R").read_text()
if flow == "distributed":
    # Only the worker-address and index lines change.
    addrs = ", ".join(f'"{{w}}"' for w in WORKERS)
    text = re.sub(r"workers <- c\([^)]*\)", f"workers <- c({{addrs}})",
                  text, count=1)
    text = text.replace("set_cluster_spec(workers, index = 0L)",
                        f"set_cluster_spec(workers, index = {{RANK}}L)", 1)
    interp = torch_r_sim.run_example(flow, device="cpu", source=text)
    rows = None
else:
    interp = torch_r_sim.TorchInterp(device="cpu")
    interp.run_source("library(distributedtputorch)")
    barrier_addresses = r_character(
        *[f"127.0.0.1:{{45001 + i}}" for i in range(len(WORKERS))])

    def spark_apply(sdf, f, **kw):
        assert _scalar(kw["barrier"]) is True
        assert int(_scalar(sdf)) == len(WORKERS)
        barrier = RList([barrier_addresses, r_int(RANK)],
                        ["address", "partition"])
        row = _scalar(interp.call_function(
            f, [(None, interp.value_promise(RList([]))),
                (None, interp.value_promise(barrier))],
            interp.global_env))
        # collect(): every partition's row, as the driver receives them.
        (out / f"row{{RANK}}.json").write_text(json.dumps(row))
        paths = [out / f"row{{i}}.json" for i in range(len(WORKERS))]
        deadline = time.monotonic() + 60
        while not all(p.exists() for p in paths):
            assert time.monotonic() < deadline, "a partition never ended"
            time.sleep(0.05)
        time.sleep(0.2)
        return RList([r_character(*[json.loads(p.read_text())
                                    for p in paths])], ["address"])

    interp.register_package("sparklyr", {{
        "spark_config": lambda: __import__("r_interp").REnv(),
        "spark_connect": lambda **kw: r_character("sc-token"),
        "sdf_len": lambda sc, n, **kw: r_int(int(_scalar(n))),
        "spark_apply": spark_apply,
        "collect": lambda x: x,
    }})
    # Only the barrier_cluster_spec line changes: the gang meets on the
    # launcher's free port (rank 0's port is base_port + 1).
    base_port = int(WORKERS[0].rsplit(":", 1)[1]) - 1
    call = "barrier_cluster_spec(barrier$address, barrier$partition)"
    assert text.count(call) == 1
    text = text.replace(
        call, "barrier_cluster_spec(barrier$address, barrier$partition, "
        f"base_port = {{base_port}}L)")
    interp.run_source(text)
    rows = interp.global_env.lookup("result").get("address").values
    tree, _ = dtt.checkpoint.import_hdf5("model.hdf5")
    rows = [len(rows[0]), rows[1:], sorted(tree)]
import torch.distributed as dist
dtt.launch.report_result({{"losses": LOSSES, "world": dist.get_world_size(),
                          "rows": rows}})
'''


def _ranks(flow, n, tmp_path):
    params = tmp_path / "start.npz"
    np.savez(params, **jax_start_params())
    out = tmp_path / "out"
    out.mkdir()
    source = WORKER.format(tests=str(REPO / "tests"))
    return run_ranks(n, tmp_path, source, flow, params, out,
                     timeout=240), out


def test_distributed_flow_on_two_ranks_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jrec = Recorder(monkeypatch, dtpu.Model)
    ref = r_interp.make_interp()
    ref.run_file(JAX_EXAMPLES / "distributed.R")
    assert (tmp_path / "trained.hdf5").exists()
    (tmp_path / "trained.hdf5").rename(tmp_path / "jax.hdf5")
    monkeypatch.delenv("DTPU_CONFIG", raising=False)

    rows, out = _ranks("distributed", 2, tmp_path)
    assert [rows[r]["world"] for r in (0, 1)] == [2, 2]
    assert rows[0]["losses"] == rows[1]["losses"]
    assert_losses_match(rows[0]["losses"][0], jrec.losses[0])
    # The chief exported the trained model; either package reads it.
    tree, _ = dtt.checkpoint.import_hdf5(str(out / "trained.hdf5"))
    jtree, _ = dtt.checkpoint.import_hdf5(str(tmp_path / "jax.hdf5"))
    assert sorted(tree) == sorted(jtree) == ["params"]
    flat = dtt.interop.flatten_tree(tree["params"])
    jflat = dtt.interop.flatten_tree(jtree["params"])
    assert sorted(flat) == sorted(jflat)
    for k in flat:
        np.testing.assert_allclose(flat[k], jflat[k], rtol=1e-4, atol=1e-6)


# ----------------------------------------------------- spark_barrier.R
def test_spark_barrier_flow_on_three_ranks_matches_jax(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    jrec = Recorder(monkeypatch, dtpu.Model)
    ref = r_interp.make_interp()
    ref.run_source("library(distributedtpu)")
    addresses = r_character("10.1.0.1:45001", "10.1.0.2:45002",
                            "10.1.0.3:45003")

    def spark_apply(sdf, f, **kw):
        rows = []
        for p in range(int(_scalar(sdf))):
            barrier = RList([addresses, r_int(p)], ["address", "partition"])
            rows.append(_scalar(ref.call_function(
                f, [(None, ref.value_promise(RList([]))),
                    (None, ref.value_promise(barrier))], ref.global_env)))
        return RList([r_character(*rows)], ["address"])

    ref.register_package("sparklyr", {
        "spark_config": lambda: r_interp.REnv(),
        "spark_connect": lambda **kw: r_character("sc-token"),
        "sdf_len": lambda sc, n, **kw: r_int(int(_scalar(n))),
        "spark_apply": spark_apply,
        "collect": lambda x: x,
    })
    ref.run_file(JAX_EXAMPLES / "spark_barrier.R")
    assert len(jrec.losses) == 3
    monkeypatch.delenv("DTPU_CONFIG", raising=False)

    rows, out = _ranks("spark_barrier", 3, tmp_path)
    assert [rows[r]["world"] for r in range(3)] == [3, 3, 3]
    for r in range(3):
        assert rows[r]["losses"] == rows[0]["losses"]
        b64_len, accuracies, tree_keys = rows[r]["rows"]
        assert b64_len > 1000 and tree_keys == ["params"]
        for acc in accuracies:
            assert 0.0 <= float(acc) <= 1.0, acc
    assert_losses_match(rows[0]["losses"][0], jrec.losses[0])
