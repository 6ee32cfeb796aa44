"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Build a model in the JAX package, carry its parameters into the port
(``interop.params_from_jax``), and run both on the same seeded numpy
inputs. JAX stays on the CPU (conftest), the port runs with
``device="cpu"``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt


def jax_model(module, input_shape, seed=0):
    """A built (and compiled, as the JAX Engine expects) JAX Model."""
    model = dtpu.Model(module)
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    model.build(input_shape, seed=seed)
    return model


def port_model(module, input_shape, jax_params):
    """The port's Model of ``module`` on the CPU, holding ``jax_params``."""
    model = dtt.Model(module, device="cpu").build(input_shape)
    model.load_params(dtt.interop.params_from_jax(jax.device_get(jax_params)))
    return model


def lm_pair(vocab=64, num_layers=2, d_model=32, num_heads=2, max_len=64,
            dtype=None, seed=0, **lm_kw):
    """The same transformer_lm in both packages, on the same weights.
    ``dtype``: None (f32) or "bfloat16"; ``lm_kw`` (e.g. ``flash=True``)
    go to both constructors."""
    kw = dict(num_layers=num_layers, d_model=d_model, num_heads=num_heads,
              max_len=max_len, **lm_kw)
    jm = jax_model(dtpu.models.transformer_lm(
        vocab, dtype=None if dtype is None else jax.numpy.dtype(dtype), **kw),
        (16,), seed=seed)
    pm = port_model(dtt.models.transformer_lm(vocab, dtype=dtype, **kw),
                    (16,), jm.params)
    return jm, pm


def _with_table_copy(fn, *args):
    args = list(args)
    args[4] = np.array(args[4])  # the block-table row, copied
    return fn(*args)


def jax_engine(model, **kw):
    """A JAX ``serving.Engine`` whose prefill dispatches (target and draft)
    get a copy of their block-table row. The JAX engine passes them a view
    of its host table and grows the table (``reserve``) right after the
    asynchronous dispatch, which on the CPU may read the row later: under
    load, padded prefill rows then land in newly reserved blocks, where a
    speculative draft can read them (ROADMAP Queue 3), so its acceptance
    counts vary from run to run (its tokens never do). The copy is the
    table the engine means to pass."""
    from distributed_tpu.serving import Engine

    engine = Engine(model, **kw)
    for name in ("_prefill_fn", "_draft_prefill_fn"):
        fn = getattr(engine, name, None)
        if fn is not None:
            setattr(engine, name, functools.partial(_with_table_copy, fn))
    return engine


class FixedClock:
    """``time`` as the fleet modules see it (``fleet.replica``,
    ``fleet.core`` of either package): each ``perf_counter`` call advances
    10 ms, so every timed dispatch costs exactly that and the virtual
    clock's schedule no longer depends on the host."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


@pytest.fixture(autouse=True)
def no_cluster_env(monkeypatch):
    """No cluster spec in the environment: the port stamps events, flight
    records and buddy mirrors with the rank and world of a live group,
    else of ``DTPU_CONFIG``/``TF_CONFIG``, while the JAX side reads its
    process count. A spec another test in the same worker process left in
    ``os.environ`` would stamp the port's rows with that world. Autouse in
    each module that imports it."""
    for var in ("DTPU_CONFIG", "TF_CONFIG"):
        monkeypatch.delenv(var, raising=False)


def as_np(x):
    """A JAX array or torch tensor as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


# ------------------------------------------------- n gloo ranks on the CPU
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]

# Shared top of the two-rank worker scripts of the sharded-strategy tests:
# a gloo group from the launcher's DTPU_CONFIG, the npz of inputs (mnist
# images "x"/"y", LM tokens "tx"/"ty", JAX-built parameters under "m:" for
# mnist_cnn and "l:" for the LM), and the helpers the checks share.
WORKER_PRELUDE = '''
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import distributed_tpu_torch as dtt

spec = dtt.cluster.initialize(device="cpu", timeout=60)
data = np.load(sys.argv[1])
X, Y, TX, TY = data["x"], data["y"], data["tx"], data["ty"]
PARAMS = {"mnist": {k[2:]: data[k] for k in data.files if k[:2] == "m:"},
          "lm": {k[2:]: data[k] for k in data.files if k[:2] == "l:"}}
FIT = {"mnist": (X, Y, dict(batch_size=64, epochs=3, steps_per_epoch=1,
                            shuffle=True, seed=0, verbose=0)),
       "lm": (TX, TY, dict(batch_size=8, epochs=3, steps_per_epoch=1,
                           shuffle=True, seed=0, verbose=0))}
LOSS = "sparse_categorical_crossentropy"


def lm(**kw):
    return dtt.models.transformer_lm(32, num_layers=2, d_model=32,
                                     num_heads=2, max_len=16, **kw)


def build(strategy, kind, opt, module=None, **compile_kw):
    """A model of ``kind`` under ``strategy``, compiled with ``opt``,
    holding the JAX-built parameters (``module``: another module of that
    input, built from seed 0)."""
    with strategy.scope():
        m = dtt.Model(module if module is not None else
                      dtt.models.mnist_cnn() if kind == "mnist" else lm())
        m.compile(optimizer=opt, loss=LOSS, metrics=[], **compile_kw)
    m.build((28, 28, 1) if kind == "mnist" else (16,))
    if module is None:
        dtt.interop.place(m, params=PARAMS[kind])
    return m


def fit(m, kind, **kw):
    x, y, f = FIT[kind]
    return [float(v) for v in m.fit(x, y, **dict(f, **kw)).history["loss"]]


def full(m):
    return {k: v.clone() for k, v in m.params.items()}


def same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def max_excess(a, b, rtol):
    """The largest ``|a - b| - rtol * |b|`` over every entry: at most the
    absolute floor of an ``allclose(a, b, rtol, atol)``."""
    return max(float(((a[k] - b[k]).abs() - rtol * b[k].abs()).max()
                     .detach()) for k in a)


def local_shapes(m):
    """{path: shape} of what this rank holds: each parameter, and each
    optimizer leaf under optax's paths."""
    out = {"params/" + k: list(v.shape) for k, v in m.live_params().items()}
    tree = dtt.interop.opt_state_to_tree(m.tx, m.opt_state, m.live_params())
    for k, v in dtt.interop.iter_leaf_paths(tree):
        out["opt_state/" + k] = list(np.shape(v))
    return out


def opts():
    return {"sgd_momentum": lambda: dtt.optim.SGD(0.05, momentum=0.9),
            "adam": lambda: dtt.optim.Adam(1e-3),
            "adamw": lambda: dtt.optim.AdamW(1e-3, weight_decay=0.01),
            "fused_adamw": lambda: dtt.optim.fused_adamw(1e-3)}
'''


def lm_tokens(n=32, seq=16, vocab=32, seed=3):
    """(x, y) int32 next-token pairs from a numpy seed."""
    tok = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def mnist_data(n=256):
    x, y = dtt.data.synthetic_images(n, (28, 28), 10, 0)
    return x[..., None].astype(np.float32) / 255.0, y.astype(np.int32)


def run_ranks(n, tmp, source, *args, timeout=120):
    """Run the worker script ``source`` on ``n`` ranks through the port's
    launcher; returns ``{rank: reported value}``."""
    import sys

    script = tmp / "worker.py"
    script.write_text(source)
    launcher = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": str(ROOT)})
    rows = launcher.run([sys.executable, str(script), *map(str, args)], n,
                        timeout=timeout)
    for r in rows:
        assert r.ok, f"worker {r.index}: {r.error}\n{r.log_tail}"
    return {r.index: r.value for r in rows}


def run_pair(tmp, source, *args, timeout=120):
    """:func:`run_ranks` on 2 ranks."""
    return run_ranks(2, tmp, source, *args, timeout=timeout)


def shard_shapes(tree, prefix):
    """{path: shape of device 0's shard} of a JAX tree of arrays, under
    the port's flat paths."""
    shapes = jax.tree_util.tree_map(
        lambda a: np.empty(a.addressable_shards[0].data.shape
                           if hasattr(a, "addressable_shards")
                           else np.shape(a), np.int8), tree)
    return {f"{prefix}/{k}": list(v.shape)
            for k, v in dtt.interop.flatten_tree(shapes).items()}
