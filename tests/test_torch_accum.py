"""Gradient clipping and accumulation in the port against the JAX package.

A small LM (vocab 97, 2 layers, d_model 32, 2 heads, T 16, the stock
sparse cross-entropy) on the same weights in both packages
(``tests/torch_parity.py``), fitted from the same shuffled batches:

- ``compile(grad_clip=c)`` (optax's ``clip_by_global_norm`` chained
  before the optimizer), with a clip that bites and one that does not;
- ``compile(gradient_accumulation_steps=N)`` (optax's ``MultiSteps``
  around the chain): the mean gradient of N fit steps, one update every
  N-th step;
- ``fit(grad_accum=M)``: M microbatches a step, their gradients summed
  in f32 and divided by M, one update; and the two together.

Tolerances, f32: per-step losses rtol 1e-5; with momentum SGD (which
turns no rounding noise into a full step, as Adam does near zero
gradients) every parameter within atol 1e-5 after the run, and the
optimizer states' leaves (optax's paths) within atol 1e-5. Tolerances,
not bit-equality: the two frameworks sum in different orders, and under
jax 0.9.0 the reference's own ZeRO x grad_accum bit-equality fails
(ROADMAP Queue 3). A checkpoint taken mid-accumulation resumes in the
other package, and ``set_learning_rate`` reaches through the wrappers.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.checkpoint import core as jckpt
from distributed_tpu.training import callbacks as jcb
from distributed_tpu_torch.training import callbacks as pcb

from torch_parity import lm_pair

torch.set_num_threads(1)

VOCAB, T = 97, 16
LOSS = "sparse_categorical_crossentropy"
OPT = {
    "sgd_momentum": ("SGD", dict(learning_rate=0.1, momentum=0.9)),
    "adam": ("Adam", dict(learning_rate=3e-3)),
}


def _data(n=24, seed=0):
    tok = np.random.default_rng(seed).integers(0, VOCAB, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _pair(opt, **compile_kw):
    jm, pm = lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                     max_len=T, seed=2)
    ctor, kw = OPT[opt]
    jm.compile(optimizer=getattr(dtpu.optim, ctor)(**kw), loss=LOSS,
               metrics=["accuracy"], **compile_kw)
    pm.compile(optimizer=getattr(dtt.optim, ctor)(**kw), loss=LOSS,
               metrics=["accuracy"], **compile_kw)
    return jm, pm


def _losses(cbs, model, steps, start=0, **fit_kw):
    """Per-step losses of ``steps`` fit steps (batch 4, shuffled)."""
    x, y = _data()
    seen = []
    rec = cbs.LambdaCallback(
        on_batch_end=lambda m, s, logs: seen.append(float(logs["loss"])))
    model.fit(x, y, batch_size=4, epochs=1, steps_per_epoch=steps, seed=1,
              verbose=0, callbacks=[rec], **fit_kw)
    return seen


def _assert_params_close(jm, pm, atol=1e-5):
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = dtt.interop.params_to_numpy(pm.params)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=atol,
                                   err_msg=path)


def _opt_flat(pm):
    return jckpt.flatten_tree(jax.tree_util.tree_map(
        np.asarray, dtt.interop.opt_state_to_tree(pm.tx, pm.opt_state,
                                                  pm.params),
        is_leaf=lambda a: isinstance(a, torch.Tensor)))


CASES = {
    "clip_bites": (dict(grad_clip=0.05), {}),
    "clip_idle": (dict(grad_clip=1e3), {}),
    "multisteps": (dict(gradient_accumulation_steps=3), {}),
    "multisteps_clip": (dict(gradient_accumulation_steps=2,
                             grad_clip=0.05), {}),
    "grad_accum_2": ({}, dict(grad_accum=2)),
    "grad_accum_4_clip": (dict(grad_clip=0.05), dict(grad_accum=4)),
    "both": (dict(gradient_accumulation_steps=2), dict(grad_accum=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_params_match_jax(case):
    compile_kw, fit_kw = CASES[case]
    jm, pm = _pair("sgd_momentum", **compile_kw)
    want = _losses(jcb, jm, 6, **fit_kw)
    got = _losses(pcb, pm, 6, **fit_kw)
    assert pm.step == jm.step == 6
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(jm, pm)
    want_opt = jckpt.flatten_tree(jax.device_get(jm.opt_state))
    got_opt = {k: np.asarray(v) for k, v in _opt_flat(pm).items()}
    assert set(got_opt) == set(want_opt)
    for path, a in want_opt.items():
        assert got_opt[path].dtype == np.asarray(a).dtype, path
        np.testing.assert_allclose(got_opt[path], a, rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("case", ["multisteps_clip", "grad_accum_4_clip"])
def test_adam_losses_match_jax(case):
    compile_kw, fit_kw = CASES[case]
    jm, pm = _pair("adam", **compile_kw)
    np.testing.assert_allclose(_losses(pcb, pm, 6, **fit_kw),
                               _losses(jcb, jm, 6, **fit_kw), rtol=1e-5)


def test_grad_accum_equals_the_whole_batch():
    """M microbatches give the update of the whole batch: losses within
    f32 summation order (rtol 1e-6) and parameters within 1e-6."""
    _, a = _pair("sgd_momentum")
    _, b = _pair("sgd_momentum")
    la, lb = _losses(pcb, a, 4), _losses(pcb, b, 4, grad_accum=4)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    for path, p in a.params.items():
        torch.testing.assert_close(b.params[path], p, rtol=0, atol=1e-6)


def test_clip_matches_optax():
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((7, 5), (5,), (3, 2, 4))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        got = dtt.optim.clip_by_global_norm(max_norm)(
            [torch.from_numpy(g) for g in grads])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_multisteps_state_and_validation():
    _, pm = _pair("sgd_momentum", gradient_accumulation_steps=3)
    assert isinstance(pm.tx, dtt.optim.MultiSteps)
    _losses(pcb, pm, 4)
    assert pm.opt_state["mini_step"] == 1
    assert pm.opt_state["gradient_step"] == 1
    for bad in (dict(gradient_accumulation_steps=0),
                dict(gradient_accumulation_steps=1.5), dict(grad_clip=0.0)):
        with pytest.raises(ValueError):
            pm.compile(optimizer="sgd", **bad)
    pm.compile(optimizer="sgd", gradient_accumulation_steps=1)
    assert isinstance(pm.tx, dtt.optim.SGD)  # N = 1 wraps nothing
    with pytest.raises(ValueError, match="grad_accum"):
        _losses(pcb, pm, 1, grad_accum=3)  # 3 does not divide 4 rows
    with pytest.raises(ValueError, match="grad_accum"):
        _losses(pcb, pm, 1, grad_accum=0)


def test_set_learning_rate_reaches_through_the_wrappers():
    kw = dict(gradient_accumulation_steps=2, grad_clip=0.05)
    jm, pm = _pair("adam", **kw)
    first = [_losses(c, m, 2) for c, m in ((jcb, jm), (pcb, pm))]
    for m in (jm, pm):
        m.set_learning_rate(0.02)
        assert m.get_learning_rate() == np.float32(0.02)
    second = [_losses(c, m, 4) for c, m in ((jcb, jm), (pcb, pm))]
    np.testing.assert_allclose(first[1], first[0], rtol=1e-5)
    np.testing.assert_allclose(second[1], second[0], rtol=1e-5)
    assert dtt.optim.get_hyperparam(pm.opt_state, "b1") == np.float32(0.9)
    with pytest.raises(KeyError, match="momentum"):
        dtt.optim.get_hyperparam(pm.opt_state, "momentum")


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_mid_accumulation_resumes_across_packages(tmp_path,
                                                             saver):
    """4 fit steps under accumulation over 3 (one update, one gradient
    waiting in the accumulator), saved by one package and restored by
    the other; both continue 5 steps and agree with the saver's own
    continuation."""
    kw = dict(gradient_accumulation_steps=3, grad_clip=0.05)
    jm, pm = _pair("sgd_momentum", **kw)
    src, dst = (jm, pm) if saver == "jax" else (pm, jm)
    src_cb, dst_cb = (jcb, pcb) if saver == "jax" else (pcb, jcb)
    dst_ck = dtt.Checkpointer if saver == "jax" else dtpu.Checkpointer
    src_ck = dtpu.Checkpointer if saver == "jax" else dtt.Checkpointer
    _losses(src_cb, src, 4)
    src_ck(tmp_path).save(src)
    want = _losses(src_cb, src, 5)
    assert dst_ck(tmp_path).restore_into(dst) == 4
    got = _losses(dst_cb, dst, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if saver == "jax":
        assert pm.opt_state["mini_step"] == 0  # 9 steps: 3 updates
        assert pm.opt_state["gradient_step"] == 3


DP_WORKER = '''
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.utils import sync_check

spec = dtt.cluster.initialize(device="cpu", timeout=60)
data = np.load(sys.argv[1])
strategy = dtt.DataParallel(device="cpu")
reduces = []
reduce = strategy.reduce_gradients
strategy.reduce_gradients = lambda g: reduces.append(1) or reduce(g)
with strategy.scope():
    model = dtt.Model(dtt.models.mnist_cnn())
    model.compile(optimizer=dtt.optim.SGD(0.01),
                  loss="sparse_categorical_crossentropy",
                  steps_per_execution=2)
model.build((28, 28, 1))
model.load_params({k[2:]: torch.from_numpy(data[k]) for k in data.files
                   if k.startswith("p:")})
hist = model.fit(data["x"], data["y"], batch_size=32, epochs=2,
                 steps_per_epoch=2, seed=0, verbose=0, grad_accum=2)
sync_check.assert_replicas_identical(model.params)
if spec.is_chief:
    np.savez(sys.argv[2], **dtt.interop.params_to_numpy(model.params))
dtt.launch.report_result({"history": hist.history, "reduces": len(reduces)})
dtt.cluster.shutdown()
'''


def test_two_ranks_accumulate_and_reduce_once_per_update(tmp_path):
    """mnist_cnn over 2 gloo ranks, SGD(0.01) as ``test_torch_dp.py``
    trains it, grad_accum=2 at K=2 (the rows of each microbatch split over
    the ranks, as JAX shards them), against the JAX package's
    DataParallel over 2 devices: losses rtol 1e-5, parameters atol 1e-5,
    and one gradient reduce per update."""
    import sys
    from pathlib import Path

    x, y = dtt.data.synthetic_images(128, (28, 28), 10, 1)
    x = x[..., None].astype(np.float32) / 255.0
    with dtpu.DataParallel(jax.devices()[:2]).scope():
        jm = dtpu.Model(dtpu.models.mnist_cnn())
        jm.compile(optimizer=dtpu.optim.SGD(0.01),
                   loss="sparse_categorical_crossentropy",
                   steps_per_execution=2)
    jm.build((28, 28, 1), seed=0)
    start = dtt.interop.flatten_tree(jax.device_get(jm.params))
    np.savez(tmp_path / "in.npz", x=x, y=y,
             **{f"p:{k}": v for k, v in start.items()})
    (tmp_path / "worker.py").write_text(DP_WORKER)
    root = Path(__file__).resolve().parents[1]
    rows = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": str(root)}).run(
        [sys.executable, str(tmp_path / "worker.py"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")], 2, timeout=120)
    for r in rows:
        assert r.ok, f"worker {r.index}: {r.error}\n{r.log_tail}"
    want = jm.fit(x, y, batch_size=32, epochs=2, steps_per_epoch=2, seed=0,
                  verbose=0, grad_accum=2).history
    for r in rows:
        assert r.value["reduces"] == 4  # 2 epochs x 2 updates
        np.testing.assert_allclose(r.value["history"]["loss"], want["loss"],
                                   rtol=1e-5)
    jax_params = dtt.interop.flatten_tree(jax.device_get(jm.params))
    with np.load(tmp_path / "out.npz") as got:
        for path in jax_params:
            np.testing.assert_allclose(got[path], jax_params[path], rtol=0,
                                       atol=1e-5, err_msg=path)
