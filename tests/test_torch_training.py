"""The port's trainer against the JAX package's, on the same weights.

A small LM (vocab 512, 2 layers, d_model 128, 4 heads, T 64, flash
attention) is compiled in both packages with ``Adam(1e-3)``, the pallas
loss and accuracy, and fitted for 3 steps on the same numpy batches
(``shuffle=True, seed=0``: the port copies the JAX batch order). The JAX
side runs its Pallas kernels in interpret mode; the port runs its kernels'
plain versions (CPU tensors).

Tolerances, f32: per-step losses rtol 1e-5. Parameters atol 1e-5 on every
entry whose gradient was at least 1e-7 (ten times Adam's eps) in all three
steps. Below that Adam's update ``lr * g / (|g| + eps)`` turns rounding
noise of the gradient into a step of up to ``lr``: the attention key bias
``bk`` has an exactly zero gradient in exact arithmetic (softmax ignores a
per-row shift), and a few matrix entries cross zero by chance. Those
entries are held to Adam's own bound, ``3 * lr`` after three steps.
bf16 layers: per-step losses rtol 2e-3 (logits round to bf16 at slightly
different values; the loss averages 128 tokens of them).
"""

import jax
import numpy as np
import optax
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import lm_pair

torch.set_num_threads(1)

VOCAB, T, LR, STEPS = 512, 64, 1e-3, 3
PALLAS = "pallas_sparse_categorical_crossentropy"


def _data(seed=0, n=6):
    tok = np.random.default_rng(seed).integers(0, VOCAB, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _compile(jm, pm):
    jm.compile(optimizer=dtpu.optim.Adam(LR), loss=PALLAS,
               metrics=["accuracy"])
    pm.compile(optimizer=dtt.optim.Adam(LR), loss=PALLAS,
               metrics=["accuracy"])


def _record_grads(pm):
    """Wrap the port's optimizer so each step's |gradient| is kept."""
    seen, update = [], pm.tx.update

    def rec(params, grads, state):
        seen.append([g.detach().abs().clone() for g in grads])
        return update(params, grads, state)

    pm.tx.update = rec
    return seen


def _fit(m, x, y):
    return m.fit(x, y, batch_size=2, epochs=STEPS, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0).history


@pytest.fixture(scope="module")
def trained():
    """{dtype: (jax model, port model, jax history, port history, grads)}
    after 3 steps; built once, shared by the tests below."""
    out = {}
    x, y = _data()
    for dtype in (None, "bfloat16"):
        jm, pm = lm_pair(vocab=VOCAB, num_layers=2, d_model=128, num_heads=4,
                         max_len=T, dtype=dtype, flash=True)
        _compile(jm, pm)
        seen = _record_grads(pm)
        out[dtype] = (jm, pm, _fit(jm, x, y), _fit(pm, x, y), seen)
    return out


@pytest.mark.parametrize("dtype,rtol", [(None, 1e-5), ("bfloat16", 2e-3)])
def test_fit_losses_match_jax_per_step(trained, dtype, rtol):
    _, pm, hj, hp, _ = trained[dtype]
    assert len(hp["loss"]) == STEPS and pm.step == STEPS
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=rtol)
    np.testing.assert_allclose(hp["accuracy"], hj["accuracy"], atol=1 / 128)


def test_fit_params_match_jax_after_three_steps(trained):
    jm, pm, _, _, seen = trained[None]
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = dtt.interop.params_to_numpy(pm.params)
    assert set(got) == set(want)
    names = list(pm.params)
    strict_entries = 0
    for i, path in enumerate(names):
        gmin = torch.stack([step[i] for step in seen]).amin(0).numpy()
        strict = gmin >= 1e-7
        diff = np.abs(got[path] - want[path])
        assert diff[strict].max(initial=0.0) <= 1e-5, path
        assert diff.max() <= STEPS * LR, path
        strict_entries += int(strict.sum())
    # The strict check covers most of the model: all but the embedding
    # rows of tokens absent from the batches (zero gradient, untouched in
    # both), the key biases and a few entries near zero.
    assert strict_entries > 0.8 * sum(v.size for v in got.values())


def test_evaluate_matches_jax(trained):
    jm, pm, _, _, _ = trained[None]
    x, y = _data(seed=1, n=5)  # 5 rows, batch 2: a partial last batch
    want = jm.evaluate(x, y, batch_size=2, verbose=0)
    got = pm.evaluate(x, y, batch_size=2, verbose=0)
    assert set(got) == set(want) == {"loss", "accuracy"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                               atol=1 / (5 * T))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_update_matches_optax(name):
    """Three updates of random trees, with the learning rate changed
    between them as set_learning_rate does, against optax's own."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -e
              for s, e in zip(shapes, (0, 3, 6))] for _ in range(3)]
    ctor = {"adam": (dtpu.optim.Adam, dtt.optim.Adam),
            "sgd": (dtpu.optim.SGD, dtt.optim.SGD)}[name]
    tx, opt = ctor[0](1e-3), ctor[1](1e-3)
    jp = [jax.numpy.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        if step == 2:
            js = dtpu.optim.set_hyperparam(js, "learning_rate", 3e-4)
            dtt.optim.set_hyperparam(ts, "learning_rate", 3e-4)
        upd, js = tx.update([jax.numpy.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    assert dtt.optim.get_hyperparam(ts, "learning_rate") == pytest.approx(
        float(dtpu.optim.get_hyperparam(js, "learning_rate")))


def test_learning_rate_is_mutable_and_f32():
    pm = dtt.Model(dtt.models.transformer_lm(16, num_layers=1, d_model=16,
                                             num_heads=2, max_len=8),
                   device="cpu")
    pm.compile(optimizer="adam", learning_rate=0.01, loss=PALLAS)
    with pytest.raises(RuntimeError, match="compile"):
        pm.get_learning_rate()
    pm.build((8,))
    assert pm.get_learning_rate() == np.float32(0.01)
    pm.set_learning_rate(0.1)
    assert pm.get_learning_rate() == np.float32(0.1)


@pytest.mark.parametrize("option", [
    "grad_clip", "gradient_accumulation_steps", "head_chunks",
    "steps_per_execution", "precision", "strategy", "hbm_cap_bytes",
    "measure", "auto_options"])
def test_unported_compile_options_raise(option):
    """Every compile option of the JAX package is ported now and
    compiles: clipping, accumulation, multi-step execution, the chunked
    head, the precision policies and the auto-shard planner's
    (``strategy="auto"`` keeps a plan for build; ``hbm_cap_bytes``,
    ``measure`` and ``auto_options`` without it are ignored, as in
    JAX)."""
    pm = dtt.Model(dtt.models.transformer_lm(16, num_layers=1, d_model=16,
                                             num_heads=2, max_len=8),
                   device="cpu")
    value = {"precision": "mixed_bfloat16", "strategy": "auto",
             "measure": True, "auto_options": {"batch_size": 8}}.get(option, 2)
    pm.compile(optimizer="adam", **{option: value})
    assert pm.compiled
    assert (pm._auto_shard is not None) == (option == "strategy")


def test_unported_fit_options_raise():
    """fit before compile raises; the fit options that were unported
    (grad_accum, an iterator, prefetch) are ported now: a plain iterator
    needs steps_per_epoch, as in JAX."""
    pm = dtt.Model(dtt.models.transformer_lm(16, num_layers=1, d_model=16,
                                             num_heads=2, max_len=8),
                   device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        pm.fit(np.zeros((2, 8), np.int32), np.zeros((2, 8), np.int32))
    pm.compile(optimizer="adam")
    x = y = np.zeros((2, 8), np.int32)
    pm.fit(x, y, batch_size=2, verbose=0, grad_accum=2)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        pm.fit(iter([(x, y)]))
    pm.fit(iter([(x, y)]), steps_per_epoch=1, verbose=0)
    pm.fit(x, y, batch_size=2, verbose=0, prefetch=2)
    assert pm.step == 3
