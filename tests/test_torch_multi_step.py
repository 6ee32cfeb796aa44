"""``compile(steps_per_execution=K)`` in the port against K = 1 and the
JAX package.

The small LM of ``test_torch_accum.py`` (vocab 97, 2 layers, d_model 32,
T 16, momentum SGD) fitted 2 epochs of 5 steps from the same shuffled
batches, so every epoch ends in a shorter tail dispatch ([2, 2, 1] at
K = 2, [4, 1] at K = 4). On the CPU the K steps of a dispatch run
eagerly (the card replays a CUDA graph per step: ``tests/
test_torch_cuda.py``).

- K against K = 1 in the port: the same parameters, bit for bit (the
  same steps in the same order), and the per-epoch means at rtol 1e-6
  (K = 1 averages the steps' losses, K sums the dispatches' sums).
- K against the JAX package at the same K: epoch losses rtol 1e-5,
  parameters atol 1e-5.
- Callbacks: ``on_batch_end`` fires once a dispatch with ``model.step``
  at its end and the dispatch's mean loss, in both packages alike.
- K composes with ``fit(grad_accum=M)`` and with
  ``compile(gradient_accumulation_steps=N)``.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.training import callbacks as jcb
from distributed_tpu_torch.training import callbacks as pcb

from torch_parity import lm_pair

torch.set_num_threads(1)

VOCAB, T = 97, 16
LOSS = "sparse_categorical_crossentropy"


def _data(n=24, seed=0):
    tok = np.random.default_rng(seed).integers(0, VOCAB, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _pair(**compile_kw):
    jm, pm = lm_pair(vocab=VOCAB, num_layers=2, d_model=32, num_heads=2,
                     max_len=T, seed=5)
    for pkg, m in ((dtpu, jm), (dtt, pm)):
        m.compile(optimizer=pkg.optim.SGD(0.1, momentum=0.9), loss=LOSS,
                  metrics=["accuracy"], **compile_kw)
    return jm, pm


def _fit(cbs, model, **fit_kw):
    """(history, [(step, loss) per on_batch_end])."""
    x, y = _data()
    seen = []
    rec = cbs.LambdaCallback(on_batch_end=lambda m, s, logs: seen.append(
        (s, float(logs["loss"]))))
    hist = model.fit(x, y, batch_size=4, epochs=2, steps_per_epoch=5,
                     seed=3, verbose=0, callbacks=[rec], **fit_kw)
    return hist.history, seen


def _params(pm):
    return dtt.interop.params_to_numpy(pm.params)


@pytest.mark.parametrize("k", [2, 4])
def test_k_steps_equal_one_step_at_a_time(k):
    _, one = _pair()
    _, many = _pair(steps_per_execution=k)
    h1, seen1 = _fit(pcb, one)
    hk, seenk = _fit(pcb, many)
    # The same steps; the epoch means sum K-step sums in another order.
    for key in h1:
        np.testing.assert_allclose(hk[key], h1[key], rtol=1e-6)
    for path, p in _params(one).items():
        np.testing.assert_array_equal(_params(many)[path], p, err_msg=path)
    # One callback a dispatch, at its last step, with its mean loss.
    sizes = {2: [2, 2, 1], 4: [4, 1]}[k] * 2
    assert [s for s, _ in seenk] == list(np.cumsum(sizes))
    losses = [l for _, l in seen1]
    start = 0
    for (_, mean), size in zip(seenk, sizes):
        np.testing.assert_allclose(
            mean, np.mean(np.float32(losses[start:start + size])), rtol=1e-6)
        start += size


@pytest.mark.parametrize("k", [2, 4])
def test_k_steps_match_jax(k):
    jm, pm = _pair(steps_per_execution=k)
    hj, seen_j = _fit(jcb, jm)
    hp, seen_p = _fit(pcb, pm)
    assert [s for s, _ in seen_p] == [s for s, _ in seen_j]
    np.testing.assert_allclose([l for _, l in seen_p],
                               [l for _, l in seen_j], rtol=1e-5)
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    np.testing.assert_allclose(hp["accuracy"], hj["accuracy"], atol=1 / 64)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    for path, p in _params(pm).items():
        np.testing.assert_allclose(p, want[path], rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("fit_kw,compile_kw", [
    (dict(grad_accum=2), {}),
    ({}, dict(gradient_accumulation_steps=3)),
], ids=["grad_accum", "gradient_accumulation_steps"])
def test_k_composes_with_accumulation(fit_kw, compile_kw):
    _, one = _pair(**compile_kw)
    jm, many = _pair(steps_per_execution=2, **compile_kw)
    h1, _ = _fit(pcb, one, **fit_kw)
    hk, _ = _fit(pcb, many, **fit_kw)
    hj, _ = _fit(jcb, jm, **fit_kw)
    np.testing.assert_allclose(hk["loss"], h1["loss"], rtol=1e-6)
    np.testing.assert_allclose(hk["loss"], hj["loss"], rtol=1e-5)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    for path, p in _params(many).items():
        np.testing.assert_array_equal(p, _params(one)[path])
        np.testing.assert_allclose(p, want[path], rtol=0, atol=1e-5,
                                   err_msg=path)


def test_k_steps_stop_at_a_dispatch_boundary():
    """A callback that stops training ends the run after the dispatch it
    fired in: model.step is that dispatch's end."""
    _, pm = _pair(steps_per_execution=4)
    x, y = _data()
    stop = pcb.LambdaCallback(on_batch_end=lambda m, s, logs: setattr(
        m, "stop_training", True))
    hist = pm.fit(x, y, batch_size=4, epochs=3, steps_per_epoch=5, verbose=0,
                  callbacks=[stop])
    assert pm.step == 4 and len(hist.history["loss"]) == 1


def test_steps_per_execution_is_validated():
    _, pm = _pair()
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="steps_per_execution"):
            pm.compile(optimizer="sgd", steps_per_execution=bad)
