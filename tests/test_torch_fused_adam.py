"""The fused Adam/AdamW update (K11) and the optimizers around it.

``ops.fused_update.adam_update_ref``, the kernel's plain version (what
CPU tensors run), is held to the JAX package's ``optim.fused_adam`` and
``fused_adamw`` (the Pallas kernel in interpret mode, as
``tests/test_fused_update.py`` runs it) on a small LM's parameter tree over
three updates with the learning rate changed between them; the port's
``fused_adam`` is held to its ``Adam`` and ``fused_adamw`` to its
``AdamW`` bit for bit; ``AdamW`` and momentum/Nesterov ``SGD`` to optax;
and three ``fit`` steps of a small LM with ``"fused_adamw"`` to JAX.

Tolerances, f32. Against the JAX kernel: the same operations, but the
interpret-mode Pallas kernel rounds some products and sums a last bit
apart from the port's walk (which matches stock optax more closely), and
Adam passes that on: moments cancel over steps of random sign, and the
normalised step turns their last-bit differences into differences of the
step. So parameters are held to rtol 1e-6 plus 1e-5 of the summed
learning rates, the moments to rtol 1e-6 plus 1e-6 of the largest
gradient (first moment) or its square (second): a wrong term of the
update (eps, the decay, a bias correction) moves them by orders more.
Against optax: rtol 1e-6. The fit: losses rtol 1e-5; parameters atol
1e-5 where every step's gradient is at least 1e-7, else Adam's own bound
(``3 * lr`` after three steps: ``lr * g / (|g| + eps)`` turns rounding
noise of a gradient into a step of up to ``lr``).
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

LR = 1e-3


def _lm_tree():
    """The small LM's JAX parameter tree and its flat numpy leaves."""
    jm, _ = lm_pair(vocab=64, num_layers=2, d_model=32, num_heads=2,
                    max_len=16)
    params = jax.device_get(jm.params)
    return params, dtt.interop.flatten_tree(params)


def _grads(flat, step):
    """Seeded gradients: most leaves at scale 1e-2, every third at 1e-5."""
    rng = np.random.default_rng(100 + step)
    return {path: (rng.standard_normal(v.shape) * (1e-5 if i % 3 == 2
                                                   else 1e-2)).astype(np.float32)
            for i, (path, v) in enumerate(sorted(flat.items()))}


@pytest.mark.parametrize("name", ["fused_adam", "fused_adamw"])
def test_plain_version_matches_jax_fused_kernel(name):
    params, flat = _lm_tree()
    paths = sorted(flat)
    tx = getattr(dtpu.optim, name)(LR)
    jstate = tx.init(params)
    jp = params
    opt = getattr(dtt.optim, name)(LR)
    tp = [torch.from_numpy(flat[p].copy()) for p in paths]
    tstate = opt.init(tp)
    for step in range(3):
        if step == 2:
            jstate = dtpu.optim.set_hyperparam(jstate, "learning_rate", 3e-4)
            dtt.optim.set_hyperparam(tstate, "learning_rate", 3e-4)
        g = _grads(flat, step)
        gtree = jax.tree_util.tree_unflatten(  # leaves in JAX tree order
            jax.tree_util.tree_structure(params),
            [g[p] for p, _ in dtt.interop.iter_leaf_paths(params)])
        upd, jstate = tx.update(gtree, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(g[p]) for p in paths], tstate)
    inner = jstate.inner_state
    gmax = max(float(np.abs(v).max()) for v in _grads(flat, 0).values())
    for slot, got, ref, atol in (
            ("param", tp, jp, 1e-5 * (LR + LR + 3e-4)),
            ("mu", tstate["mu"], inner.mu, 1e-6 * gmax),
            ("nu", tstate["nu"], inner.nu, 1e-6 * gmax ** 2)):
        want = dtt.interop.flatten_tree(jax.device_get(ref))
        for i, path in enumerate(paths):
            np.testing.assert_allclose(got[i].numpy(), want[path], rtol=1e-6,
                                       atol=atol, err_msg=f"{slot} {path}")
    assert tstate["count"] == int(inner.count) == 3


def _updated(opt, steps=3):
    rng = np.random.default_rng(7)
    shapes = [(7, 5), (11,), (3, 4, 2), (1,)]
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes]
    state = opt.init(params)
    for step in range(steps):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * 10.0 ** -(2 * k)) for k, s in enumerate(shapes)]
        opt.update(params, grads, state)
    return params + state["mu"] + state["nu"]


@pytest.mark.parametrize("plain,fused", [("adam", "fused_adam"),
                                         ("adamw", "fused_adamw")])
def test_fused_optimizers_equal_their_plain_twins_bit_for_bit(plain, fused):
    for a, b in zip(_updated(dtt.optim.get(plain, learning_rate=1e-2)),
                    _updated(dtt.optim.get(fused, learning_rate=1e-2))):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name,kw", [
    ("AdamW", {}), ("AdamW", {"weight_decay": 0.1}),
    ("SGD", {"momentum": 0.9}), ("SGD", {"momentum": 0.9, "nesterov": True})])
def test_optimizer_update_matches_optax(name, kw):
    """Three updates of random trees, with the learning rate changed
    between them, against the JAX package's optimizer of the same name."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -e
              for s, e in zip(shapes, (0, 3, 6))] for _ in range(3)]
    tx, opt = getattr(dtpu.optim, name)(1e-3, **kw), getattr(dtt.optim, name)(
        1e-3, **kw)
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
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_registry_names_and_learning_rate_on_the_fused_state():
    for name, cls in (("adamw", dtt.optim.AdamW),
                      ("fused_adam", dtt.optim.fused_adam),
                      ("fused_adamw", dtt.optim.fused_adamw)):
        assert type(dtt.optim.get(name)) is cls
        assert dtt.optim.get(name).name == name
    assert dtt.optim.get("fused_adamw").hyperparams["weight_decay"] == 0.01
    pm = dtt.Model(dtt.models.mnist_cnn(), device="cpu")
    pm.compile(optimizer="fused_adamw", learning_rate=0.01, weight_decay=0.1)
    pm.build((28, 28, 1))
    assert pm.get_learning_rate() == np.float32(0.01)
    pm.set_learning_rate(0.1)
    assert pm.get_learning_rate() == np.float32(0.1)
    assert pm.opt_state["hyperparams"]["weight_decay"].dtype == torch.float32
    with pytest.raises(ValueError, match="Unknown optimizer"):
        dtt.optim.get("fused_lamb")


def test_sgd_without_momentum_keeps_no_trace():
    opt = dtt.optim.SGD(0.1)
    state = opt.init([torch.zeros(3)])
    assert "trace" not in state and set(state["hyperparams"]) == {
        "learning_rate"}
    state = dtt.optim.SGD(0.1, momentum=0.5).init([torch.zeros(3)])
    assert len(state["trace"]) == 1


def test_fit_with_fused_adamw_matches_jax():
    vocab, t = 128, 32
    tok = np.random.default_rng(0).integers(0, vocab, (6, t + 1))
    x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
    jm, pm = lm_pair(vocab=vocab, num_layers=2, d_model=64, num_heads=4,
                     max_len=t)
    for m in (jm, pm):
        m.compile(optimizer="fused_adamw", learning_rate=LR,
                  loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    seen, update = [], pm.tx.update

    def record(params, grads, state):
        seen.append([g.detach().abs().clone() for g in grads])
        return update(params, grads, state)

    pm.tx.update = record
    kw = dict(batch_size=2, epochs=3, steps_per_epoch=1, shuffle=True, seed=0,
              verbose=0)
    hj, hp = jm.fit(x, y, **kw).history, pm.fit(x, y, **kw).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = dtt.interop.params_to_numpy(pm.params)
    for i, path in enumerate(pm.params):
        gmin = torch.stack([step[i] for step in seen]).amin(0).numpy()
        diff = np.abs(got[path] - want[path])
        assert diff[gmin >= 1e-7].max(initial=0.0) <= 1e-5, path
        assert diff.max() <= 3 * LR, path
