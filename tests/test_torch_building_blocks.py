"""The port's building blocks against the JAX package's.

- ``nn.Lambda``: its output shape inferred on a ``meta`` tensor (as the
  JAX layer's ``eval_shape``) or given; ``decode_safe`` False.
- ``nn.Dropout``: the mask is ``jax.random.bernoulli``'s bit for bit
  (f32 and bf16 inputs, output equal exactly), the identity in eval mode
  and at rate 0, an error in training without an rng; and the rng
  routing of ``Sequential``/``Residual``: a stack of Dropouts under one
  key draws the JAX package's masks.
- The initializers: the port draws JAX's DISTRIBUTIONS from a
  ``torch.Generator``, not JAX's bits: bounds, standard deviations (to
  3 % on 65,536 draws) and the 2-sigma truncation of the ``*_normal``
  ones, against the same statistics of JAX's own draws.
- The losses and their per-example forms (rtol 1e-6), and
  ``top_k_accuracy`` with tied logits (the higher index wins, as JAX's
  stable argsort gives).
- RMSprop, Adagrad, Lamb, Adam over a cosine schedule and
  ``sgd_with_cosine``: 3 steps against the JAX package's optax
  transforms at rtol 1e-6, the state resumed across the packages after
  step 2 both ways (``interop.opt_state_to_tree``/``from_tree``); the
  schedules' values against optax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt

torch.set_num_threads(1)


# ---------------------------------------------------------------- Lambda
def test_lambda_infers_or_takes_its_shape():
    lam = dtt.nn.Lambda(lambda x: x.reshape(x.shape[0], -1, x.shape[-1]))
    assert lam.build((4, 5, 6), None) == (20, 6)
    jl = dtpu.nn.Lambda(lambda x: x.reshape(x.shape[0], -1, x.shape[-1]))
    assert jl.init(jax.random.PRNGKey(0), (4, 5, 6))[2] == (20, 6)
    gap = dtt.nn.Lambda(lambda x: x.mean(dim=1), output_shape=(7,))
    assert gap.build((3, 7), None) == (7,)
    assert dtt.nn.Lambda.decode_safe is False
    x = torch.arange(24.0).reshape(2, 3, 4)
    torch.testing.assert_close(gap(x), x.mean(dim=1))


# --------------------------------------------------------------- Dropout
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_is_jax_bernoulli(rate, dtype):
    x = np.random.default_rng(0).standard_normal((4, 33, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    jl = dtpu.nn.Dropout(rate)
    want, _ = jl.apply({}, {}, jnp.asarray(x, dtype), train=True, rng=key)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    layer = dtt.nn.Dropout(rate)
    layer.train()
    for k in (np.asarray(jax.random.key_data(key)),
              dtt.utils.threefry.device_key(
                  np.asarray(jax.random.key_data(key)), "cpu")):
        with dtt.nn.rng_scope(k):
            got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert np.array_equal(got.float().numpy() != 0, mask)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want, np.float32))


def test_dropout_identity_and_errors():
    x = torch.randn(3, 5)
    layer = dtt.nn.Dropout(0.3).eval()
    assert layer.needs_rng
    assert torch.equal(layer(x), x)  # eval mode
    layer.train()
    with pytest.raises(ValueError, match="Dropout needs an rng"):
        layer(x)
    zero = dtt.nn.Dropout(0.0)
    zero.train()
    assert torch.equal(zero(x), x)


def _pair(build):
    j, p = build(dtpu), build(dtt)
    return j, p


def test_rng_routing_matches_jax_containers():
    """Sequential splits its key across the layers needing one, in order;
    Residual splits in two (main, shortcut): the masks of the whole stack
    are the JAX package's."""
    def build(pkg):
        nn = pkg.nn
        return nn.Sequential([
            nn.Dense(8), nn.Dropout(0.5), nn.Activation("relu"),
            nn.Residual(nn.Sequential([nn.Dense(8), nn.Dropout(0.3)]),
                        nn.Sequential([nn.Dropout(0.2)])),
            nn.Dropout(0.4)])

    jm, pm = _pair(build)
    params, state, _ = jm.init(jax.random.PRNGKey(0), (8,))
    pm.build((8,), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for path, v in dtt.interop.params_from_jax(
                jax.device_get(params)).items():
            pm.get_parameter(path.replace("/", ".")).copy_(v)
    x = np.random.default_rng(1).standard_normal((6, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want, _ = jm.apply(params, state, jnp.asarray(x), train=True, rng=key)
    assert pm.needs_rng
    pm.train()
    with dtt.nn.rng_scope(np.asarray(jax.random.key_data(key))):
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- initializers
@pytest.mark.parametrize("name", ["glorot_uniform", "glorot_normal",
                                  "he_uniform", "he_normal", "lecun_normal",
                                  "zeros", "ones"])
def test_initializers_draw_jax_distributions(name):
    shape = (3, 3, 64, 128)  # a conv kernel: the receptive field counts
    want = np.asarray(dtpu.nn.initializers.get(name)(
        jax.random.PRNGKey(0), shape, jnp.float32))
    got = dtt.nn.initializers.get(name)(
        torch.Generator().manual_seed(0), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name in ("zeros", "ones"):
        np.testing.assert_array_equal(got, want)
        return
    assert not np.array_equal(got, want)  # JAX's distribution, not its bits
    assert abs(got.std() / want.std() - 1.0) < 0.03
    assert abs(got.mean()) < 0.03 * want.std()
    bound = np.abs(want).max()
    if name.endswith("_normal"):
        # Truncated at 2 sigma of the scaled normal: the largest draw sits
        # just below the bound in both packages.
        fan_in, fan_out = 9 * 64, 9 * 128
        n = {"glorot_normal": (fan_in + fan_out) / 2}.get(name, fan_in)
        scale = 2.0 if name == "he_normal" else 1.0
        sigma = np.sqrt(scale / n) / 0.87962566103423978
        assert np.abs(got).max() <= 2 * sigma * (1 + 1e-6)
        assert np.abs(got).max() > 1.9 * sigma and bound > 1.9 * sigma
    else:
        assert np.abs(got).max() <= bound * (1 + 1e-3)
        assert np.abs(got).max() > 0.99 * bound


def test_dense_takes_every_initializer_name():
    layer = dtt.nn.Dense(4, kernel_initializer="he_normal")
    layer.build((6,), torch.Generator().manual_seed(0))
    assert layer.kernel.shape == (6, 4)
    with pytest.raises(ValueError, match="Unknown initializer"):
        dtt.nn.initializers.get("bogus")


# ---------------------------------------------------------------- losses
def _logits_labels(seed=0, shape=(4, 6, 10)):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("from_logits", [True, False])
def test_categorical_crossentropy_matches_jax(from_logits):
    logits, labels = _logits_labels()
    onehot = np.eye(10, dtype=np.float32)[labels]
    if not from_logits:
        logits = np.asarray(jax.nn.softmax(logits, axis=-1))
    want = dtpu.ops.losses.categorical_crossentropy(
        jnp.asarray(logits), jnp.asarray(onehot), from_logits=from_logits)
    got = dtt.ops.losses.categorical_crossentropy(
        torch.from_numpy(logits), torch.from_numpy(onehot),
        from_logits=from_logits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    per_j = dtpu.ops.losses.get_per_example(
        dtpu.ops.losses.categorical_crossentropy)
    per_p = dtt.ops.losses.get_per_example(
        dtt.ops.losses.get("categorical_crossentropy"))
    np.testing.assert_allclose(
        per_p(torch.from_numpy(logits), torch.from_numpy(onehot)).numpy(),
        np.asarray(per_j(jnp.asarray(logits), jnp.asarray(onehot))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["mse", "mean_squared_error"])
def test_mean_squared_error_matches_jax(name):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((5, 3, 4)).astype(np.float32)
    target = rng.standard_normal((5, 3, 4)).astype(np.float32)
    jf, pf = dtpu.ops.losses.get(name), dtt.ops.losses.get(name)
    np.testing.assert_allclose(
        pf(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
        np.asarray(jf(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
    np.testing.assert_allclose(
        dtt.ops.losses.get_per_example(pf)(torch.from_numpy(pred),
                                           torch.from_numpy(target)).numpy(),
        np.asarray(dtpu.ops.losses.get_per_example(jf)(
            jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)


@pytest.mark.parametrize("ignored", [0, 5, 24])
def test_cross_entropy_with_ignore_matches_jax(ignored):
    logits, labels = _logits_labels(seed=3)
    flat = labels.reshape(-1)
    flat[np.random.default_rng(4).permutation(flat.size)[:ignored]] = -100
    labels = flat.reshape(labels.shape)
    want = dtpu.ops.losses.cross_entropy_with_ignore(
        jnp.asarray(logits), jnp.asarray(labels))
    got = dtt.ops.losses.cross_entropy_with_ignore(
        torch.from_numpy(logits), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_accuracy_with_ties_matches_jax(k):
    rng = np.random.default_rng(5)
    # Logits on a coarse grid: many ties, broken by index as JAX does.
    logits = rng.integers(0, 3, (64, 12)).astype(np.float32)
    labels = rng.integers(0, 12, (64,)).astype(np.int32)
    jm, pm = (dtpu.ops.metrics.top_k_accuracy(k),
              dtt.ops.metrics.top_k_accuracy(k))
    js, jn = jm(jnp.asarray(logits), jnp.asarray(labels))
    ps, pn = pm(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(ps) == float(js) and pn == float(jn)
    np.testing.assert_array_equal(
        pm.per_example(torch.from_numpy(logits),
                       torch.from_numpy(labels)).numpy(),
        np.asarray(jm.per_example(jnp.asarray(logits),
                                  jnp.asarray(labels))))
    assert pm.__name__ == jm.__name__ == f"top_{k}_accuracy"
    top5 = dtt.ops.metrics.get("top_5_accuracy")
    assert dtt.ops.metrics.name_of(top5) == "top_5_accuracy"


# -------------------------------------------------------------- optimizers
SHAPES = {"a/kernel": (6, 5), "a/bias": (5,), "b": (4, 3, 2), "z": (3,)}
LR = 0.05


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _optimizers():
    return {
        "rmsprop": (lambda m: m.RMSprop(LR)),
        "rmsprop_momentum": (lambda m: m.RMSprop(LR, decay=0.8,
                                                 momentum=0.9, eps=1e-6)),
        "adagrad": (lambda m: m.Adagrad(LR)),
        "lamb": (lambda m: m.Lamb(LR, weight_decay=0.01)),
        "lamb_no_decay": (lambda m: m.Lamb(LR)),
        "adam_cosine": (lambda m: m.Adam(m.cosine_schedule(LR, 5, 2))),
        "sgd_exponential": (lambda m: m.SGD(
            m.exponential_schedule(LR, 0.5, 2, warmup=1), momentum=0.9)),
        "sgd_with_cosine": (lambda m: m.sgd_with_cosine(LR, 5, 1)),
    }


@pytest.mark.parametrize("name", sorted(_optimizers()))
def test_optimizer_steps_and_resume_match_optax(name):
    make = _optimizers()[name]
    rng = np.random.default_rng(6)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    p0["z"][:] = 0.0  # a zero parameter: Lamb's trust ratio is 1 there
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    grads[0]["z"][:] = 0.0  # a zero gradient: Adagrad's where, Lamb's norm
    paths = list(SHAPES)

    jtx = make(dtpu.optim)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(p0))
    jstate = jtx.init(jp)
    ptx = make(dtt.optim)
    pp = [torch.from_numpy(p0[k].copy()) for k in paths]
    pstate = ptx.init(pp)

    def jstep(params, state, g):
        upd, state = jtx.update(_tree(g), state, params)
        return jax.tree_util.tree_map(lambda a, b: a + b, params, upd), state

    for i in range(3):
        if i == 2:
            # Resume across the packages both ways before step 3.
            named = dict(zip(paths, pp))
            tree = dtt.interop.opt_state_to_tree(ptx, pstate, named)
            pflat = dict(dtt.interop.iter_leaf_paths(tree))
            jflat = dict(dtt.interop.iter_leaf_paths(jax.device_get(jstate)))
            assert sorted(pflat) == sorted(jflat), name
            for path, leaf in jflat.items():
                a = pflat[path]
                a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                np.testing.assert_allclose(a, np.asarray(leaf), rtol=1e-6,
                                           atol=1e-7, err_msg=path)
                assert a.dtype == np.asarray(leaf).dtype, path
            leaves, treedef = jax.tree_util.tree_flatten(jstate)
            order = [p for p, _ in dtt.interop.iter_leaf_paths(
                jax.device_get(jstate))]
            jstate = jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(np.asarray(
                    pflat[p].numpy() if isinstance(pflat[p], torch.Tensor)
                    else pflat[p])) for p in order])
            pstate = dtt.interop.opt_state_from_tree(
                ptx, jax.device_get(jax.tree_util.tree_unflatten(
                    treedef, leaves)), named)
        jp, jstate = jstep(jp, jstate, grads[i])
        ptx.update(pp, [torch.from_numpy(grads[i][k]) for k in paths],
                   pstate)
        want = dtt.interop.flatten_tree(jax.device_get(jp))
        for k, t in zip(paths, pp):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6,
                                       atol=1e-7,
                                       err_msg=f"{name} step {i} {k}")


def test_schedules_match_optax():
    for steps, warmup in ((10, 0), (10, 3), (4, 6)):
        want = dtpu.optim.cosine_schedule(0.1, steps, warmup)
        got = dtt.optim.cosine_schedule(0.1, steps, warmup)
        for c in range(14):
            np.testing.assert_allclose(
                float(got(c)), float(want(jnp.int32(c))), rtol=1e-6,
                atol=1e-9, err_msg=f"cosine {steps}/{warmup} at {c}")
    for warmup in (0, 2):
        want = dtpu.optim.exponential_schedule(0.1, 0.7, 3, warmup)
        got = dtt.optim.exponential_schedule(0.1, 0.7, 3, warmup)
        for c in range(10):
            np.testing.assert_allclose(
                float(got(c)), float(want(jnp.int32(c))), rtol=1e-6,
                err_msg=f"exponential warmup {warmup} at {c}")


def test_optimizer_registry_and_scheduled_learning_rate():
    for name in ("rmsprop", "adagrad", "lamb"):
        assert dtt.optim.get(name).name == name
    tx = dtt.optim.Adam(dtt.optim.cosine_schedule(0.1, 10, 2))
    state = tx.init([torch.zeros(2)])
    with pytest.raises(ValueError, match="driven by a schedule"):
        dtt.optim.set_hyperparam(state, "learning_rate", 0.5)
    tx.update([torch.zeros(2)], [torch.ones(2)], state)
    assert dtt.optim.get_hyperparam(state, "learning_rate") == pytest.approx(
        0.0)  # the warmup's first value
    tx.update([torch.zeros(2)], [torch.ones(2)], state)
    assert dtt.optim.get_hyperparam(state, "learning_rate") == pytest.approx(
        0.05)
