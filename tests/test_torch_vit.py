"""``models.vit`` in the port against the JAX package's.

A small ViT (16x16 images, patch 4: 16 tokens; 2 layers, d_model 32, 2
heads, 10 classes), unrolled and weight-stacked (``scan=True``), with and
without remat, on the same weights (f32): the parameter tree is JAX's,
the logits agree to rtol 1e-5 / atol 1e-6, and 2 ``fit`` steps with the
fused loss (``pallas_sparse_categorical_crossentropy``, K9/K10's plain
versions here) and ``fused_adamw(1e-3)`` (K11's) give JAX's losses (rtol
1e-5) and parameters: atol 1e-5 on every entry whose gradient was at
least 1e-7 (ten times Adam's eps) in both steps. Below that Adam's update
``lr * g / (|g| + eps)`` turns rounding noise of the gradient into a step
of up to ``lr`` (the attention key biases ``bk`` have an exactly zero
gradient in exact arithmetic, and a few matrix entries cross zero by
chance): those entries are held to Adam's own bound, ``2 * lr`` after two
steps, as ``tests/test_torch_training.py`` holds them. The named sizes
(``vit_tiny``/``small``/``base``/``large``) build the JAX package's layer
stacks (depth, width, heads, the 196 positions of 224/16), and
``vit_tiny``'s parameter shapes are JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import jax_model

torch.set_num_threads(1)

SMALL = dict(image_size=16, patch_size=4, num_layers=2, d_model=32,
             num_heads=2)
LR = 1e-3


def _pair(**kw):
    jm = jax_model(dtpu.models.vit(10, **SMALL, **kw), (16, 16, 3))
    pm = dtt.Model(dtt.models.vit(10, **SMALL, **kw),
                   device="cpu").build((16, 16, 3))
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    return jm, pm


def _images(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 16, 16, 3)).astype(np.float32) / 255.0
    return x, rng.integers(0, 10, (n,)).astype(np.int32)


CASES = {"unrolled": {}, "scan": dict(scan=True),
         "scan_remat": dict(scan=True, remat=True),
         "remat": dict(remat=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_logits_and_fit_match_jax(case):
    jm, pm = _pair(**CASES[case])
    assert sorted(pm.params) == sorted(
        dtt.interop.flatten_tree(jax.device_get(jm.params)))
    x, y = _images()
    np.testing.assert_allclose(pm.predict(x, batch_size=4),
                               np.asarray(jm.predict(x, batch_size=4)),
                               rtol=1e-5, atol=1e-6)
    for m, pkg in ((jm, dtpu), (pm, dtt)):
        m.compile(optimizer=pkg.optim.fused_adamw(LR),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    seen, update = [], pm.tx.update

    def record(params, grads, state):
        seen.append([g.detach().abs().clone() for g in grads])
        return update(params, grads, state)

    pm.tx.update = record
    fit = dict(batch_size=4, epochs=2, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)
    hj = jm.fit(x, y, **fit).history
    hp = pm.fit(x, y, **fit).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = dtt.interop.params_to_numpy(pm.params)
    for i, path in enumerate(got):
        small = torch.stack([g[i] for g in seen]).amin(dim=0).numpy() < 1e-7
        diff = np.abs(got[path] - want[path])
        assert diff[~small].max(initial=0.0) <= 1e-5, path
        assert diff[small].max(initial=0.0) <= 2 * LR, path
    if CASES[case].get("scan"):
        assert pm.last_fit_telemetry["overlap"]["layers"] == 2


@pytest.mark.parametrize("size", ["tiny", "small", "base", "large"])
def test_named_sizes_are_the_jax_packages(size):
    jmod = getattr(dtpu.models, f"vit_{size}")(1000)
    pmod = getattr(dtt.models, f"vit_{size}")(1000)
    assert pmod.name == jmod.name == "vit"
    assert [layer.name for layer in pmod.layers] == [
        layer.name for layer in jmod.layers]
    assert pmod.layers[2].max_len == jmod.layers[2].max_len == 196
    assert pmod.layers[0].filters == jmod.layers[0].filters
    heads = [m.num_heads for m in pmod.modules()
             if isinstance(m, dtt.nn.MultiHeadAttention)]
    jheads = [layer.main.layers[1].num_heads for layer in jmod.layers
              if isinstance(layer, dtpu.nn.Residual)
              and isinstance(layer.main.layers[1],
                             dtpu.nn.MultiHeadAttention)]
    assert heads == jheads
    scanned = getattr(dtt.models, f"vit_{size}")(1000, scan=True)
    assert scanned.layers[3].num_blocks == len(jheads)
    if size == "tiny":
        shapes = jax.eval_shape(lambda k: jmod.init(k, (224, 224, 3))[0],
                                jax.random.PRNGKey(0))
        want = {p: tuple(v.shape) for p, v in dtt.interop.iter_leaf_paths(
            shapes)}
        pm = dtt.Model(pmod, device="cpu").build((224, 224, 3))
        assert {p: tuple(t.shape) for p, t in pm.params.items()} == want
