"""The port's CNN slice against the JAX package's, on the same weights.

Layers: each JAX layer is initialised, its parameters are loaded into the
port (``interop.params_from_jax``: the Conv2D kernel is HWIO in both, no
transpose), and both run on the same seeded numpy NHWC input, at SAME and
VALID padding, strides 1 and 2, odd and even sizes and windows (an even
window pads one more row after than before). Then ``mnist_cnn`` and
``cifar_cnn`` forward, three ``fit`` steps of each against the JAX
``SingleDevice`` trainer, and the synthetic data byte for byte.

Tolerances, f32: layer outputs and logits rtol/atol 1e-5 (sums in other
orders); per-step losses rtol 1e-5 (the fit loop's parity gate) and parameters
atol 1e-5 after three SGD steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import as_np, jax_model, port_model

torch.set_num_threads(1)


def _check_layer(jax_layer, port_layer, input_shape, seed=0):
    params, state, out_shape = jax_layer.init(jax.random.PRNGKey(seed),
                                              input_shape)
    assert port_layer.build(tuple(input_shape), torch.Generator()) == out_shape
    model = dtt.Model(port_layer, device="cpu").build(input_shape)
    model.load_params(dtt.interop.params_from_jax(jax.device_get(params)))
    x = np.random.default_rng(seed).standard_normal(
        (2,) + tuple(input_shape)).astype(np.float32)
    want, _ = jax_layer.apply(params, state, jnp.asarray(x))
    got = model.module(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape) == (2,) + tuple(out_shape)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("strides", [1, 2])
@pytest.mark.parametrize("kernel,size", [(3, 9), (3, 8), (2, 7), (4, 10)])
def test_conv2d_matches_jax(padding, strides, kernel, size):
    _check_layer(dtpu.nn.Conv2D(5, kernel, strides=strides, padding=padding,
                                activation="relu"),
                 dtt.nn.Conv2D(5, kernel, strides=strides, padding=padding,
                               activation="relu"),
                 (size, size + 1, 3))


@pytest.mark.parametrize("kind", ["MaxPool2D", "AvgPool2D"])
@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("pool,strides,size", [
    (2, None, 8), (2, None, 7), (3, 2, 9), (3, 1, 6), (2, 1, 5)])
def test_pooling_matches_jax(kind, padding, pool, strides, size):
    _check_layer(getattr(dtpu.nn, kind)(pool, strides, padding=padding),
                 getattr(dtt.nn, kind)(pool, strides, padding=padding),
                 (size, size + 2, 4))


def test_global_pool_flatten_and_activation_match_jax():
    _check_layer(dtpu.nn.GlobalAvgPool2D(), dtt.nn.GlobalAvgPool2D(),
                 (5, 6, 7))
    _check_layer(dtpu.nn.Activation("tanh"), dtt.nn.Activation("tanh"),
                 (5, 6, 7))
    # Flatten must keep the (H, W, C) order: a Dense after it sees the
    # features in the JAX order only then.
    _check_layer(dtpu.nn.Sequential([dtpu.nn.Flatten(), dtpu.nn.Dense(6)]),
                 dtt.nn.Sequential([dtt.nn.Flatten(), dtt.nn.Dense(6)]),
                 (3, 4, 5))


# ------------------------------------------------------------------ models
MODELS = {
    "mnist_cnn": ((28, 28, 1), dict(optimizer=(dtpu.optim.SGD(0.001),
                                               dtt.optim.SGD(0.001)),
                                    batch=64, n=192)),
    "cifar_cnn": ((32, 32, 3), dict(optimizer=(
        dtpu.optim.SGD(0.01, momentum=0.9),
        dtt.optim.SGD(0.01, momentum=0.9)), batch=8, n=24)),
}


def _pair(name):
    shape, _ = MODELS[name]
    jm = jax_model(getattr(dtpu.models, name)(), shape)
    pm = port_model(getattr(dtt.models, name)(), shape, jm.params)
    return jm, pm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cnn_forward_matches_jax(name):
    jm, pm = _pair(name)
    shape, _ = MODELS[name]
    x = np.random.default_rng(1).random((4,) + shape).astype(np.float32)
    want = jm.module.apply(jm.params, jm.state, jnp.asarray(x))[0]
    got = pm.module(torch.from_numpy(x))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)


def test_mnist_cnn_has_the_reference_parameter_count():
    model = dtt.Model(dtt.models.mnist_cnn(), device="cpu").build((28, 28, 1))
    assert model.num_params == 347_146 and len(model.params) == 6


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cnn_fit_matches_jax_single_device(name):
    shape, cfg = MODELS[name]
    jm, pm = _pair(name)
    x, y = dtt.data.synthetic_images(cfg["n"], shape[:2] if shape[2] == 1
                                     else shape, 10, 0)
    x = x.reshape((-1,) + shape).astype(np.float32) / 255.0
    jopt, popt = cfg["optimizer"]
    jm.compile(optimizer=jopt, loss="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    pm.compile(optimizer=popt, loss="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    kw = dict(batch_size=cfg["batch"], epochs=3, steps_per_epoch=1,
              shuffle=True, seed=0, verbose=0)
    hj, hp = jm.fit(x, y, **kw).history, pm.fit(x, y, **kw).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    np.testing.assert_allclose(hp["accuracy"], hj["accuracy"],
                               atol=1 / cfg["batch"])
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = dtt.interop.params_to_numpy(pm.params)
    assert set(got) == set(want)
    for path in got:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-5,
                                   err_msg=path)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("n,shape,classes,seed", [
    (50, (28, 28), 10, 0), (20, (32, 32, 3), 10, 7), (9, (40, 36, 2), 3, 5)])
def test_synthetic_images_are_the_jax_packages_bytes(n, shape, classes, seed):
    from distributed_tpu.data import datasets as jax_datasets

    want = jax_datasets.synthetic_images(n, shape, classes, seed,
                                         template_seed=seed + 1)
    got = dtt.data.synthetic_images(n, shape, classes, seed,
                                    template_seed=seed + 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_load_mnist_synthetic_split_matches_jax(tmp_path):
    kw = dict(data_dir=str(tmp_path), force_synthetic=True,
              synthetic_train_n=30, synthetic_test_n=10)
    for split in ("train", "test"):
        got = dtt.data.load_mnist(split, **kw)
        want = dtpu.data.load_mnist(split, **kw)
        assert got[0].shape == (30 if split == "train" else 10, 28, 28, 1)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(FileNotFoundError):
        dtt.data.load_cifar10(data_dir=str(tmp_path), synthetic_ok=False)
