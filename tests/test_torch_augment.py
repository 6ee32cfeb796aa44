"""Augmentation in the port against the JAX package, bit for bit.

- ``utils.threefry.randint`` equals ``jax.random.randint`` (jax 0.9.0,
  int32) for host and device keys over spans 1, 2, 17, 33, 2**16 +- 1 and
  2**31 - 1, negative bounds, and an empty range.
- ``nn.RandomFlip`` (each mode) and ``nn.RandomCrop`` (with and without
  padding) equal the JAX layers for the same key in training, and their
  center crop / identity in eval; the same flags and error texts.
- ``RandomCrop(padding=2)`` + ``RandomFlip`` in front of ``mnist_cnn``,
  fitted 2 steps from a ``FileSource`` pipeline (the port on its C++
  ring, JAX on its Python path) from the same parameters: losses within
  1e-5 of JAX's; the step key reaches the layers through ``fit``'s rng
  routing, so the run repeats exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu_torch.nn.core import rng_scope
from distributed_tpu_torch.utils import threefry

torch.set_num_threads(1)

SPANS = [(0, 1), (0, 2), (0, 17), (5, 38), (0, 65535), (0, 65537),
         (0, 65536), (0, 2**31 - 1), (-7, 9), (-2**31, 2**31 - 1), (4, 4),
         (9, 3)]


@pytest.mark.parametrize("lo,hi", SPANS)
def test_randint_equals_jax(lo, hi):
    for seed in (0, 1, 123456789):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, (257,), lo, hi))
        kd = np.asarray(key)
        for k in (kd, threefry.device_key(kd, "cpu")):
            got = threefry.randint(k, (257,), lo, hi, "cpu")
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(OverflowError, match="int32"):
        threefry.randint(threefry.PRNGKey(0), (2,), 0, 2**31, "cpu")


def _layers(kind):
    if kind.startswith("flip"):
        mode = kind.split(":")[1]
        return dtpu.nn.RandomFlip(mode), dtt.nn.RandomFlip(mode)
    h, w, p = (int(v) for v in kind.split(":")[1:])
    return (dtpu.nn.RandomCrop(h, w, padding=p),
            dtt.nn.RandomCrop(h, w, padding=p))


@pytest.mark.parametrize("kind", ["flip:horizontal", "flip:vertical",
                                  "flip:horizontal_and_vertical",
                                  "crop:8:9:0", "crop:10:12:4",
                                  "crop:13:11:2"])
def test_layer_equals_jax(kind):
    x = np.random.default_rng(0).standard_normal((7, 10, 12, 3)).astype(
        np.float32)
    jl, pl = _layers(kind)
    jp, js, shape = jl.init(jax.random.PRNGKey(0), (10, 12, 3))
    assert tuple(shape) == pl.build((10, 12, 3), None)
    assert pl.needs_rng is jl.needs_rng is True
    assert pl.decode_safe is jl.decode_safe is False
    pl.train()
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jl.apply(jp, js, jnp.asarray(x), train=True,
                                   rng=key)[0])
        for k in (np.asarray(key), threefry.device_key(np.asarray(key),
                                                       "cpu")):
            with rng_scope(k):
                got = pl(torch.from_numpy(x)).numpy()
            assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="needs an rng when train=True"):
        pl(torch.from_numpy(x))
    pl.eval()
    want = np.asarray(jl.apply(jp, js, jnp.asarray(x), train=False)[0])
    assert pl(torch.from_numpy(x)).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("make", [
    lambda nn: nn.RandomFlip("diagonal"),
    lambda nn: nn.RandomCrop(0, 4),
    lambda nn: nn.RandomCrop(4, 4, padding=-1),
])
def test_constructor_errors_match_jax(make):
    with pytest.raises(ValueError) as je:
        make(dtpu.nn)
    with pytest.raises(ValueError) as pe:
        make(dtt.nn)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("layer,shape", [
    (lambda nn: nn.RandomFlip(), (4, 4)),
    (lambda nn: nn.RandomCrop(4, 4), (4, 4)),
    (lambda nn: nn.RandomCrop(9, 4, padding=2), (4, 4, 1)),
])
def test_build_errors_match_jax(layer, shape):
    with pytest.raises(ValueError) as je:
        layer(dtpu.nn).init(jax.random.PRNGKey(0), shape)
    with pytest.raises(ValueError) as pe:
        layer(dtt.nn).build(shape, None)
    assert str(pe.value) == str(je.value)


def _augmented(nn, models):
    return nn.Sequential([nn.RandomCrop(28, 28, padding=2),
                          nn.RandomFlip("horizontal"), models.mnist_cnn()],
                         name="augmented_mnist")


def test_augmented_fit_from_file_pipeline_matches_jax(tmp_path):
    x, y = dtt.data.synthetic_images(128, (28, 28, 1), 10, 0)
    dtt.data.write_shards(tmp_path, x, y, rows_per_shard=50)
    jm = dtpu.Model(_augmented(dtpu.nn, dtpu.models))
    jm.compile(optimizer=dtpu.optim.SGD(0.05), loss="sparse_categorical_crossentropy",
               metrics=[])
    jm.build((28, 28, 1), seed=0)
    pm = dtt.Model(_augmented(dtt.nn, dtt.models), device="cpu")
    pm.compile(optimizer=dtt.optim.SGD(0.05),
               loss="sparse_categorical_crossentropy", metrics=[])
    pm.build((28, 28, 1), seed=0)
    start = dtt.interop.params_from_jax(jax.device_get(jm.params))
    pm.load_params(start)
    jp = dtpu.data.Pipeline(str(tmp_path), batch_size=32, seed=1,
                            use_native=False)
    want = jm.fit(jp, epochs=2, steps_per_epoch=1, verbose=0).history["loss"]
    losses = []
    for _ in range(2):  # the same run twice: the crops repeat
        pm.load_params(start)
        pm.step = 0
        pp = dtt.data.Pipeline(str(tmp_path), batch_size=32, seed=1,
                               use_native=True)
        assert pp.is_native
        losses.append(pm.fit(pp, epochs=2, steps_per_epoch=1,
                             verbose=0).history["loss"])
        pp.close()
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)
    assert losses[0] == losses[1]
