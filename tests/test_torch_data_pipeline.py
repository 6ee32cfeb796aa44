"""The port's input pipeline and device prefetch against the JAX package.

- ``data.Pipeline``: the batches equal the JAX ``Pipeline(use_native=
  False)``'s bit for bit, over seeds, passes, shuffle on and off, shards
  and ``next_k``; ``state_dict``/``load_state``/``seek``/``reshard`` move
  the cursor as JAX's do; the native ring (``use_native=True``, ported
  since) emits the same batches, and the bad inputs raise as in JAX.
- ``data.DevicePrefetcher``: the same stream at depths 0, 1 and 2, and
  the unconsumed steps after an early close.
- ``fit``/``evaluate``/``predict`` from a Pipeline, on a small dense
  classifier of 8x8 uint8 images carried across from JAX: per-epoch
  losses rtol 1e-5, parameters atol 1e-5, evaluate's means rtol 1e-5,
  predict's logits rtol 1e-5 + atol 1e-6; the same run at prefetch 0, 1
  and 2 is bit-identical; a mid-epoch stop rewinds the Pipeline to the
  step trained.
- A checkpoint's ``data_state`` (the Pipeline's cursor) written by one
  package resumes a fresh Pipeline in the other: the continued losses
  match the saver's own continuation at rtol 1e-5.
"""

import time

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu.training import callbacks as jcb
from distributed_tpu_torch.training import callbacks as pcb

torch.set_num_threads(1)

N, SHAPE, CLASSES = 80, (8, 8, 1), 10


def _images(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n,) + SHAPE).astype(np.uint8),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _pipes(**kw):
    x, y = _images()
    return (dtpu.data.Pipeline(x, y, use_native=False, **kw),
            dtt.data.Pipeline(x, y, **kw))


@pytest.mark.parametrize("kw", [
    dict(batch_size=16, seed=0),
    dict(batch_size=16, seed=7),
    dict(batch_size=12, seed=3, shuffle=False),
    dict(batch_size=16, seed=1, shard=(1, 4)),
    dict(batch_size=16, seed=1, shard=(0, 2), scale=0.5),
], ids=["seed0", "seed7", "no_shuffle", "shard_1_of_4", "shard_scale"])
def test_pipeline_batches_equal_jax(kw):
    jp, pp = _pipes(**kw)
    assert pp.steps_per_pass == jp.steps_per_pass
    assert pp.batch_shape == jp.batch_shape and pp.shard == jp.shard
    for _ in range(2 * jp.steps_per_pass + 2):  # past two reshuffles
        (jx, jy), (px, py) = next(jp), next(pp)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
        assert px.dtype == np.float32 and py.dtype == np.int32
    jx, jy = jp.next_k(3)
    px, py = pp.next_k(3)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    assert pp.state_dict() == jp.state_dict()


def test_pipeline_cursor_moves_as_jax():
    jp, pp = _pipes(batch_size=16, seed=2)
    for _ in range(7):
        next(jp), next(pp)
    state = pp.state_dict(consumed_steps=6)
    assert state == jp.state_dict(consumed_steps=6)
    fresh = dtt.data.Pipeline(*_images(), batch_size=16, seed=2)
    fresh.load_state(state)
    jp.seek(6)
    np.testing.assert_array_equal(next(fresh)[0], next(jp)[0])
    with pytest.raises(ValueError, match="seed"):
        dtt.data.Pipeline(*_images(), batch_size=16, seed=3).load_state(
            state)
    # reshard: the next global batch, sliced the new way.
    jp.reshard((1, 2))
    fresh.reshard((1, 2))
    np.testing.assert_array_equal(next(fresh)[0], next(jp)[0])
    with pytest.raises(ValueError, match="divisible"):
        fresh.reshard((0, 3))


def test_pipeline_refuses_what_is_not_ported():
    """Every path is ported now: the ring emits the Python path's
    batches, and what stays refused is what JAX refuses."""
    x, y = _images()
    ring = dtt.data.Pipeline(x, y, use_native=True, seed=2)
    plain = dtt.data.Pipeline(x, y, use_native=False, seed=2)
    assert ring.is_native and not plain.is_native
    for _ in range(3):
        for a, b in zip(next(ring), next(plain)):
            np.testing.assert_array_equal(a, b)
    ring.close()
    with pytest.raises(FileNotFoundError, match="shard directory not found"):
        dtt.data.Pipeline("/nonexistent/shards", batch_size=4)
    with pytest.raises(TypeError, match="uint8"):
        dtt.data.Pipeline(x.astype(np.float32), y)
    with pytest.raises(ValueError, match="RecordSource"):
        dtt.data.Pipeline(x, y, decode_workers=2)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetcher_serves_the_stream_in_order(depth):
    counter = iter(range(1000))

    def stage(k):
        return [next(counter) for _ in range(k)]

    sizes = [3, 3, 1, 3, 2]
    with dtt.data.DevicePrefetcher(stage, sizes, depth=depth) as pf:
        got = [pf.get() for _ in sizes]
    assert [k for k, _ in got] == sizes
    assert sum((b for _, b in got), []) == list(range(sum(sizes)))
    with pytest.raises(IndexError):
        pf.get()


def test_prefetcher_counts_unconsumed_steps_and_reraises():
    pf = dtt.data.DevicePrefetcher(lambda k: k, [2] * 10, depth=2)
    pf.get()
    deadline = 0
    while pf.unconsumed_steps < 4 and deadline < 200:  # producer is ahead
        time.sleep(0.01)
        deadline += 1
    pf.close()
    assert pf.unconsumed_steps in (4, 6)

    def boom(k):
        raise KeyError("source exhausted")

    with pytest.raises(KeyError):
        dtt.data.DevicePrefetcher(boom, [1, 1], depth=1).get()


def test_stager_on_the_cpu_hands_arrays_on():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    staged = dtt.data.DeviceStager("cpu").stage({"x": x})
    np.testing.assert_array_equal(staged.tensors["x"].numpy(), x)


def _classifier(pkg):
    return pkg.nn.Sequential([pkg.nn.Flatten(),
                              pkg.nn.Dense(32, activation="relu"),
                              pkg.nn.Dense(CLASSES)])


def _models():
    jm = dtpu.Model(_classifier(dtpu))
    pm = dtt.Model(_classifier(dtt), device="cpu")
    for pkg, m in ((dtpu, jm), (dtt, pm)):
        m.compile(optimizer=pkg.optim.SGD(0.05, momentum=0.9),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    jm.build(SHAPE, seed=0)
    pm.build(SHAPE)
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    return jm, pm


def test_fit_evaluate_predict_from_a_pipeline_match_jax():
    jm, pm = _models()
    jp, pp = _pipes(batch_size=16, seed=4)
    hj = jm.fit(jp, epochs=3, verbose=0).history
    hp = pm.fit(pp, epochs=3, verbose=0).history
    assert pm.step == jm.step == 15
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    for path, p in dtt.interop.params_to_numpy(pm.params).items():
        np.testing.assert_allclose(p, want[path], rtol=0, atol=1e-5)
    jv, pv = _pipes(batch_size=16, seed=9, shuffle=False)
    ej, ep = jm.evaluate(jv, verbose=0), pm.evaluate(pv, verbose=0)
    assert sorted(ep) == sorted(ej)
    for k in ej:
        np.testing.assert_allclose(ep[k], ej[k], rtol=1e-5)
    np.testing.assert_allclose(pm.predict(pv, steps=3),
                               np.asarray(jm.predict(jv, steps=3)),
                               rtol=1e-5, atol=1e-6)
    # A Pipeline as validation data: one pass after each epoch.
    jm2, pm2 = _models()
    jv, pv = _pipes(batch_size=16, seed=9, shuffle=False)
    hj = jm2.fit(_pipes(batch_size=16, seed=4)[0], epochs=2, verbose=0,
                 validation_data=jv).history
    hp = pm2.fit(_pipes(batch_size=16, seed=4)[1], epochs=2, verbose=0,
                 validation_data=pv).history
    np.testing.assert_allclose(hp["val_loss"], hj["val_loss"], rtol=1e-5)


def test_prefetch_depth_does_not_change_the_run():
    runs = []
    for depth in (0, 1, 2):
        _, pm = _models()
        hist = pm.fit(_pipes(batch_size=16, seed=4)[1], epochs=2, verbose=0,
                      prefetch=depth)
        runs.append((hist.history,
                     dtt.interop.params_to_numpy(pm.params)))
    for hist, params in runs[1:]:
        assert hist == runs[0][0]
        for path, p in params.items():
            np.testing.assert_array_equal(p, runs[0][1][path])


def test_mid_epoch_stop_rewinds_the_pipeline():
    _, pm = _models()
    pp = _pipes(batch_size=16, seed=4)[1]
    stop = pcb.LambdaCallback(on_batch_end=lambda m, s, logs: setattr(
        m, "stop_training", s == 2))
    pm.fit(pp, epochs=2, verbose=0, prefetch=2, callbacks=[stop])
    assert pm.step == 2 and pp.steps_emitted == 2
    assert pm.last_fit_telemetry["input_decode_workers"] == 0


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_data_state_resumes_across_packages(tmp_path, saver):
    """3 steps from a Pipeline under ModelCheckpoint(save_freq=3) (the
    file's meta carries the Pipeline's cursor), then the other package
    restores into a fresh model and a fresh Pipeline and trains to 8."""
    jm, pm = _models()
    jp, pp = _pipes(batch_size=16, seed=4)
    src, src_cb, src_pipe = ((jm, jcb, jp) if saver == "jax"
                             else (pm, pcb, pp))
    seen_src, seen_dst = [], []
    src.fit(src_pipe, epochs=2, steps_per_epoch=4, verbose=0, callbacks=[
        src_cb.ModelCheckpoint(tmp_path, save_freq=3),
        src_cb.LambdaCallback(on_batch_end=lambda m, s, logs:
                              seen_src.append(float(logs["loss"])))])
    jm2, pm2 = _models()
    dst, dst_cb, dst_pipe = ((pm2, pcb, _pipes(batch_size=16, seed=4)[1])
                             if saver == "jax" else
                             (jm2, jcb, _pipes(batch_size=16, seed=4)[0]))
    dst.fit(dst_pipe, epochs=2, steps_per_epoch=4, verbose=0, callbacks=[
        dst_cb.ModelCheckpoint(tmp_path, save_freq=100, restore=True),
        dst_cb.LambdaCallback(on_batch_end=lambda m, s, logs:
                              seen_dst.append(float(logs["loss"])))])
    # The saver's last checkpoint is step 6; the restored run takes 7-8.
    assert dst.step == 8 and len(seen_dst) == 2
    assert dst_pipe.steps_emitted == 8
    np.testing.assert_allclose(seen_dst, seen_src[6:], rtol=1e-5)
    if saver == "jax":
        # The port resumes through the file's cursor, so a Pipeline of
        # another stream is refused, as in JAX.
        other = dtt.data.Pipeline(*_images(), batch_size=16, seed=5)
        with pytest.raises(ValueError, match="iterator state mismatch"):
            _models()[1].fit(other, epochs=2, steps_per_epoch=4, verbose=0,
                             callbacks=[pcb.ModelCheckpoint(
                                 tmp_path, save_freq=100, restore=True)])
