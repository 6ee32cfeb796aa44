"""``compile(head_chunks=C)`` in the port against the JAX package's.

The chunked head runs the LM's body once and its last layer (the vocab
projection) and the loss over C chunks of the tokens, each under a
checkpoint. A small LM (vocab 64, 2 layers, d_model 32, 2 heads, T 16,
flash attention, f32) on the same weights in both packages, ``Adam(1e-3)``:
per-step losses, accuracy and the evaluation results at rtol 1e-5 (f32;
sums in another order), against the JAX package with the same C and
against the port without chunks. Evaluation takes a ragged last batch
(7 rows at batch 4): the port pads it with its last row weighted 0, as
the JAX package pads every batch. Also ``fit(grad_accum=2)``, the loss
object ``SparseCategoricalCrossentropy``, a custom loss with no
per-example form (each chunk's mean weighted by its count, in both), and
the errors: C not dividing the tokens, a head that holds state, a module
with no head to split, C < 1.
"""

import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import lm_pair

torch.set_num_threads(1)

V, T, LR, RTOL = 64, 16, 1e-3, 1e-5
PALLAS = "pallas_sparse_categorical_crossentropy"


def _data(n=8, seed=0):
    tok = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _jax_ce(logits, labels):
    return dtpu.ops.losses.sparse_categorical_crossentropy(logits, labels)


def _port_ce(logits, labels):
    return dtt.ops.losses.sparse_categorical_crossentropy(logits, labels)


LOSSES = {  # name: (JAX loss, port loss)
    "pallas": (PALLAS, PALLAS),
    "stock": ("sparse_categorical_crossentropy",
              "sparse_categorical_crossentropy"),
    "object": (dtpu.ops.losses.SparseCategoricalCrossentropy(True),
               dtt.ops.losses.SparseCategoricalCrossentropy(True)),
    "custom": (_jax_ce, _port_ce),
}


def _pair(loss="pallas", head_chunks=4):
    jm, pm = lm_pair(vocab=V, num_layers=2, d_model=32, num_heads=2,
                     max_len=T, flash=True)
    jl, pl = LOSSES[loss]
    jm.compile(optimizer=dtpu.optim.Adam(LR), loss=jl, metrics=["accuracy"],
               head_chunks=head_chunks)
    pm.compile(optimizer=dtt.optim.Adam(LR), loss=pl, metrics=["accuracy"],
               head_chunks=head_chunks)
    return jm, pm


def _fit(m, x, y, **kw):
    return m.fit(x, y, batch_size=4, epochs=3, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0, **kw).history


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("chunks", [2, 4])
def test_fit_and_ragged_evaluate_match_jax(loss, chunks):
    jm, pm = _pair(loss, chunks)
    x, y = _data()
    _close(_fit(pm, x, y), _fit(jm, x, y))
    xe, ye = _data(n=7, seed=3)  # the last batch of 4 holds 3 rows
    _close(pm.evaluate(xe, ye, batch_size=4, verbose=0),
           jm.evaluate(xe, ye, batch_size=4, verbose=0))


def test_chunked_equals_unchunked_in_the_port():
    x, y = _data()
    _, chunked = _pair("pallas", 4)
    _, plain = _pair("pallas", None)
    _close(_fit(chunked, x, y), _fit(plain, x, y))
    xe, ye = _data(n=7, seed=3)
    _close(chunked.evaluate(xe, ye, batch_size=4, verbose=0),
           plain.evaluate(xe, ye, batch_size=4, verbose=0))
    # Parameters: atol 1e-5, but the attention key bias: its gradient is
    # zero in exact arithmetic, so Adam moves it by rounding noise, up to
    # its own bound of lr a step (as in test_torch_training.py).
    want = dtt.interop.params_to_numpy(plain.params)
    for path, got in dtt.interop.params_to_numpy(chunked.params).items():
        atol = 3 * LR if path.endswith("/bk") else 1e-5
        np.testing.assert_allclose(got, want[path], rtol=1e-4, atol=atol,
                                   err_msg=path)


def test_grad_accum_with_chunks_matches_jax():
    jm, pm = _pair("pallas", 4)
    x, y = _data()
    _close(_fit(pm, x, y, grad_accum=2), _fit(jm, x, y, grad_accum=2))


def test_chunks_must_divide_the_tokens():
    _, pm = _pair("pallas", 3)  # 4 x 16 = 64 tokens
    x, y = _data()
    with pytest.raises(ValueError, match="must divide the token count 64"):
        _fit(pm, x, y)


def test_a_stateful_head_raises():
    pm = dtt.Model(dtt.nn.Sequential([
        dtt.nn.Embedding(V, 8), dtt.nn.Dense(V), dtt.nn.BatchNorm()]),
        device="cpu")
    pm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               head_chunks=2)
    x, y = _data()
    with pytest.raises(ValueError, match="STATELESS head"):
        pm.fit(x, y, batch_size=4, epochs=1, verbose=0)


def test_unsuitable_modules_and_counts_raise():
    single = dtt.Model(dtt.nn.Sequential([dtt.nn.Dense(4)]), device="cpu")
    with pytest.raises(ValueError, match="head_chunks needs a Sequential"):
        single.compile(optimizer="sgd", head_chunks=2)
    _, pm = _pair("pallas", None)
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="head_chunks must be"):
            pm.compile(optimizer="sgd", head_chunks=bad)
    pm.compile(optimizer="sgd", head_chunks=1)  # 1: the plain path
    assert pm.head_chunks == 1


def test_chunked_head_keeps_the_fused_losses(monkeypatch):
    """Selective checkpointing keeps each chunk's fused losses (the
    ``dtt::xent_fwd`` operator's outputs): one fused forward a chunk in a
    training step, none in the backward's recompute."""
    from distributed_tpu_torch.ops import pallas_kernels as pk

    calls, ref = [], pk.xent_fwd_ref
    monkeypatch.setattr(pk, "xent_fwd_ref",
                        lambda *a: calls.append(1) or ref(*a))
    x, y = _data(n=4)
    m = dtt.Model(dtt.models.transformer_lm(V, num_layers=1, d_model=16,
                                            num_heads=2, max_len=T),
                  device="cpu")
    m.compile(optimizer="adam", loss=PALLAS, head_chunks=4)
    m.fit(x, y, batch_size=4, epochs=1, steps_per_epoch=1, verbose=0)
    assert len(calls) == 4
