"""``transformer_lm(remat=True, remat_policy=...)`` in the port.

``nn.Remat`` runs a block under ``torch.utils.checkpoint`` (selective
checkpointing for the dots policies): the same arithmetic, recomputed in
the backward. On the CPU every operation is deterministic, so the port's
remat LM after 3 ``fit`` steps equals its plain LM bit for bit under every
policy, f32 and bf16 layers, and under ``mixed_bfloat16``. Against the
JAX package's remat LM (``jax.checkpoint`` with the same policy) the
per-step losses hold at rtol 1e-5 (f32). The wrapper is transparent: the
parameter paths (the JAX tree's), the dtype hints, ``generate`` and the
Engine's tokens are the plain model's. Policies are the
``jax.checkpoint_policies`` names, or objects named like them (the JAX
policy functions themselves); anything else raises.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import lm_pair

torch.set_num_threads(1)

V, T, LR = 64, 32, 1e-3
PALLAS = "pallas_sparse_categorical_crossentropy"
POLICY = "dots_with_no_batch_dims_saveable"


def _data(n=8, seed=0):
    tok = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _lm(remat=False, policy=None, dtype=None, precision=None):
    m = dtt.Model(dtt.models.transformer_lm(
        V, num_layers=2, d_model=32, num_heads=2, max_len=T, flash=True,
        remat=remat, remat_policy=policy, dtype=dtype), device="cpu")
    m.compile(optimizer=dtt.optim.Adam(LR), loss=PALLAS,
              metrics=["accuracy"], precision=precision)
    return m.build((T,), seed=0)


def _fit(m, x, y):
    return m.fit(x, y, batch_size=4, epochs=3, steps_per_epoch=1,
                 shuffle=True, seed=0, verbose=0).history


@pytest.mark.parametrize("policy", [None, "nothing_saveable", POLICY,
                                    "dots_saveable", "everything_saveable"])
@pytest.mark.parametrize("dtype,precision", [(None, None),
                                             ("bfloat16", None),
                                             (None, "mixed_bfloat16")])
def test_remat_is_bit_identical_to_no_remat(policy, dtype, precision):
    x, y = _data()
    plain = _lm(dtype=dtype, precision=precision)
    remat = _lm(True, policy, dtype, precision)
    hp, hr = _fit(plain, x, y), _fit(remat, x, y)
    assert hr == hp
    for path, t in remat.params.items():
        assert torch.equal(t, plain.params[path]), path


@pytest.mark.parametrize("policy", ["nothing_saveable", POLICY])
def test_remat_matches_jax_remat(policy):
    jm, pm = lm_pair(vocab=V, num_layers=2, d_model=32, num_heads=2,
                     max_len=T, flash=True, remat=True,
                     remat_policy=getattr(jax.checkpoint_policies, policy))
    # The port takes the JAX policy object too: it reads its __name__.
    assert isinstance(pm.module.layers[2], dtt.nn.Remat)
    jm.compile(optimizer=dtpu.optim.Adam(LR), loss=PALLAS,
               metrics=["accuracy"])
    pm.compile(optimizer=dtt.optim.Adam(LR), loss=PALLAS,
               metrics=["accuracy"])
    x, y = _data()
    hj, hp = _fit(jm, x, y), _fit(pm, x, y)
    for k in hj:
        np.testing.assert_allclose(hp[k], hj[k], rtol=1e-5, err_msg=k)


def test_paths_hints_and_decoding_are_the_plain_models():
    plain, remat = _lm(), _lm(True, POLICY)
    assert list(remat.params) == list(plain.params)
    jm = dtpu.Model(dtpu.models.transformer_lm(
        V, num_layers=2, d_model=32, num_heads=2, max_len=T, remat=True))
    jm.compile(optimizer="adam")
    jm.build((T,))
    assert sorted(remat.params) == sorted(
        dtt.interop.flatten_tree(jax.device_get(jm.params)))
    hinted = dtt.models.transformer_lm(V, num_layers=1, remat=True,
                                       dtype="bfloat16")
    assert hinted.dtype_hints() == dtt.models.transformer_lm(
        V, num_layers=1, dtype="bfloat16").dtype_hints()
    assert hinted.dtype_hints()["residual_1"]["main"]["dense"] == "bfloat16"
    prompt = _data(n=2)[0][:, :5]
    for kw in (dict(temperature=0.0), dict(temperature=0.7, seed=3)):
        np.testing.assert_array_equal(remat.generate(prompt, 6, **kw),
                                      plain.generate(prompt, 6, **kw))
    reqs = [(p, 6) for p in _data(n=3, seed=4)[0][:, :7]]
    outs = [dtt.serving.Engine(m, max_slots=2, block_size=8,
                               max_len=T).run(reqs) for m in (plain, remat)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_policy_names_and_objects():
    for name in dtt.nn.remat.POLICIES:
        dtt.models.transformer_lm(V, num_layers=1, remat=True,
                                  remat_policy=name)
        dtt.models.transformer_lm(
            V, num_layers=1, remat=True,
            remat_policy=getattr(jax.checkpoint_policies, name))
    for bad in ("dots", "save_only_these_names", 3,
                jax.checkpoint_policies.save_only_these_names("x")):
        with pytest.raises(ValueError, match="remat policy"):
            dtt.models.transformer_lm(V, num_layers=1, remat=True,
                                      remat_policy=bad)
    # Without remat the policy is not read, as in JAX.
    dtt.models.transformer_lm(V, num_layers=1, remat_policy="dots")
