"""``nn.MoE`` and the MoE LM in the port, against the JAX package (one process).

The layer, given the JAX layer's parameters (``interop``), on the same
seeded numpy inputs: outputs rtol 1e-5 / atol 1e-6 and the aux loss (the
state ``aux_loss``) rtol 1e-5, for 3-D and 2-D inputs, top-1 routing, a
prime token count padded up to a group, groups whose capacity drops
tokens, zero-weighted rows (``sample_weights``, JAX's
``eval_sample_weights``: they neither route nor count in the aux
statistics), and exact ties in the router's probabilities (a zero router:
the lower expert index first, as ``lax.top_k``). The aux loss's gradient
to the router equals JAX's; ``decode`` routes without capacity
(dropless) and equals the forward where the forward drops nothing.

The MoE LM (``transformer_lm(moe_experts=4, moe_every=2)``): 3 ``fit``
steps of ``SGD(0.1)`` and of ``Adam(1e-3)`` (the aux loss in the
objective) with JAX's losses (rtol 1e-5), parameters and aux state (atol
1e-5; Adam's near-zero entries, the attention key bias, to Adam's own
bound ``3 * lr``); ``evaluate`` of a partial last batch (padded, the pad
rows excluded from routing) equals JAX's; greedy ``generate`` and the
``Engine`` (through the port's paged hooks) give JAX's tokens.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu_torch.nn import moe as moe_lib
from torch_parity import jax_engine, lm_tokens, port_model

torch.set_num_threads(1)


def _pair(shape, e=4, h=16, seed=0, **kw):
    jl = dtpu.nn.MoE(e, h, **kw)
    pl = dtt.nn.MoE(e, h, **kw)
    params, state, _ = jl.init(jax.random.PRNGKey(seed), shape)
    pl.build(shape, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in dtt.interop.params_from_jax(
                jax.device_get(params)).items():
            getattr(pl, k).copy_(v)
    return jl, pl, params, state


CASES = {
    "3d": ((7, 8), 3, {}),
    "2d": ((8,), 5, {}),
    "top1": ((6, 8), 2, dict(top_k=1)),
    "prime_padded": ((13, 8), 1, dict(group_size=4)),
    "drops": ((9, 8), 2, dict(group_size=8, capacity_factor=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    shape, b, kw = CASES[case]
    jl, pl, params, state = _pair(shape, **kw)
    x = np.random.default_rng(1).standard_normal((b,) + shape).astype(
        np.float32)
    want, st = jl.apply(params, state, jnp.asarray(x), train=True)
    pl.train()
    got = pl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pl.aux_loss), float(st["aux_loss"]),
                               rtol=1e-5)


def test_drops_happen_and_pads_do_not_route():
    # 18 tokens in groups of 8 (padded to 24): capacity 2 of a mean load
    # of 4, so the drops case drops.
    layer = dtt.nn.MoE(4, 16, group_size=8, capacity_factor=0.5)
    assert layer._capacity(8) == 2


def test_sample_weight_rows_neither_route_nor_count():
    jl, pl, params, state = _pair((5, 8), group_size=8)
    x = np.random.default_rng(2).standard_normal((4, 5, 8)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    with dtpu.nn.core.eval_sample_weights(jnp.asarray(w)):
        want, st = jl.apply(params, state, jnp.asarray(x))
    with moe_lib.sample_weights(torch.from_numpy(w)):
        got = pl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pl.aux_term.detach()),
                               float(st["aux_loss"]),
                               rtol=1e-5)


def test_exact_ties_take_the_lower_expert():
    jl, pl, params, state = _pair((6, 8))
    params = dict(params, router=jnp.zeros_like(params["router"]))
    with torch.no_grad():
        pl.router.zero_()
    x = np.random.default_rng(3).standard_normal((2, 6, 8)).astype(np.float32)
    want, _ = jl.apply(params, state, jnp.asarray(x))
    got = pl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    _, _, idx = pl._route(torch.zeros(3, 8), pl.router)
    assert idx.tolist() == [[0, 1]] * 3


def test_aux_loss_gradient_to_router_matches_jax():
    jl, pl, params, state = _pair((7, 8))
    x = np.random.default_rng(4).standard_normal((3, 7, 8)).astype(np.float32)

    def aux(router):
        _, st = jl.apply(dict(params, router=router), state, jnp.asarray(x),
                         train=True)
        return st["aux_loss"]

    want = jax.grad(aux)(params["router"])
    pl(torch.from_numpy(x))
    (got,) = torch.autograd.grad(pl.aux_term, [pl.router])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)


def test_decode_is_dropless():
    jl, pl, params, state = _pair((8, 8), capacity_factor=16.0, group_size=8)
    x = np.random.default_rng(2).standard_normal((2, 8, 8)).astype(np.float32)
    full = pl(torch.from_numpy(x)).detach()
    for t in range(8):
        xt = x[:, t:t + 1]
        got, _ = pl.decode({}, torch.from_numpy(xt), pos=t)
        want, _ = jl.decode(params, state, {}, jnp.asarray(xt), pos=t)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[:, 0].detach().numpy(),
                                   full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- the LM
def _lm(pkg):
    return pkg.models.transformer_lm(32, num_layers=2, d_model=32,
                                     num_heads=2, max_len=16, moe_experts=4,
                                     moe_every=2)


@functools.lru_cache(maxsize=None)
def _lm_run(opt):
    x, y = lm_tokens(24)
    jm = dtpu.Model(_lm(dtpu))
    jm.compile(optimizer=dtpu.optim.SGD(0.1) if opt == "sgd" else
               dtpu.optim.Adam(1e-3),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    jm.build((16,), seed=0)
    pm = port_model(_lm(dtt), (16,), jm.params)
    pm.compile(optimizer=dtt.optim.SGD(0.1) if opt == "sgd" else
               dtt.optim.Adam(1e-3),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    fit = dict(batch_size=8, epochs=3, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)
    return opt, x, y, jm, pm, jm.fit(x, y, **fit).history, \
        pm.fit(x, y, **fit).history


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_moe_lm_fit_matches_jax(opt):
    opt, _, _, jm, pm, jh, ph = _lm_run(opt)
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-5)
    want = dtt.interop.flatten_tree(jax.device_get(
        {"params": jm.params, "state": jm.state}))
    got = {"params/" + k: v for k, v in
           dtt.interop.params_to_numpy(pm.params).items()}
    got.update({"state/" + k: v for k, v in
                dtt.interop.state_to_numpy(pm.state).items()})
    assert set(got) == set(want)
    assert "state/residual_3/main/moe/aux_loss" in got
    for path, v in want.items():
        atol = 3e-3 if opt == "adam" and path.endswith("/bk") else 1e-5
        np.testing.assert_allclose(got[path], v, rtol=0, atol=atol,
                                   err_msg=path)


def test_moe_lm_evaluate_generate_serve_match_jax():
    _, x, y, jm, pm, _, _ = _lm_run("sgd")
    want = jm.evaluate(x[:12], y[:12], batch_size=8, verbose=0)
    got = pm.evaluate(x[:12], y[:12], batch_size=8, verbose=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
    prompt = x[:2, :5]
    gen = pm.generate(prompt, 6, temperature=0.0)
    np.testing.assert_array_equal(
        gen, np.asarray(jm.generate(prompt, 6, temperature=0.0)))
    reqs = [(x[i, :6], 5) for i in range(3)]
    served = dtt.serving.Engine(pm, max_slots=2, block_size=4,
                                max_len=16).run(reqs)
    jserved = jax_engine(jm, max_slots=2, block_size=4, max_len=16).run(reqs)
    for a, b in zip(served, jserved):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_moe_lm_evaluate_with_a_ratio_loss_matches_jax():
    # The aux terms join after the ratio is formed: with ignored labels the
    # ratio's count (kept tokens) differs from the batch's valid count.
    x, y = lm_tokens(24)
    yi = y[:12].copy()
    yi[:, -5:] = -100
    yi[3] = -100
    jm = dtpu.Model(_lm(dtpu))
    jm.compile(optimizer=dtpu.optim.SGD(0.1),
               loss=dtpu.ops.losses.cross_entropy_with_ignore, metrics=[])
    jm.build((16,), seed=0)
    pm = port_model(_lm(dtt), (16,), jm.params)
    pm.compile(optimizer=dtt.optim.SGD(0.1),
               loss=dtt.ops.losses.cross_entropy_with_ignore, metrics=[])
    want = jm.evaluate(x[:12], yi, batch_size=8, verbose=0)["loss"]
    got = pm.evaluate(x[:12], yi, batch_size=8, verbose=0)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_row_line_raises_under_a_sequence_split():
    """The row line that raised under a sequence split is now the token
    layout every strategy answers: a rank's first row and position in the
    global batch and the ranks of its batch group (nn.MoE routes by it;
    tests/test_torch_moe_seq.py holds that to JAX)."""
    class SeqSplit(dtt.parallel.strategy.Strategy):
        num_batch_shards = 2  # one row line, its tokens over 2 ranks

        def seq_offset(self, t_local):
            return t_local  # the second sequence block

    assert dtt.parallel.strategy.Strategy().token_layout(4, 16) == (
        4, 16, 0, 0, 1)
    assert SeqSplit().token_layout(4, 8) == (4, 16, 0, 8, 2)
    assert SeqSplit().forward_collectives(False, moe=True) is not None
    assert dtt.parallel.strategy.Strategy().forward_collectives(
        False, moe=True) is None
