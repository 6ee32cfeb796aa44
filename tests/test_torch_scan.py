"""Weight-stacked blocks (``nn.ScannedBlocks``) against the JAX package's.

Counterparts of ``tests/test_scanned_blocks.py``, with the JAX stack as
the reference on the same stacked weights (f32):

- ``ScannedBlocks`` of [Dense, BatchNorm, relu] blocks: the train-mode
  forward, the stacked running statistics after it and the gradients of
  every stacked leaf, rtol 1e-5 (the gradients atol 1e-5 too: three
  BatchNorm backwards sum in another order); eval mode leaves the state
  as it is; the
  validations; Dropout inside the blocks draws JAX's masks (one key split
  into S streams).
- ``transformer_lm(scan=True)``: the parameter tree is JAX's; 3 ``fit``
  steps (``SGD(0.05, momentum=0.9)``) without remat, with remat, and with
  remat under ``dots_with_no_batch_dims_saveable``: losses rtol 1e-5,
  every parameter atol 1e-5; the overlap record names the stack; greedy
  ``generate`` token-exact against JAX's and against the unrolled LM given
  the same weights restacked; the Engine token-exact against the JAX
  Engine with the reference and fused reads, the prefix cache with a
  copy-on-write (``cow_copies > 0``), int8 KV, preemption, a speculative
  self-draft, and ``update_weights`` into the stacked snapshot.
- A Dropout stack trained by ``fit``: JAX's step keys (``fold_in(PRNGKey(
  seed + 1), step)``), under ``grad_accum`` and K-step dispatches too.
- ``resnet(scan_stages=True)``: parameter and state paths are JAX's; the
  train forward (rtol/atol 1e-4, as the unscanned ResNet's train-mode
  test) and its stacked BatchNorm statistics (1e-5), and 2 ``fit`` steps
  at data seed 7: losses rtol 1e-5, parameters and state atol 1e-4. This
  model is as seed-sensitive as the unscanned tiny ResNet
  (``tests/resnet_seed_sweep.py``): over data seeds 0-7, JAX against JAX
  with its initial parameters moved by ``1 + 2e-7 z`` parts by 4e-5 to
  4e-2 in the parameters after 2 steps, and by less than 1e-4 only at
  seed 7, where the port parts from JAX by 4.2e-5.
- Checkpoints of a scanned LM (with Adam's state) and of a scanned ResNet
  (with its stacked state) restore across the packages both ways.
- ``quant.quantize_model`` on a scanned LM: the stacked leaves quantize
  to JAX's ``q`` and shared ``scale`` bit for bit, and a forward then
  raises ``ValueError`` as JAX's ``lax.scan`` does.
- A template whose attention and MLP residuals are each wrapped in
  ``nn.Remat`` (the default policy, ``dots_with_no_batch_dims_saveable``,
  and the default with a ``Remat`` around the whole block as well): the
  stack's forward and gradients against JAX's (rtol 1e-5), 3 ``fit``
  steps against JAX (losses rtol 1e-5, parameters atol 1e-5), and bit
  for bit the unrolled ``transformer_lm(remat=True)`` given the same
  weights, alone and under ``FSDP``'s overlapped gathers at world 1.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import jax_engine, jax_model, lm_pair

torch.set_num_threads(1)

V = 64
DOTS = jax.checkpoint_policies.dots_with_no_batch_dims_saveable


def _flat(tree):
    return dtt.interop.flatten_tree(jax.device_get(tree))


def _load_block_stack(jlayer, player, shape, seed=0):
    """Init the JAX layer, build the port's and give it the JAX weights
    and state; returns (params, state) of the JAX layer."""
    params, state, _ = jlayer.init(jax.random.PRNGKey(seed), shape)
    player.build(shape, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for path, v in dtt.interop.params_from_jax(
                jax.device_get(params)).items():
            player.get_parameter(path.replace("/", ".")).copy_(v)
        for path, v in dtt.interop.state_from_jax(
                jax.device_get(state)).items():
            player.get_buffer(path.replace("/", ".")).copy_(v)
    return params, state


def _bn_block(pkg):
    return lambda: pkg.nn.Sequential([pkg.nn.Dense(8), pkg.nn.BatchNorm(),
                                      pkg.nn.Activation("relu")])


# ------------------------------------------------------------ the layer
def test_scanned_blocks_forward_state_and_gradients_match_jax():
    js = dtpu.nn.ScannedBlocks(_bn_block(dtpu), 3)
    ps = dtt.nn.ScannedBlocks(_bn_block(dtt), 3)
    params, state = _load_block_stack(js, ps, (8,))
    assert sorted(dtt.nn.core.param_tree(ps)) == sorted(_flat(params))
    assert sorted(dtt.nn.core.state_tree(ps)) == sorted(_flat(state))
    assert ps.blocks.dense.kernel.shape == (3, 8, 8)
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)

    def loss(p):
        y, s = js.apply(p, state, jax.numpy.asarray(x), train=True)
        return jax.numpy.sum(y ** 2), (y, s)

    (_, (want_y, want_s)), want_g = jax.value_and_grad(
        loss, has_aux=True)(params)
    ps.train()
    y = ps(torch.from_numpy(x))
    grads = torch.autograd.grad(torch.sum(y ** 2), list(ps.parameters()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    got_s = dtt.interop.state_to_numpy(dtt.nn.core.state_tree(ps))
    for path, w in _flat(want_s).items():
        np.testing.assert_allclose(got_s[path], w, rtol=1e-5, atol=1e-7,
                                   err_msg=path)
    want_g = _flat(want_g)
    for (name, _), g in zip(ps.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[name.replace(".", "/")],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # Eval mode: the running statistics normalize and stay as they are.
    ps.eval()
    before = {k: v.clone() for k, v in dtt.nn.core.state_tree(ps).items()}
    ye, _ = js.apply(params, want_s, jax.numpy.asarray(x), train=False)
    with torch.no_grad():
        got_e = ps(torch.from_numpy(x))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ye), rtol=1e-5,
                               atol=1e-6)
    for k, v in dtt.nn.core.state_tree(ps).items():
        assert torch.equal(v, before[k]), k


def test_scanned_blocks_validations():
    with pytest.raises(ValueError, match="num_blocks"):
        dtt.nn.ScannedBlocks(_bn_block(dtt), 0)
    with pytest.raises(ValueError, match="overlap"):
        dtt.nn.ScannedBlocks(_bn_block(dtt), 2, overlap="sometimes")
    with pytest.raises(ValueError, match="preserve shape"):
        dtt.nn.ScannedBlocks(lambda: dtt.nn.Dense(4), 2).build(
            (8,), torch.Generator())
    with pytest.raises(ValueError, match="parameterized"):
        dtt.nn.ScannedBlocks(lambda: dtt.nn.Activation("relu"), 2).build(
            (8,), torch.Generator())
    # Decode delegates to the template: a position-mixing layer without a
    # cached override still fails loudly.
    sb = dtt.nn.ScannedBlocks(lambda: dtt.nn.Sequential(
        [dtt.nn.Dense(8), dtt.nn.Lambda(lambda x: x * 2.0)]), 2)
    sb.build((8,), torch.Generator())
    with pytest.raises(NotImplementedError):
        sb.decode(sb.init_cache(1, 4, torch.float32, "cpu"),
                  torch.zeros((1, 1, 8)), pos=0)
    # "require" without a strategy that gathers raises JAX's error; under
    # FSDP (a world-1 group here) it runs, its gathers overlapped, and
    # gives the plain stack's output.
    req = dtt.nn.ScannedBlocks(_bn_block(dtt), 2, overlap="require")
    req.build((8,), torch.Generator().manual_seed(1))
    req.eval()
    with pytest.raises(ValueError, match="overlap_spec gather"):
        req(torch.zeros((4, 8)))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32))
    with torch.no_grad():
        off = dtt.nn.ScannedBlocks(_bn_block(dtt), 2, overlap="off")
        off.build((8,), torch.Generator().manual_seed(1))
        off.eval()
        plain = off(x)
        try:
            with dtt.FSDP(device="cpu").scope():
                got = req(x)
                assert dtt.nn.scan.last_overlap_trace() == {
                    "layers": 2, "active": True}
        finally:
            dtt.cluster.shutdown()
    assert torch.equal(got, plain)
    # The stacked dtype hints pass through one level down.
    bf = dtt.nn.ScannedBlocks(lambda: dtt.nn.Sequential(
        [dtt.nn.Dense(8, dtype="bfloat16")]), 2)
    assert bf.dtype_hints() == {"blocks": {"dense": "bfloat16"}}
    assert dtt.nn.ScannedBlocks(_bn_block(dtt), 2).dtype_hints() == {}
    # JAX's errors for stacking with MoE or pipelines come first.
    for kw in (dict(pipeline=True), dict(moe_experts=2)):
        with pytest.raises(ValueError):
            dtt.models.transformer_lm(64, scan=True, **kw)
        with pytest.raises(ValueError):
            dtpu.models.transformer_lm(64, scan=True, **kw)


def test_scanned_blocks_dropout_routes_jax_keys():
    def block(pkg):
        return lambda: pkg.nn.Sequential([pkg.nn.Dense(8),
                                          pkg.nn.Dropout(0.5)])

    js = dtpu.nn.ScannedBlocks(block(dtpu), 2)
    ps = dtt.nn.ScannedBlocks(block(dtt), 2)
    params, state = _load_block_stack(js, ps, (8,))
    assert ps.needs_rng and js.needs_rng
    x = np.ones((4, 8), np.float32)
    ps.train()
    outs = []
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        want, _ = js.apply(params, state, jax.numpy.asarray(x), train=True,
                           rng=key)
        with dtt.nn.rng_scope(np.asarray(jax.random.key_data(key))):
            got = ps(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        outs.append(got)
    assert not np.allclose(outs[0], outs[1])


# ------------------------------------------------------------- the LM
def _lm_kw(**kw):
    return dict(vocab=V, num_layers=3, d_model=32, num_heads=4, max_len=64,
                scan=True, **kw)


def _lm_data(seed=0, n=8, t=16):
    tok = np.random.default_rng(seed).integers(0, V, (n, t + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def restack(params, num_layers):
    """The unrolled LM's ``{path: tensor}`` parameters as the scanned LM's:
    ``residual_{2i}``/``residual_{2i+1}`` stacked into
    ``scanned_blocks/blocks/residual`` and ``.../residual_1``."""
    out, per = {}, {}
    for path, t in params.items():
        head, _, rest = path.partition("/")
        if not head.startswith("residual"):
            out[path] = t
            continue
        i = 0 if head == "residual" else int(head.split("_")[1])
        slot = "residual" if i % 2 == 0 else "residual_1"
        per.setdefault(f"scanned_blocks/blocks/{slot}/{rest}", {})[
            i // 2] = t
    for path, d in per.items():
        out[path] = torch.stack([d[i] for i in range(num_layers)])
    return out


@pytest.mark.parametrize("remat,policy", [(False, None), (True, None),
                                          (True, DOTS)],
                         ids=["plain", "remat", "remat_dots"])
def test_scanned_lm_fit_matches_jax(remat, policy):
    jm, pm = lm_pair(**_lm_kw(remat=remat, remat_policy=policy))
    assert sorted(pm.params) == sorted(_flat(jm.params))
    assert pm.params[
        "scanned_blocks/blocks/residual_1/main/dense/kernel"].shape == (
            3, 32, 128)
    for m, pkg in ((jm, dtpu), (pm, dtt)):
        m.compile(optimizer=pkg.optim.SGD(0.05, momentum=0.9),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    x, y = _lm_data()
    fit = dict(batch_size=4, epochs=3, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)
    hj = jm.fit(x, y, **fit).history
    hp = pm.fit(x, y, **fit).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    want = _flat(jm.params)
    for path, got in dtt.interop.params_to_numpy(pm.params).items():
        np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-5,
                                   err_msg=path)
    rep = pm.last_fit_telemetry["overlap"]
    assert rep == {"overlap": False, "exposed_comm_fraction": 1.0,
                   "layers": 3}
    assert rep == jm.last_fit_telemetry["overlap"]
    # 2 (embedding, positions) + 16 stacked leaves + 4 (norm, head)
    assert len(pm.params) == 22


@pytest.fixture(scope="module")
def served():
    """The scanned LM in both packages on the same weights, and an
    unrolled port LM holding them restacked the other way."""
    jm, pm = lm_pair(**_lm_kw())
    unrolled = jax_model(dtpu.models.transformer_lm(
        V, num_layers=3, d_model=32, num_heads=4, max_len=64), (16,), seed=3)
    un = dtt.Model(dtt.models.transformer_lm(
        V, num_layers=3, d_model=32, num_heads=4, max_len=64),
        device="cpu").build((16,))
    un.load_params(dtt.interop.params_from_jax(jax.device_get(
        unrolled.params)))
    pm.load_params(restack(un.params, 3))
    jm.params = jax.tree_util.tree_map(
        jax.numpy.asarray, dtt.checkpoint.core.unflatten_tree(
            dtt.interop.params_to_numpy(pm.params)))
    return jm, pm, un, {}


def test_scanned_generate_matches_jax_and_unrolled(served):
    jm, pm, un, _ = served
    prompt = np.array([[5, 9, 2, 11], [1, 1, 3, 60]], np.int32)
    want = np.asarray(jm.generate(prompt, 8, temperature=0.0))
    np.testing.assert_array_equal(pm.generate(prompt, 8, temperature=0.0),
                                  want)
    np.testing.assert_array_equal(un.generate(prompt, 8, temperature=0.0),
                                  want)
    sampled = np.asarray(jm.generate(prompt, 6, temperature=0.8, seed=4))
    np.testing.assert_array_equal(
        pm.generate(prompt, 6, temperature=0.8, seed=4), sampled)
    x = np.random.default_rng(2).integers(0, V, (2, 16)).astype(np.int32)
    np.testing.assert_allclose(pm.predict(x, batch_size=2),
                               un.predict(x, batch_size=2), rtol=1e-5,
                               atol=1e-6)


def _serve_requests():
    """A shared 16-token head (4 full blocks of 4): the third request's
    prompt IS the head, so its last cached block is copied on write."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, V, (16,)).astype(np.int32)
    prompts = [np.concatenate([head, [3]]), np.concatenate([head, [9, 4]]),
               head.copy(), rng.integers(0, V, (7,)).astype(np.int32),
               np.concatenate([head, [17]])]
    return [(p.astype(np.int32), m) for p, m in zip(prompts, (6, 7, 5, 8, 6))]


SERVE = {
    # name: (engine kwargs, telemetry counter that must be > 0)
    "reference": ({}, None),
    "fused_prefix": (dict(decode_kernel="fused", prefix_cache=True), None),
    "reference_prefix_int8": (dict(prefix_cache=True, kv_dtype="int8"),
                              None),
    "fused_int8": (dict(decode_kernel="fused", kv_dtype="int8"), None),
    "preemption": (dict(num_blocks=9), "preemptions"),
}


@pytest.mark.parametrize("config", sorted(SERVE))
def test_scanned_engine_token_exact_vs_jax(served, config):
    jm, pm, _, memo = served
    eng_kw, must_fire = SERVE[config]
    reqs = _serve_requests()
    kw = dict(max_slots=2, block_size=4, max_len=64)
    jax_kw = {k: v for k, v in eng_kw.items() if k != "decode_kernel"}
    key = tuple(sorted(jax_kw.items()))
    if key not in memo:
        memo[key] = jax_engine(jm, **kw, **jax_kw).run(
            [dtpu.serving.Request(p, m) for p, m in reqs])
    eng = dtt.serving.Engine(pm, **kw, **eng_kw)
    got = eng.run([dtt.serving.Request(p, m) for p, m in reqs])
    for i, (w, g) in enumerate(zip(memo[key], got)):
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=f"{config} request {i}")
    tel = eng.last_run_telemetry
    if must_fire:
        assert tel[must_fire] > 0
    if eng_kw.get("prefix_cache"):
        assert eng.kv.cow_copies > 0 and tel["prefix_cache"]["hit_blocks"]
    pools = eng.kv.caches["scanned_blocks"]["stacked"]
    leaf = pools["residual"]["main"]["multi_head_attention"]["k"]
    leaf = leaf["q"] if isinstance(leaf, dict) else leaf
    assert leaf.shape[0] == 3  # (S, num_blocks, block_size, H, hd)


def test_stacked_pool_bytes_and_copy_on_write():
    """A stacked pool's block is its S slices: bytes_per_block counts them
    and copy-on-write copies along axis 1, in every slice."""
    pm = lm_pair(**_lm_kw())[1]
    un = dtt.Model(dtt.models.transformer_lm(
        V, num_layers=3, d_model=32, num_heads=4, max_len=64),
        device="cpu").build((16,))
    for kv in (None, "int8"):
        a = dtt.serving.Engine(pm, max_slots=2, block_size=4, max_len=64,
                               kv_dtype=kv)
        b = dtt.serving.Engine(un, max_slots=2, block_size=4, max_len=64,
                               kv_dtype=kv)
        assert a.kv.bytes_per_block() == b.kv.bytes_per_block() > 0
    kv = a.kv
    for leaf, stacked in dtt.serving.kv_cache._pool_leaves(kv.caches):
        assert stacked
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape).to(
            leaf.dtype))
    (old,) = kv._allocate(1)
    kv.allocator.incref([old])  # shared: a second reference
    kv._slot_blocks[0] = [old]
    kv.block_tables[0, 0] = old
    assert kv._copy_block(0, 0) and kv.cow_copies == 1
    new = kv._slot_blocks[0][0]
    assert new != old
    for leaf, _ in dtt.serving.kv_cache._pool_leaves(kv.caches):
        assert torch.equal(leaf[:, new], leaf[:, old])
        assert not torch.equal(leaf[:, new], leaf[:, 0])


def test_scanned_engine_spec_and_hot_swap(served):
    jm, pm, _, memo = served
    reqs = _serve_requests()
    kw = dict(max_slots=2, block_size=4, max_len=64)
    key = ()
    if key not in memo:
        memo[key] = jax_engine(jm, **kw).run(
            [dtpu.serving.Request(p, m) for p, m in reqs])
    for kind in ("reference", "fused"):
        spec = dtt.serving.Engine(pm, draft_model=pm, spec_k=4,
                                  decode_kernel=kind, **kw)
        got = spec.run([dtt.serving.Request(p, m) for p, m in reqs])
        for w, g in zip(memo[key], got):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert spec.last_run_telemetry["speculative"]["rounds"] > 0
    # update_weights into the stacked snapshot: the served tokens are the
    # new weights', as a fresh engine's.
    other = lm_pair(**_lm_kw(seed=9))[1]
    eng = dtt.serving.Engine(pm, **kw)
    eng.update_weights(other.params)
    got = eng.run([dtt.serving.Request(p, m) for p, m in reqs])
    fresh = dtt.serving.Engine(other, **kw).run(
        [dtt.serving.Request(p, m) for p, m in reqs])
    for a, b in zip(got, fresh):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------- Dropout under fit
def _dropout_stack(pkg):
    nn = pkg.nn
    return nn.Sequential([
        nn.Dense(16),
        nn.ScannedBlocks(lambda: nn.Sequential(
            [nn.Dense(16, activation="relu"), nn.Dropout(0.3)]), 2),
        nn.Dropout(0.2), nn.Dense(4)])


@pytest.mark.parametrize("how", ["plain", "grad_accum", "k_steps"])
def test_dropout_fit_uses_jax_step_keys(how):
    jm = jax_model(_dropout_stack(dtpu), (8,), seed=0)
    pm = dtt.Model(_dropout_stack(dtt), device="cpu").build((8,))
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    for m, pkg in ((jm, dtpu), (pm, dtt)):
        m.compile(optimizer=pkg.optim.SGD(0.1),
                  loss="sparse_categorical_crossentropy",
                  steps_per_execution=2 if how == "k_steps" else None)
        m._seed = 11  # the step keys come from the build seed
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = rng.integers(0, 4, (32,)).astype(np.int32)
    fit = dict(batch_size=8, epochs=1, steps_per_epoch=4, shuffle=False,
               verbose=0, grad_accum=2 if how == "grad_accum" else None)
    hj = jm.fit(x, y, **fit).history
    hp = pm.fit(x, y, **fit).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    want = _flat(jm.params)
    for path, got in dtt.interop.params_to_numpy(pm.params).items():
        np.testing.assert_allclose(got, want[path], rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def test_dropout_k_steps_equal_k1_bit_for_bit():
    runs = []
    for k in (None, 4):
        m = dtt.Model(_dropout_stack(dtt), device="cpu").build((8,), seed=2)
        m.compile(optimizer=dtt.optim.SGD(0.1),
                  loss="sparse_categorical_crossentropy",
                  steps_per_execution=k)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((32, 8)).astype(np.float32)
        y = rng.integers(0, 4, (32,)).astype(np.int32)
        m.fit(x, y, batch_size=8, epochs=1, steps_per_epoch=4, verbose=0)
        runs.append(m.params)
    for path, t in runs[0].items():
        assert torch.equal(t, runs[1][path]), path


# ----------------------------------------------------------- ResNet
TINY = dict(small_inputs=True, stage_blocks=(2, 3, 1, 1), width=16,
            scan_stages=True)


def _resnet_pair():
    jm = jax_model(dtpu.models.resnet(50, 10, **TINY), (16, 16, 3))
    pm = dtt.Model(dtt.models.resnet(50, 10, **TINY),
                   device="cpu").build((16, 16, 3))
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    pm.load_state(dtt.interop.state_from_jax(jax.device_get(jm.state)))
    return jm, pm


def test_scanned_resnet_trees_forward_and_fit_match_jax():
    jm, pm = _resnet_pair()
    assert sorted(pm.params) == sorted(_flat(jm.params))
    assert sorted(pm.state) == sorted(_flat(jm.state))
    assert pm.state["scanned_blocks_1/blocks/main/batch_norm/mean"].shape \
        == (2, 32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, (16,)).astype(np.int32)
    # Train-mode forward: logits and the stacked running statistics.
    want, want_s = jm.module.apply(jm.params, jm.state,
                                   jax.numpy.asarray(x[:8]), train=True)
    pm.module.train()
    with torch.no_grad():
        got = pm.module(torch.from_numpy(x[:8]))
    pm.module.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    got_s = dtt.interop.state_to_numpy(pm.state)
    for path, w in _flat(want_s).items():
        np.testing.assert_allclose(got_s[path], w, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    jm, pm = _resnet_pair()
    for m, pkg in ((jm, dtpu), (pm, dtt)):
        m.compile(optimizer=pkg.optim.SGD(0.05, momentum=0.9),
                  loss="sparse_categorical_crossentropy")
    fit = dict(batch_size=8, epochs=2, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)
    hj = jm.fit(x, y, **fit).history
    hp = pm.fit(x, y, **fit).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    for tree, want in ((pm.params, jm.params), (pm.state, jm.state)):
        want = _flat(want)
        for path, got in dtt.interop.params_to_numpy(tree).items():
            np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-4,
                                       err_msg=path)


def test_scanned_resnet_k_steps_under_data_parallel_raise_on_the_card():
    model = dtt.Model(dtt.models.resnet(50, 10, **TINY), device="cpu")
    model.strategy = dtt.DataParallel.__new__(dtt.DataParallel)
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        model._check_capturable()
    plain = dtt.nn.Sequential([dtt.nn.Dense(4), dtt.nn.ScannedBlocks(
        lambda: dtt.nn.Sequential([dtt.nn.Dense(4), dtt.nn.BatchNorm()]),
        2)])
    assert dtt.training.model._has_batch_norm(plain)


# ------------------------------------------------------- checkpoints
def test_scanned_checkpoints_restore_across_packages(tmp_path):
    jm, pm = lm_pair(**_lm_kw())
    for m, pkg in ((jm, dtpu), (pm, dtt)):
        m.compile(optimizer=pkg.optim.Adam(1e-3),
                  loss="sparse_categorical_crossentropy")
    x, y = _lm_data()
    fit = dict(batch_size=4, epochs=1, steps_per_epoch=2, verbose=0)
    jm.fit(x, y, **fit)
    pm.fit(x, y, **fit)
    # JAX -> port.
    dtpu.Checkpointer(tmp_path / "jax").save(jm, step=2)
    fresh = lm_pair(**_lm_kw(seed=4))[1]
    fresh.compile(optimizer=dtt.optim.Adam(1e-3),
                  loss="sparse_categorical_crossentropy")
    dtt.Checkpointer(tmp_path / "jax").restore_into(fresh)
    want = _flat(jm.params)
    for path, got in dtt.interop.params_to_numpy(fresh.params).items():
        np.testing.assert_array_equal(got, want[path], err_msg=path)
    tree = dtt.interop.opt_state_to_tree(fresh.tx, fresh.opt_state,
                                         fresh.params)
    jflat = _flat(jm.opt_state)
    for path, leaf in dtt.interop.iter_leaf_paths(tree):
        a = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        np.testing.assert_array_equal(np.asarray(a), jflat[path],
                                      err_msg=path)
    # Port -> JAX.
    dtt.Checkpointer(tmp_path / "port").save(pm, step=2)
    back = lm_pair(**_lm_kw(seed=5))[0]
    back.compile(optimizer=dtpu.optim.Adam(1e-3),
                 loss="sparse_categorical_crossentropy")
    dtpu.Checkpointer(tmp_path / "port").restore_into(back)
    want = dtt.interop.params_to_numpy(pm.params)
    for path, got in _flat(back.params).items():
        np.testing.assert_array_equal(got, want[path], err_msg=path)
    got_opt = _flat(back.opt_state)
    for path, leaf in dtt.interop.iter_leaf_paths(
            dtt.interop.opt_state_to_tree(pm.tx, pm.opt_state, pm.params)):
        a = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        np.testing.assert_array_equal(got_opt[path], np.asarray(a),
                                      err_msg=path)


def test_scanned_resnet_weights_cross_packages(tmp_path):
    jm, pm = _resnet_pair()
    pm.compile(optimizer=dtt.optim.SGD(0.05, momentum=0.9),
               loss="sparse_categorical_crossentropy")
    x = np.random.default_rng(5).standard_normal((8, 16, 16, 3)).astype(
        np.float32)
    pm.fit(x, np.zeros(8, np.int32), batch_size=8, epochs=1, verbose=0)
    path = str(tmp_path / "w.npz")
    pm.save_weights(path)
    jm.load_weights(path)
    for tree, got in ((pm.params, jm.params), (pm.state, jm.state)):
        want = dtt.interop.params_to_numpy(tree)
        for p, g in _flat(got).items():
            np.testing.assert_array_equal(g, want[p], err_msg=p)
    back = dtt.Model(dtt.models.resnet(50, 10, **TINY),
                     device="cpu").build((16, 16, 3), seed=3)
    jm.save_weights(str(tmp_path / "j.npz"))
    back.load_weights(str(tmp_path / "j.npz"))
    for p, t in back.state.items():
        assert torch.equal(t, pm.state[p]), p


# -------------------------------------------------------- quant x scan
def test_quantize_scanned_lm_like_jax():
    jm, pm = lm_pair(**_lm_kw())
    dtpu.quant.quantize_model(jm)
    dtt.quant.quantize_model(pm)
    want = _flat(jm.params)
    got = dtt.interop.params_to_numpy(pm.params)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # One scale per output channel, shared by the S blocks: JAX's scan
    # refuses the tree, and so does the port's stack.
    assert got["scanned_blocks/blocks/residual_1/main/dense/kernel/scale"
               ].shape == (128,)
    x = np.zeros((2, 16), np.int32)
    with pytest.raises(ValueError, match="different leading axis sizes"):
        jm.predict(x, batch_size=2)
    with pytest.raises(ValueError, match="different leading axis sizes"):
        pm.predict(x, batch_size=2)


# ------------------------------------- the trainer's options over a stack
@pytest.mark.parametrize("option", [
    dict(compile=dict(head_chunks=2)),
    dict(compile=dict(precision="mixed_bfloat16")),
    dict(compile=dict(grad_clip=0.5, gradient_accumulation_steps=2),
         rtol=1e-6),
    dict(fit=dict(grad_accum=2)),
    dict(compile=dict(steps_per_execution=2)),
    dict(lm=dict(remat=True, remat_policy="dots_saveable"))],
    ids=["head_chunks", "mixed_bfloat16", "clip_multisteps", "grad_accum",
         "k_steps", "remat_dots"])
def test_scanned_lm_equals_unrolled_under_trainer_options(option):
    """fit, evaluate and predict over the stack give the unrolled LM's
    numbers bit for bit, given the same weights (the port builds the same
    draws for both: the stack's blocks are drawn in the unrolled order).
    With ``grad_clip`` the global norm sums leaf by leaf, and 22 stacked
    leaves group the terms otherwise than 38: there the parameters agree
    to rtol 1e-6."""
    kw = dict(num_layers=2, d_model=32, num_heads=2, max_len=64,
              **option.get("lm", {}))
    models = []
    for scan in (False, True):
        m = dtt.Model(dtt.models.transformer_lm(V, scan=scan, **kw),
                      device="cpu").build((16,), seed=1)
        m.compile(optimizer=dtt.optim.Adam(1e-3),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"], **option.get("compile", {}))
        models.append(m)
    un, sc = models
    assert all(torch.equal(t, sc.params[p]) for p, t in
               restack(un.params, 2).items())
    x, y = _lm_data(n=8)
    hist = [m.fit(x, y, batch_size=4, epochs=1, steps_per_epoch=2,
                  shuffle=False, verbose=0, **option.get("fit", {})).history
            for m in models]
    rtol = option.get("rtol")
    if rtol:
        np.testing.assert_allclose(hist[1]["loss"], hist[0]["loss"],
                                   rtol=rtol)
        for p, t in restack(un.params, 2).items():
            np.testing.assert_allclose(sc.params[p].detach().numpy(),
                                       t.detach().numpy(), rtol=rtol,
                                       atol=1e-7, err_msg=p)
        return
    assert hist[0] == hist[1]
    for p, t in restack(un.params, 2).items():
        assert torch.equal(t, sc.params[p]), p
    assert un.evaluate(x, y, batch_size=4, verbose=0) == sc.evaluate(
        x, y, batch_size=4, verbose=0)
    assert np.array_equal(un.predict(x, batch_size=4),
                          sc.predict(x, batch_size=4))


def test_stacked_dtype_hints_in_cast_to_compute():
    """``Policy.cast_to_compute`` over the scanned LM's nested tree skips
    the stacked subtrees of layers with their own dtype, as JAX's does."""
    jm, pm = lm_pair(**dict(_lm_kw(), dtype="bfloat16"))
    hints = pm.module.dtype_hints()
    assert hints["scanned_blocks"]["blocks"]["residual_1"]["main"] == {
        "dense": "bfloat16", "dense_1": "bfloat16"}
    pol = dtt.precision.Policy("mixed_bfloat16")
    tree = dtt.checkpoint.core.unflatten_tree(
        {k: v.detach() for k, v in pm.params.items()})
    cast = dict(dtt.interop.iter_leaf_paths(pol.cast_to_compute(tree, hints)))
    jpol = dtpu.precision.Policy("mixed_bfloat16")
    want = dtt.interop.flatten_tree(jax.device_get(
        jpol.cast_to_compute(jm.params, jm.module.dtype_hints())))
    assert sorted(cast) == sorted(want)
    for path, leaf in want.items():
        assert str(leaf.dtype) == str(cast[path].dtype).replace(
            "torch.", ""), path


# ------------------------------------------- a Remat inside the template
def inner_remat_lm(pkg, policy, *, outer=False, num_layers=3, d_model=32,
                   num_heads=4, max_len=64, scan_overlap="auto"):
    """The scanned LM whose template wraps its attention residual and its
    MLP residual each in ``nn.Remat(policy=)`` (``outer``: the template
    wrapped whole in one more ``Remat``); the tree paths are
    ``transformer_lm(scan=True)``'s."""
    nn = pkg.nn

    def make_block():
        block = nn.Sequential([
            nn.Remat(r, policy=policy) for r in
            pkg.models.transformer.transformer_block(
                d_model, num_heads, 4 * d_model)])
        return nn.Remat(block, policy=policy) if outer else block

    return nn.Sequential([
        nn.Embedding(V, d_model), nn.PositionalEmbedding(max_len),
        nn.ScannedBlocks(make_block, num_layers, overlap=scan_overlap),
        nn.LayerNorm(), nn.Dense(V)], name="transformer_lm")


INNER = [(None, False), (DOTS, False), (None, True)]
INNER_IDS = ["default", "dots", "default_outer"]


@pytest.mark.parametrize("policy,outer", INNER, ids=INNER_IDS)
def test_inner_remat_template_forward_and_gradients_match_jax(policy,
                                                              outer):
    """The stack alone: forward and the gradients of every stacked leaf
    (of a fixed random projection of the output) against JAX's
    ``ScannedBlocks`` of the same template, rtol 1e-5."""
    def stack(pkg):
        return inner_remat_lm(pkg, policy, outer=outer).layers[2]

    js, ps = stack(dtpu), stack(dtt)
    params, state = _load_block_stack(js, ps, (16, 32))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = rng.standard_normal((2, 16, 32)).astype(np.float32) / 16

    def loss(p):
        y, _ = js.apply(p, state, jax.numpy.asarray(x), train=True)
        return jax.numpy.sum(y * w), y

    (_, want_y), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    ps.train()
    y = ps(torch.from_numpy(x))
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)),
                                list(ps.parameters()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    want_g = _flat(want_g)
    assert sorted(want_g) == sorted(
        n.replace(".", "/") for n, _ in ps.named_parameters())
    for (name, _), g in zip(ps.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[name.replace(".", "/")],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("policy,outer", INNER, ids=INNER_IDS)
def test_inner_remat_template_fit_matches_jax(policy, outer):
    jm = jax_model(inner_remat_lm(dtpu, policy, outer=outer), (16,))
    pm = dtt.Model(inner_remat_lm(dtt, policy, outer=outer),
                   device="cpu").build((16,))
    pm.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    assert sorted(pm.params) == sorted(_flat(jm.params))
    for m, pkg in ((jm, dtpu), (pm, dtt)):
        m.compile(optimizer=pkg.optim.SGD(0.05, momentum=0.9),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    x, y = _lm_data()
    fit = dict(batch_size=4, epochs=3, steps_per_epoch=1, shuffle=True,
               seed=0, verbose=0)
    hj = jm.fit(x, y, **fit).history
    hp = pm.fit(x, y, **fit).history
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=1e-5)
    want = _flat(jm.params)
    for path, got in dtt.interop.params_to_numpy(pm.params).items():
        np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("policy", [None, DOTS], ids=["default", "dots"])
def test_inner_remat_template_equals_unrolled_remat_lm(policy):
    """Given the same weights, the template of inner Remats trains bit for
    bit as the unrolled ``transformer_lm(remat=True)`` (every residual a
    Remat), and as itself under ``FSDP``'s overlapped gathers at world 1
    (an in-process gloo group)."""
    kw = dict(num_layers=2, d_model=32, num_heads=2, max_len=64)
    un = dtt.Model(dtt.models.transformer_lm(V, remat=True,
                                             remat_policy=policy, **kw),
                   device="cpu").build((16,), seed=1)
    start = {p: t.detach().clone()
             for p, t in restack(un.params, 2).items()}
    x, y = _lm_data(n=8)

    def fit(m):
        m.compile(optimizer=dtt.optim.Adam(1e-3),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        return m.fit(x, y, batch_size=4, epochs=1, steps_per_epoch=2,
                     shuffle=False, verbose=0).history

    want_hist = fit(un)
    want = restack(un.params, 2)
    sc = dtt.Model(inner_remat_lm(dtt, policy, **kw), device="cpu")
    sc.build((16,), seed=1).load_params(start)
    assert fit(sc) == want_hist
    for p, t in want.items():
        assert torch.equal(t, sc.params[p]), p
    try:
        with dtt.FSDP(device="cpu").scope():
            fs = dtt.Model(inner_remat_lm(dtt, policy, **kw))
        fs.build((16,), seed=1).load_params(start)
        assert fit(fs) == want_hist
        assert fs.last_fit_telemetry["overlap"][
            "exposed_comm_fraction"] == 0.5
        for p, t in want.items():
            assert torch.equal(t, fs.params[p]), p
    finally:
        dtt.cluster.shutdown()
