"""Int8 weight-only quantization in the port against the JAX package's.

``quantize_leaf``/``quantize_tree``/``quantize_model`` give the JAX
package's ``q`` and ``scale`` bit for bit on the same numpy weights
(per-output-channel scales on the last axis, an all-zero channel's scale
1, 1-D leaves kept f32, ``min_ndim``); ``tree_param_bytes`` and
``abstract_quantize_tree`` price trees alike. A quantized LM (vocab 64, 2
layers, d_model 32, 2 heads) on the same weights: ``predict`` within
rtol 1e-5, atol 1e-6 of JAX's in f32; served by the Engine, its tokens
equal the JAX Engine's (built by ``torch_parity.jax_engine``), greedy and
sampled, with f32 and int8 KV pools, for each read path.

With bf16 layers the two packages round the compute differently (XLA
keeps fused bf16 chains at f32; the port rounds each operation), so a
greedy request may part from JAX's where two logits tie within bf16
rounding; this happens unquantized too. There the tokens must equal JAX's
up to the first position where they differ, and at that position JAX's
own two best logits (teacher-forced on JAX's tokens) must lie within 4
bf16 ulps of each other. ``fit`` on a quantized model raises, and
``Engine.update_weights`` refuses a tree whose leaves are not the served
dtypes.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from torch_parity import jax_engine, lm_pair

torch.set_num_threads(1)

V, T = 64, 64


def _weights():
    rng = np.random.default_rng(0)
    zero = rng.standard_normal((6, 5)).astype(np.float32)
    zero[:, 2] = 0.0  # an all-zero output channel: scale 1
    return {
        "dense": rng.standard_normal((12, 7)).astype(np.float32),
        "zero": zero,
        "conv": (rng.standard_normal((3, 3, 4, 8)) * 5).astype(np.float32),
        "tiny": (rng.standard_normal((9, 3)) * 1e-30).astype(np.float32),
        "bias": rng.standard_normal((7,)).astype(np.float32),
        "count": np.arange(6, dtype=np.int32).reshape(2, 3),
    }


def _flat(tree):
    out = {}
    for path, leaf in dtt.interop.iter_leaf_paths(tree):
        out[path] = (leaf.numpy() if isinstance(leaf, torch.Tensor)
                     else np.asarray(jax.device_get(leaf)))
    return out


@pytest.mark.parametrize("min_ndim", [1, 2, 3])
def test_quantize_tree_bit_identical_to_jax(min_ndim):
    w = _weights()
    want = _flat(dtpu.quant.quantize_tree(w, min_ndim=min_ndim))
    got = _flat(dtt.quant.quantize_tree(w, min_ndim=min_ndim))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert got["zero/scale"][2] == 1.0 if min_ndim <= 2 else True
    with pytest.raises(ValueError, match="already int8-quantized"):
        dtt.quant.quantize_tree(dtt.quant.quantize_tree(w))


def test_leaf_helpers_and_bytes_match_jax():
    w = _weights()
    jq, pq = dtpu.quant.quantize_tree(w), dtt.quant.quantize_tree(w)
    assert dtt.quant.tree_param_bytes(pq) == dtpu.quant.tree_param_bytes(jq)
    assert dtt.quant.tree_param_bytes(w) == dtpu.quant.tree_param_bytes(w)
    abstract = dtt.quant.abstract_quantize_tree(w)
    assert abstract["dense"]["q"].device.type == "meta"
    assert dtt.quant.tree_param_bytes(abstract) == \
        dtpu.quant.tree_param_bytes(dtpu.quant.abstract_quantize_tree(w))
    assert dtt.quant.is_quantized(pq) and not dtt.quant.is_quantized(w)
    assert dtt.quant.shape_of(pq["conv"]) == (3, 3, 4, 8)
    np.testing.assert_array_equal(
        dtt.quant.dequantize(pq["dense"], torch.bfloat16).float().numpy(),
        np.asarray(dtpu.quant.dequantize(jq["dense"], jax.numpy.bfloat16)
                   ).astype(np.float32))


@pytest.fixture(scope="module")
def quantized():
    """{dtype: (jax model, port model)}, both quantized, built once."""
    out = {}

    def get(dtype):
        if dtype not in out:
            jm, pm = lm_pair(vocab=V, num_layers=2, d_model=32,
                             num_heads=2, max_len=T, dtype=dtype)
            pm.compile(optimizer="adam")
            f32_bytes = dtt.quant.tree_param_bytes(pm.params)
            dtpu.quant.quantize_model(jm)
            dtt.quant.quantize_model(pm)
            out[dtype] = (jm, pm, f32_bytes)
        return out[dtype]

    return get


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_quantize_model_matches_jax(quantized, dtype):
    jm, pm, f32_bytes = quantized(dtype)
    want = dtt.interop.flatten_tree(jax.device_get(jm.params))
    got = dtt.interop.params_to_numpy(pm.params)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert pm.opt_state is None and dtt.quant.is_quantized(pm.module)
    assert not pm.state  # the int8 payloads are parameters, not state
    nbytes = dtt.quant.tree_param_bytes(pm.params)
    assert nbytes == dtpu.quant.tree_param_bytes(jm.params)
    assert 3.0 < f32_bytes / nbytes < 4.0  # 3.39 at this width
    with pytest.raises(ValueError, match="already int8-quantized"):
        dtt.quant.quantize_model(pm)
    # The quantized tree loads into a quantized model of the other package
    # (interop both ways) and back.
    other = dtt.Model(dtt.models.transformer_lm(
        V, num_layers=2, d_model=32, num_heads=2, max_len=T, dtype=dtype),
        device="cpu").build((16,), seed=9)
    dtt.quant.quantize_model(other)
    other.load_params(dtt.interop.params_from_jax(jax.device_get(jm.params)))
    for path, t in other.params.items():
        assert torch.equal(t, pm.params[path]), path


def test_predict_matches_jax_f32(quantized):
    jm, pm, _ = quantized(None)
    x = np.random.default_rng(1).integers(0, V, (3, 16)).astype(np.int32)
    np.testing.assert_allclose(pm.predict(x, batch_size=2),
                               np.asarray(jm.predict(x, batch_size=2)),
                               rtol=1e-5, atol=1e-6)


def _requests(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, (int(p),)).astype(np.int32), int(m))
            for p, m in zip(rng.integers(2, 14, n), rng.integers(4, 9, n))]


def _tie_at(jm, seq, pos, ulps=4):
    """True when JAX's two best logits for the token at ``pos`` of
    ``seq`` (teacher-forced) lie within ``ulps`` bf16 ulps of the best."""
    logits = np.asarray(jm.predict(seq[None, :pos], batch_size=1))[0, -1]
    top = np.sort(logits.astype(np.float64))[-2:]
    ulp = 2.0 ** (np.floor(np.log2(abs(top[1]))) - 7)
    return top[1] - top[0] <= ulps * ulp


@pytest.mark.parametrize("kind", ["reference", "fused"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_engine_on_a_quantized_lm_matches_the_jax_engine(
        quantized, dtype, temperature, kv_dtype, kind):
    jm, pm, _ = quantized(dtype)
    reqs = _requests()
    kw = dict(max_slots=2, block_size=8, max_len=T, kv_dtype=kv_dtype,
              temperature=temperature)
    # Seeded requests: an unseeded one samples under its request id, which
    # counts the requests of the whole process.
    want = jax_engine(jm, **kw).run(
        [dtpu.serving.Request(p, m, seed=i) for i, (p, m) in enumerate(reqs)])
    got = dtt.serving.Engine(pm, decode_kernel=kind, **kw).run(
        [dtt.serving.Request(p, m, seed=i) for i, (p, m) in enumerate(reqs)])
    for (prompt, _), w, g in zip(reqs, want, got):
        w = np.asarray(w)
        if dtype is None or np.array_equal(w, g):
            np.testing.assert_array_equal(g, w)
            continue
        first = int(np.argmax(w != g))
        assert first >= prompt.size
        assert temperature == 0.0 and _tie_at(jm, w, first), (
            f"port {list(g)} != jax {list(w)} at {first}, no bf16 tie")


def test_fit_raises_and_update_weights_checks_dtypes(quantized):
    _, pm, _ = quantized(None)
    pm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    x = np.zeros((4, 16), np.int32)
    with pytest.raises(RuntimeError, match="int8-quantized"):
        pm.fit(x, x, batch_size=2, epochs=1, verbose=0)
    eng = dtt.serving.Engine(pm, max_slots=2, block_size=8, max_len=T)
    same = {k: v.clone() for k, v in pm.params.items()}
    assert eng.update_weights(same) == 1
    as_f32 = {k: v.to(torch.float32) for k, v in same.items()}
    with pytest.raises(ValueError, match="dtype mismatch at .*/q"):
        eng.update_weights(as_f32)
    plain = {k.rsplit("/", 1)[0]: v.float() for k, v in same.items()
             if k.endswith("/q")}
    with pytest.raises(ValueError, match="structure does not match"):
        eng.update_weights(plain)


def test_engine_int8_under_policy_matches_jax():
    """int8 weights served under ``mixed_bfloat16``. The JAX Engine casts
    the tree for compute (``_cast_for_compute``: the scales to bf16 too)
    AND runs its dispatches inside the policy's scope (``Model._scoped``),
    so a layer without ``dtype=`` dequantizes in f32 and multiplies in
    bf16; the port's Engine enters the same scope. Greedy tokens equal
    JAX's up to a bf16 tie (as the bf16 tests above), and each logprob of
    the agreeing prefix lies within 2 bf16 ulps at 4.0 (2**-4) of JAX's:
    XLA keeps fused bf16 chains at f32, the port rounds each operation."""
    jm, pm = lm_pair(vocab=V, num_layers=2, d_model=32, num_heads=2,
                     max_len=T)
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               precision="mixed_bfloat16")
    pm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               precision="mixed_bfloat16")
    dtpu.quant.quantize_model(jm)
    dtt.quant.quantize_model(pm)
    reqs = _requests(seed=3)
    kw = dict(max_slots=2, block_size=8, max_len=T, temperature=0.0)
    jeng = jax_engine(jm, **kw)
    want = jeng.run([dtpu.serving.Request(p, m) for p, m in reqs],
                    return_logprobs=True)
    jrows = jeng.last_run_telemetry["requests"]
    worst = 0.0
    for kind in ("reference", "fused"):
        eng = dtt.serving.Engine(pm, decode_kernel=kind, **kw)
        got = eng.run([dtt.serving.Request(p, m) for p, m in reqs],
                      return_logprobs=True)
        rows = eng.last_run_telemetry["requests"]
        for i, ((prompt, _), w, g) in enumerate(zip(reqs, want, got)):
            w = np.asarray(w)
            same = len(w) if np.array_equal(w, g) else int(np.argmax(w != g))
            if same < len(w):
                assert same >= prompt.size and _tie_at(jm, w, same), (
                    f"{kind} request {i}: port {list(g)} != jax {list(w)} "
                    f"at {same}, no bf16 tie")
            n = same - prompt.size
            diff = np.abs(np.asarray(rows[i]["logprobs"][:n])
                          - np.asarray(jrows[i]["logprobs"][:n]))
            worst = max(worst, float(diff.max(initial=0.0)))
    assert worst <= 2.0 ** -4, worst
