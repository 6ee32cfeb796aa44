"""``Residual`` with a shortcut branch in the port's paged engine, against
the JAX package's.

A 2-block LM (vocab 64, d 32, 2 heads, max_len 64) in three arrangements
of a block, built in both packages on the same f32 weights (carried over
by ``interop``):

- ``attn_shortcut``: GPT-NeoX's parallel residual, ``x + attn(ln1(x)) +
  mlp(ln2(x))``, as ``Residual(main=Residual(Sequential([LayerNorm,
  Dense, Dense])), shortcut=Sequential([LayerNorm,
  MultiHeadAttention]))``: the attention's KV pool is the shortcut's;
- ``attn_main``: the same sum with the attention in the main branch and
  the MLP in the shortcut;
- ``dense_shortcut``: a plain ``Dense`` projection as the attention
  residual's shortcut, then a pre-LN MLP residual.

Each is served greedy by the port's ``Engine`` (``decode_kernel``
"fused", whose plain version runs on the CPU) and by the JAX ``Engine``
(``torch_parity.jax_engine``), and must be token-exact: with batch churn,
with ``prefill_chunk`` smaller than the prompts, with a prefix-cache hit
and copy-on-write, with int8 KV, and with a self-draft at ``spec_k=3``.
A prefill replica's KV handoff (``fleet.pack_kv``) carries the shortcut's
pool under JAX's keys, and a decode replica that installs it decodes
JAX's tokens. The paged cache tree has JAX's keys.
"""

import jax
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
import distributed_tpu_torch as dtt
from distributed_tpu import fleet as jfleet
from distributed_tpu.serving import Request as JRequest
from distributed_tpu.serving import Sequence as JSequence
from distributed_tpu_torch import fleet as pfleet
from distributed_tpu_torch.serving import Engine, Request
from distributed_tpu_torch.serving import Sequence as PSequence
from torch_parity import jax_engine, jax_model, port_model

torch.set_num_threads(1)

VOCAB, D, HEADS, MAX_LEN = 64, 32, 2, 64
ENGINE = dict(max_slots=2, block_size=4, max_len=MAX_LEN)


def block(nn, arrangement):
    """One block of ``arrangement`` from package ``nn`` (either one's)."""
    def attn():
        return nn.Sequential([nn.LayerNorm(),
                              nn.MultiHeadAttention(HEADS, causal=True)])

    def mlp():
        return nn.Sequential([nn.LayerNorm(),
                              nn.Dense(4 * D, activation="gelu",
                                       shard="col"),
                              nn.Dense(D, shard="row")])

    if arrangement == "attn_shortcut":
        return [nn.Residual(nn.Residual(mlp()), shortcut=attn())]
    if arrangement == "attn_main":
        return [nn.Residual(nn.Residual(attn()), shortcut=mlp())]
    return [nn.Residual(attn(), shortcut=nn.Dense(D)), nn.Residual(mlp())]


def lm(pkg, arrangement, num_layers=2):
    nn = pkg.nn
    layers = [nn.Embedding(VOCAB, D), nn.PositionalEmbedding(MAX_LEN)]
    for _ in range(num_layers):
        layers += block(nn, arrangement)
    return nn.Sequential(layers + [nn.LayerNorm(), nn.Dense(VOCAB)])


ARRANGEMENTS = ("attn_shortcut", "attn_main", "dense_shortcut")


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for i, arrangement in enumerate(ARRANGEMENTS):
        jm = jax_model(lm(dtpu, arrangement), (16,), seed=i)
        out[arrangement] = jm, port_model(lm(dtt, arrangement), (16,),
                                          jm.params)
    return out


def _requests(seed, n, p_range=(1, 12), m_range=(3, 10), common=None):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, (int(t),)).astype(np.int32)
               for t in rng.integers(*p_range, n)]
    if common is not None:
        prompts = [np.concatenate([common, p]) for p in prompts]
    return prompts, [int(m) for m in rng.integers(*m_range, n)]


CONFIGS = {
    # name: (request kwargs, engine kwargs, self-draft)
    "churn": (dict(seed=0, n=3), {}, False),
    "chunked_prefill": (dict(seed=1, n=2, p_range=(10, 20)),
                        dict(prefill_chunk=5), False),
    # Whole blocks, each prompt served twice: the second finds it fully
    # cached and writes its last position into a shared block.
    "prefix_cache": (dict(seed=2, n=2, p_range=(4, 5),
                          common=np.arange(8, dtype=np.int32) * 3 % VOCAB),
                     dict(prefix_cache=True), False),
    "int8_kv": (dict(seed=3, n=3), dict(kv_dtype="int8"), False),
    "spec_k3": (dict(seed=4, n=2), dict(spec_k=3), True),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("arrangement", ARRANGEMENTS)
def test_engine_token_exact_vs_jax(pairs, arrangement, config):
    jm, pm = pairs[arrangement]
    req_kw, eng_kw, draft = CONFIGS[config]
    prompts, news = _requests(**req_kw)
    if config == "prefix_cache":
        prompts, news = prompts * 2, news * 2
    jeng = jax_engine(jm, draft_model=jm if draft else None, **ENGINE,
                      **eng_kw)
    want = jeng.run([JRequest(p, m) for p, m in zip(prompts, news)])
    eng = Engine(pm, decode_kernel="fused",
                 draft_model=pm if draft else None, **ENGINE, **eng_kw)
    got = eng.run([Request(p, m) for p, m in zip(prompts, news)])
    tel = eng.last_run_telemetry
    assert tel["generated_tokens"] == sum(news)
    if config == "prefix_cache":
        assert tel["prefix_cache"]["hit_blocks"] > 0
        assert tel["prefix_cache"]["cow_copies"] > 0
    if draft:
        assert tel["speculative"]["rounds"] > 0
        assert (tel["speculative"]
                == jeng.last_run_telemetry["speculative"])
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(w), g), (
            f"{arrangement}/{config} request {i}: port {list(g)} != "
            f"jax {list(np.asarray(w))}")


def _keys(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix}
    out = set()
    for k, v in tree.items():
        out |= _keys(v, f"{prefix}/{k}" if prefix else k)
    return out


@pytest.mark.parametrize("arrangement", ARRANGEMENTS)
def test_paged_cache_tree_has_jax_keys(pairs, arrangement):
    jm, pm = pairs[arrangement]
    jtree = jm.module.init_paged_cache(jm.params, 3, 4, jax.numpy.float32)
    ptree = pm.module.init_paged_cache(3, 4, torch.float32, "cpu")
    assert _keys(ptree) == _keys(jtree)
    assert any("shortcut" in k for k in _keys(ptree)) == (
        arrangement == "attn_shortcut")
    qtree = pm.module.init_paged_cache(3, 4, torch.int8, "cpu")
    jq = jm.module.init_paged_cache(jm.params, 3, 4, jax.numpy.int8)
    assert _keys(qtree) == _keys(jq)


def _prefilled(pkg, model, seq_cls, req_cls, prompt):
    rep = pkg.PrefillReplica("prefill-0", pkg.EnginePrograms(model),
                             block_size=4, max_len=MAX_LEN)
    seq = seq_cls(req_cls(prompt, 6, seed=0, request_id=0))
    _, payload = rep.prefill(seq)
    return seq, payload


def _decoded(pkg, model, seq_cls, req_cls, prompt, first, payload):
    rep = pkg.DecodeReplica("decode-0", pkg.EnginePrograms(model),
                            max_slots=2, block_size=4, max_len=MAX_LEN)
    seq = seq_cls(req_cls(prompt, 6, seed=0, request_id=0))
    seq.tokens.append(int(first))
    seq.num_generated = 1
    rep.submit(seq, 0.0, payload=payload)
    done = []
    while not done:
        _, done = rep.step(0.0)
    assert rep.handoffs_installed == 1 and rep.handoffs_fallback == 0
    return done[0].output()


@pytest.mark.parametrize("arrangement", ARRANGEMENTS)
def test_fleet_handoff_carries_the_shortcut_pool(pairs, arrangement):
    jm, pm = pairs[arrangement]
    prompt = np.random.default_rng(7).integers(0, VOCAB, 11).astype(
        np.int32)
    jseq, jp = _prefilled(jfleet, jm, JSequence, JRequest, prompt)
    pseq, pp = _prefilled(pfleet, pm, PSequence, Request, prompt)
    assert pseq.tokens == jseq.tokens
    assert sorted(pp.blocks) == sorted(jp.blocks)
    assert any("/shortcut/" in k or "/main/" in k for k in pp.blocks)
    for key, want in jp.blocks.items():
        np.testing.assert_allclose(pp.blocks[key], want, rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    first = jseq.tokens[-1]
    want = _decoded(jfleet, jm, JSequence, JRequest, prompt, first, jp)
    got = _decoded(pfleet, pm, PSequence, Request, prompt, first, pp)
    np.testing.assert_array_equal(got, want)
