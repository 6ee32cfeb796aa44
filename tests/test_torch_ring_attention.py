"""``ops.ring_attention`` in the port, on 4 gloo ranks, against the JAX package.

One group of 4 worker processes (the port's launcher, 120 s) runs every
case of this file on two meshes: data 2 x seq 2 (a ring of 2 on each data
line) and seq 4. Each rank takes its (B, T/n, H, D) block of the same
seeded numpy q, k and v (its rows too where the batch is split over
"data"), runs the port's ring, and differentiates ``sum(out * cot)`` for a
seeded cotangent; the parent stitches the blocks back together.

- Outputs against the JAX ``ring_attention`` on the full arrays (the
  cases of ``tests/test_ring_attention.py``): naive causal on a ring of
  2, naive non-causal and zigzag causal on a ring of 4, and a data x seq
  mesh with the batch split over "data" (zigzag). atol 1e-5, f32.
- Gradients of q, k and v (f32, atol 1e-5): against ``jax.grad`` through
  the JAX ring for the naive causal ring of 2, and against ``jax.grad`` of
  the dense attention the JAX ring equals for every case (a JAX ring's
  gradient compiles in 20-60 s on the CPU, too long for each case here).
  The zigzag schedule on a ring of 2 and the naive one on a ring of 4,
  causal, are held to the dense outputs and gradients too.
- Errors: JAX's for "zigzag" without causal masking and with an odd
  block, where "auto" falls back to the naive ring; an unknown schedule;
  and the strategy's "not divisible" for a sequence ``seq`` does not
  divide (the JAX ring's and ``put_batch``'s message).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_tpu as dtpu
from distributed_tpu.ops.ring_attention import ring_attention as jax_ring
from torch_parity import run_ranks

torch.set_num_threads(1)

# name: (ring size, causal, schedule, B, T, split the batch over "data")
CASES = {
    "n2_causal_naive": (2, True, "naive", 2, 16, False),
    "n2_causal_zigzag": (2, True, "zigzag", 2, 16, False),
    "n4_noncausal": (4, False, "auto", 2, 16, False),
    "n4_causal_zigzag": (4, True, "zigzag", 2, 16, False),
    "n4_causal_naive": (4, True, "naive", 2, 16, False),
    "data_x_seq": (2, True, "auto", 4, 32, True),
}
# Cases whose outputs are held to the JAX ring itself (the others to the
# dense attention it equals).
JAX_RING = ("n2_causal_naive", "n4_noncausal", "n4_causal_zigzag",
            "data_x_seq")
H, D = 2, 8

WORKER = '''
import json
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import distributed_tpu_torch as dtt
from distributed_tpu_torch.ops.ring_attention import ring_attention
from distributed_tpu_torch.parallel.mesh import make_mesh

spec = dtt.cluster.initialize(device="cpu", timeout=60)
data = np.load(sys.argv[1])
cases = json.loads(sys.argv[3])
meshes = {2: make_mesh({"data": 2, "seq": 2}, device_type="cpu"),
          4: make_mesh({"seq": 4}, device_type="cpu")}
got = {}
for name, (n, causal, schedule, b, t, split) in cases.items():
    mesh = meshes[n]
    r = mesh.get_local_rank("seq")
    tb = t // n
    cols = slice(r * tb, (r + 1) * tb)
    rows = slice(None)
    if split:
        d = mesh.get_local_rank("data")
        rows = slice(d * b // 2, (d + 1) * b // 2)
    q, k, v = (torch.tensor(data[f"{name}/{a}"][rows, cols],
                            requires_grad=True) for a in "qkv")
    out = ring_attention(q, k, v, mesh=mesh, causal=causal,
                         schedule=schedule,
                         batch_axis="data" if split else None)
    cot = torch.from_numpy(data[f"{name}/cot"][rows, cols])
    (out * cot).sum().backward()
    for key, val in (("out", out), ("dq", q.grad), ("dk", k.grad),
                     ("dv", v.grad)):
        got[f"{name}/{key}"] = val.detach().numpy()
np.savez(f"{sys.argv[2]}_{spec.index}.npz", **got)

errors = {}
mesh = meshes[4]
x = torch.zeros((1, 1, 2, 8))  # a block of 1 position a rank
for name, kw in (("noncausal", dict(causal=False, schedule="zigzag")),
                 ("odd_block", dict(causal=True, schedule="zigzag")),
                 ("unknown", dict(causal=True, schedule="spiral"))):
    try:
        ring_attention(x, x, x, mesh=mesh, **kw)
        errors[name] = None
    except ValueError as e:
        errors[name] = str(e)
# "auto" on a block of 1: the naive ring, the dense result.
xs = np.asarray(data["auto_odd/qkv"])
r = mesh.get_local_rank("seq")
q, k, v = (torch.from_numpy(xs[i][:, r:r + 1]) for i in range(3))
auto = ring_attention(q, k, v, mesh=mesh, causal=True).numpy()
np.save(f"{sys.argv[2]}_auto_{spec.index}.npy", auto)
sp = dtt.DataSeqParallel(mesh=make_mesh({"data": 1, "seq": 4},
                                        device_type="cpu"), device="cpu")
try:
    sp.shard_seq(np.zeros((8, 18), np.int32))
    errors["indivisible"] = None
except ValueError as e:
    errors["indivisible"] = str(e)
dtt.launch.report_result({"errors": errors,
                          "coords": [int(meshes[2].get_local_rank("data")),
                                     int(meshes[2].get_local_rank("seq")),
                                     int(meshes[4].get_local_rank("seq"))]})
dtt.cluster.shutdown()
'''


def _dense(q, k, v, causal):
    qf, kf, vf = (a.astype(jnp.float32) for a in (q, k, v))
    s = jnp.einsum("bqhd,bkhd->bhqk", qf, kf) / jnp.sqrt(
        jnp.float32(q.shape[-1]))
    if causal:
        t = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool))[None, None], s,
                      -jnp.inf)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), vf)


def _grads(fn, q, k, v, cot):
    return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * cot),
                    argnums=(0, 1, 2))(q, k, v)


def _stitch(parts, name, key, n, split):
    """The full (B, T, H, D) array from the ranks' blocks."""
    if n == 4:
        return np.concatenate([parts[r][f"{name}/{key}"] for r in range(4)],
                              axis=1)
    # data 2 x seq 2: rank = 2 * data + seq.
    lines = [np.concatenate([parts[2 * d + s][f"{name}/{key}"]
                             for s in range(2)], axis=1) for d in range(2)]
    return np.concatenate(lines, axis=0) if split else lines[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    arrays, want = {}, {}
    for name, (n, causal, schedule, b, t, split) in CASES.items():
        q, k, v, cot = (rng.standard_normal((b, t, H, D)).astype(np.float32)
                        for _ in range(4))
        arrays.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v,
                       f"{name}/cot": cot})
        dense = lambda a, b_, c, causal=causal: _dense(a, b_, c, causal)
        want[name] = {"dense": np.asarray(dense(q, k, v)),
                      "dense_grads": [np.asarray(g) for g in
                                      _grads(dense, q, k, v, cot)]}
        if name in JAX_RING:
            devs = jax.devices()[:n * (2 if split else 1)]
            mesh = dtpu.make_mesh({"data": 2, "seq": n} if split
                                  else {"seq": n}, devices=devs)

            def ring(a, b_, c, mesh=mesh, causal=causal, schedule=schedule,
                     split=split):
                return jax_ring(a, b_, c, mesh=mesh, causal=causal,
                                schedule=schedule,
                                batch_axis="data" if split else None)

            want[name]["ring"] = np.asarray(ring(q, k, v))
            if name == "n2_causal_naive":
                want[name]["ring_grads"] = [
                    np.asarray(g) for g in _grads(ring, q, k, v, cot)]
    odd = rng.standard_normal((3, 1, 4, 2, 8)).astype(np.float32)
    arrays["auto_odd/qkv"] = odd
    want["auto_odd"] = np.asarray(_dense(*odd, True))
    np.savez(tmp / "in.npz", **arrays)
    port = run_ranks(4, tmp, WORKER, tmp / "in.npz", tmp / "out",
                     json.dumps(CASES))
    parts = {r: dict(np.load(tmp / f"out_{r}.npz")) for r in range(4)}
    got = {}
    for name, (n, _, _, _, _, split) in CASES.items():
        got[name] = {key: _stitch(parts, name, key, n, split)
                     for key in ("out", "dq", "dk", "dv")}
    got["auto_odd"] = np.concatenate(
        [np.load(tmp / f"out_auto_{r}.npy") for r in range(4)], axis=1)
    return dict(port=port, got=got, want=want)


@pytest.mark.parametrize("case", JAX_RING)
def test_outputs_match_jax_ring(runs, case):
    np.testing.assert_allclose(runs["got"][case]["out"],
                               runs["want"][case]["ring"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_and_gradients_match_dense(runs, case):
    got, want = runs["got"][case], runs["want"][case]
    np.testing.assert_allclose(got["out"], want["dense"], rtol=0, atol=1e-5)
    for key, g in zip(("dq", "dk", "dv"), want["dense_grads"]):
        np.testing.assert_allclose(got[key], g, rtol=0, atol=1e-5,
                                   err_msg=key)


def test_gradients_match_jax_ring(runs):
    got, want = runs["got"]["n2_causal_naive"], runs["want"][
        "n2_causal_naive"]
    for key, g in zip(("dq", "dk", "dv"), want["ring_grads"]):
        np.testing.assert_allclose(got[key], g, rtol=0, atol=1e-5,
                                   err_msg=key)


def test_zigzag_and_indivisible_errors(runs):
    for row in runs["port"].values():
        errs = row["errors"]
        assert "zigzag" in errs["noncausal"] and "causal=False" in \
            errs["noncausal"]
        assert "per-shard=1" in errs["odd_block"]
        assert errs["unknown"] == "unknown schedule 'spiral'"
        assert errs["indivisible"] == \
            "sequence length 18 not divisible by seq=4 shards"
    np.testing.assert_allclose(runs["got"]["auto_odd"], runs["want"][
        "auto_odd"], rtol=0, atol=1e-5)


def test_ranks_sit_at_jax_coordinates(runs):
    # Rank r is device r of the JAX mesh: data-major, then seq.
    for r, row in runs["port"].items():
        assert row["coords"] == [r // 2, r % 2, r]
