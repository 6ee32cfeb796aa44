#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``distributed_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and
``nvcc``. It drives the port only and imports nothing of JAX or of the JAX
package. Phases, in order; any failure exits non-zero:

a. Build every kernel source in ``distributed_tpu_torch/csrc`` with
   ``nvcc`` (one source so far); print the build time, ptxas's register
   and spill report, and the card's name and power limit.
b. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes (S=8 slots, H=12 heads, hd=64, block 16, 64 table
   entries), f32/bf16 and int8 pools, kw 1 and 4, mixed positions with
   trash-table slots; max abs error against the stated tolerance,
   per-launch time (CUDA events, pools rotated past the 50 MB L2) beside
   the plain version's time and the bound.
c. Engine at full width: the GPT-2-small LM (vocab 32768, 12 layers,
   d_model 768, 12 heads, max_len 1024, bf16 layers, random weights from
   seed 0) served by ``Engine(max_slots=8, block_size=16, max_len=1024)``
   with ``decode_kernel="fused"``: 16 greedy requests, prompts of 32-512
   tokens, 64-128 new tokens. Launch counts are zeroed just before and
   read just after. The same requests again with ``"reference"``: the
   first tokens (from prefill) must match; the agreement share is printed.
d. The same width at 2 layers in f32 with TF32 off: fused and reference
   must be token-exact.
e. int8 KV at full width (counts zeroed before, read after): tokens/s and
   the agreement share with phase c.
f. The kernel table as one JSON line, the card's name and power limit,
   then ``{"ok": true, "device": {...}}`` as the last line.
"""

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM, NVIDIA's data sheet: HBM bandwidth and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REPLACES = {
    "paged_attention": "distributed_tpu/ops/paged_attention.py:93",
    "paged_attention_int8": "distributed_tpu/ops/paged_attention.py:151",
}
SOURCE = "distributed_tpu_torch/csrc/paged_attention.cu"

LM = dict(num_layers=12, d_model=768, num_heads=12, max_len=1024)
VOCAB = 32768


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters):
    """Mean device ms per call over ``iters`` calls of ``fn(i)``, after
    warm-up, between CUDA events. The card first spins for ~50 ms so the
    host can queue every call before the first starts: the events then
    time the calls back to back, not the host's launch overhead."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase b
def kernel_inputs(torch, dev, dtype, kw, int8, seed):
    """Serving-shaped inputs: 8 slots, 6 with disjoint tables at mixed
    positions (0 included), 2 on the all-trash table at position 0, as
    the engine's free slots are."""
    s, h, hd, bs, nb = 8, 12, 64, 16, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    nblocks = s * nb + 1
    kp = torch.randn((nblocks, bs, h, hd), generator=g, device=dev)
    vp = torch.randn((nblocks, bs, h, hd), generator=g, device=dev)
    q = torch.randn((s, kw, h, hd), generator=g, device=dev).to(dtype)
    tables = (1 + torch.arange(s * nb, device=dev).reshape(s, nb)).int()
    tables[6:] = 0
    positions = torch.tensor([0, 17, 255, 511, 700, 1024 - kw, 0, 0],
                             dtype=torch.int32, device=dev)
    if int8:
        def quant(pool):
            amax = pool.abs().amax(dim=-1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, 1.0)
            qv = torch.clamp(torch.round(pool / scale), -127, 127)
            return {"q": qv.to(torch.int8), "scale": scale}
        kp, vp = quant(kp), quant(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return q, kp, vp, tables, positions


def bound(q, kp, tables, positions):
    """(bound_ms, bound_by, bytes, flops): the least time for this call's
    work on the card — bytes it must move (q read, out written, the
    visible K/V rows and their scales, the table entries they need) over
    HBM bandwidth, against its flops over the peak rate of q's dtype."""
    s, kw, h, hd = q.shape
    int8 = isinstance(kp, dict)
    pool = kp["q"] if int8 else kp
    bs, nb = pool.shape[1], tables.shape[1]
    vis = [min(int(p) + kw, nb * bs) for p in positions.tolist()]
    row_bytes = h * hd * pool.element_size() + (h * 4 if int8 else 0)
    nbytes = (2 * q.numel() * q.element_size() + 2 * sum(vis) * row_bytes
              + 4 * sum(-(-v // bs) for v in vis) + 4 * s)
    flops = sum(4 * h * hd * min(int(p) + r + 1, nb * bs)
                for p in positions.tolist() for r in range(kw))
    dtype = str(q.dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_kernels(torch, paged_ops):
    dev = torch.device("cuda")
    cases = [  # (name, q dtype, kw, int8)
        ("paged_attention", torch.float32, 1, False),
        ("paged_attention", torch.float32, 4, False),
        ("paged_attention", torch.bfloat16, 1, False),
        ("paged_attention", torch.bfloat16, 4, False),
        ("paged_attention_int8", torch.bfloat16, 1, True),
        ("paged_attention_int8", torch.bfloat16, 4, True),
        ("paged_attention_int8", torch.float32, 1, True),
    ]
    rows = {}
    for i, (name, dtype, kw, int8) in enumerate(cases):
        args = kernel_inputs(torch, dev, dtype, kw, int8, seed=i)
        got = paged_ops.paged_attention(*args)
        want = paged_ops.paged_attention_ref(*args)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dname]
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        print(f"  {name:22s} q={dname:8s} kw={kw} max_abs_err={err:.3e} "
              f"tol={tol:g} (atol=rtol) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version (q {dname}, kw {kw})")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if kw == 1 and dtype == torch.bfloat16:
            # The main path's shapes (bf16 layers, decode): time them,
            # rotating 4 copies of the pools past the 50 MB L2.
            copies = [kernel_inputs(torch, dev, dtype, kw, int8, seed=100 + c)
                      for c in range(4)]
            ms = cuda_ms(torch, lambda j: paged_ops.paged_attention(
                *copies[j % 4]), 200)
            plain_ms = cuda_ms(torch, lambda j: paged_ops.paged_attention_ref(
                *copies[j % 4]), 20)
            b_ms, b_by, nbytes, flops = bound(*copies[0][:2], *copies[0][3:])
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"  {name:22s} time {ms * 1e3:.1f} us/launch, plain "
                  f"{plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
                  f"({b_by}: {nbytes / 1e6:.2f} MB at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {flops / 1e6:.1f} "
                  f"MFLOP), {b_ms / ms:.1%} of bound")
    return rows


# ---------------------------------------------------------------- phase c-e
def requests(n, p_range, m_range, seed=0):
    rng = np.random.default_rng(seed)
    plen = rng.integers(p_range[0], p_range[1] + 1, n)
    news = rng.integers(m_range[0], m_range[1] + 1, n)
    return [(rng.integers(0, VOCAB, (int(p),)).astype(np.int32), int(m))
            for p, m in zip(plen, news)]


def serve(dtt, model, reqs, **kw):
    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                max_len=LM["max_len"], **kw)
    t = time.perf_counter()
    outs = engine.run([dtt.serving.Request(p, m) for p, m in reqs])
    wall = time.perf_counter() - t
    tel = engine.last_run_telemetry
    del engine
    return outs, tel, wall


def check_outputs(outs, reqs, vocab):
    for o, (p, m) in zip(outs, reqs):
        if o.shape != (p.size + m,) or not np.array_equal(o[:p.size], p):
            raise SystemExit(f"bad output shape {o.shape} for prompt "
                             f"{p.size} + {m}")
        if o.min() < 0 or o.max() >= vocab:
            raise SystemExit("generated token outside the vocabulary")


def agreement(a, b, reqs):
    """Share of generated positions where two runs chose the same token,
    and whether every first generated token (from prefill) matched."""
    same = total = 0
    first = True
    for x, y, (p, m) in zip(a, b, reqs):
        gx, gy = x[p.size:], y[p.size:]
        same += int(np.sum(gx == gy))
        total += m
        first &= bool(gx[0] == gy[0])
    return same / total, first


def report(tag, tel, wall):
    ttft = tel["time_to_first_token"]
    print(f"  {tag}: {tel['generated_tokens']} tokens in {wall:.3f} s, "
          f"{tel['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms, "
          f"decode steps {tel['decode_steps']}, preemptions "
          f"{tel['preemptions']}, kv util mean "
          f"{tel['kv_utilization']['mean']:.3f}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import paged_attention as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {card}")

    print("phase a: build")
    t = time.perf_counter()
    path, log = paged_ops.build()
    print(f"  built {path.name} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}")

    print("phase b: kernels vs plain versions, S=8 H=12 hd=64 bs=16 nb=64")
    print('kernels: ["paged_attention (K1)", "paged_attention_int8 (K2)"]')
    rows = phase_kernels(torch, paged_ops)

    print("phase c: GPT-2-small LM, bf16 layers, Engine(8 slots, block 16, "
          "max_len 1024), fused")
    model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype="bfloat16", **LM))
    t = time.perf_counter()
    model.build((LM["max_len"],), seed=0)
    n_params = sum(p.numel() for p in model.params.values())
    print(f"  built {n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - t:.1f} s")
    reqs = requests(16, (32, 512), (64, 128))
    serve(dtt, model, requests(2, (8, 16), (4, 4), seed=1))  # warm-up
    paged_ops.reset_launch_counts()
    fused, tel, wall = serve(dtt, model, reqs, decode_kernel="fused")
    launches = dict(paged_ops.launches)
    report("fused", tel, wall)
    print(f"  launches {launches}")
    if launches["paged_attention"] != tel["decode_steps"] * LM["num_layers"]:
        raise SystemExit("the fused run did not launch the kernel once per "
                         "layer and decode step")
    check_outputs(fused, reqs, VOCAB)
    rows["paged_attention"]["launches"] = launches["paged_attention"]
    ref, tel_ref, wall_ref = serve(dtt, model, reqs,
                                   decode_kernel="reference")
    report("reference", tel_ref, wall_ref)
    share, first = agreement(fused, ref, reqs)
    print(f"  fused vs reference: token agreement {share:.4f}, first tokens "
          f"{'match' if first else 'DIFFER'}")
    if not first:
        raise SystemExit("first tokens (prefill) differ between engines")

    print("phase d: 2 layers, f32, TF32 off: fused must be token-exact")
    small = dtt.Model(dtt.models.transformer_lm(
        VOCAB, **dict(LM, num_layers=2)))
    small.build((LM["max_len"],), seed=1)
    sreqs = requests(8, (32, 256), (16, 32), seed=2)
    a, _, _ = serve(dtt, small, sreqs, decode_kernel="fused")
    b, _, _ = serve(dtt, small, sreqs, decode_kernel="reference")
    exact = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"  token-exact: {exact}")
    if not exact:
        raise SystemExit("f32 fused and reference runs differ")
    del small
    torch.cuda.empty_cache()

    print("phase e: int8 KV at full width, fused")
    paged_ops.reset_launch_counts()
    q8, tel8, wall8 = serve(dtt, model, reqs, kv_dtype="int8")
    launches = dict(paged_ops.launches)
    report("int8 KV", tel8, wall8)
    print(f"  launches {launches}")
    if launches["paged_attention_int8"] == 0:
        raise SystemExit("the int8 run never launched the int8 kernel")
    check_outputs(q8, reqs, VOCAB)
    rows["paged_attention_int8"]["launches"] = launches["paged_attention_int8"]
    share8, _ = agreement(q8, fused, reqs)
    print(f"  int8 vs bf16 KV: token agreement {share8:.4f}")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, r in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
