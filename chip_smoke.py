#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``distributed_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and
``nvcc``. It drives the port only and imports nothing of JAX or of the JAX
package. Phases, in order; any failure exits non-zero:

a. Build every kernel source in ``distributed_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all at once; print the build time,
   ptxas's register and spill report, and the card's name and power limit.
   For the bf16 flash kernels (wgmma), one line each: registers, spills,
   the dynamic shared memory a block asks for, and the count of HGMMA
   instructions in their SASS (``cuobjdump``, where the toolkit has it;
   none exits).
b. Paged attention: each kernel against its plain PyTorch version on the
   card, at the serving shapes (S=8 slots, H=12 heads, hd=64, block 16, 64
   table entries), f32/bf16 and int8 pools, kw 1 and 4, mixed positions
   with trash-table slots; max abs error against the stated tolerance,
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
e. int8 KV at full width, fused (counts zeroed before, read after):
   tokens/s and the agreement share with phase c.
f. Fused cross-entropy: both kernels against their plain versions at the
   LM head's N=32768 rows of C=32768 bf16 logits (losses to 1e-4, every
   dlogit to one bf16 ulp of its own value), then timed on the same
   inputs (each launch after an L2 flush) beside the plain version,
   ``F.cross_entropy`` (the library yardstick, timed only) and the bound.
g. Flash attention: forward, dQ and dK/dV against the plain versions at
   B=32, T=1024, H=12, D=64, causal, bf16 and f32, and at B=8, T=1024,
   H=6, D=128 in bf16: every entry of O, dQ, dK, dV within ``FLASH_TOL``,
   ``m`` within 1e-5. Timed in bf16 beside the plain versions and
   ``F.scaled_dot_product_attention``'s forward and whole backward in the
   same call, with each kernel's TFLOP/s and the bound; dQ + dK/dV summed
   against SDPA's backward.
h. Training at full width: the GPT-2-small LM (bf16 layers) compiled with
   ``Adam(1e-4)``, the pallas loss and accuracy, batch 32 x 1024 tokens
   from ``numpy.random.default_rng(0)``; 2 warm-up steps, then 5 timed
   steps through ``fit`` (counts zeroed just before, read just after):
   per-step losses (finite, falling on the repeated batch), steps/s,
   tokens/s, MFU, launches per step (the flash forward and dK/dV on their
   wgmma route) and peak memory.
i. The kernel path against the plain path: a 2-layer f32 LM (TF32 off),
   3 Adam steps with ``flash=True`` and the pallas loss against
   ``flash=False`` and the stock loss; per-step losses must agree to 1e-5
   relative.
j. Fused Adam (K11) against its plain version on GPT-2-small's own
   parameter tree (every leaf and shape), gradients from a seeded
   generator: 3 ``fused_adam`` updates (wd 0) and 3 ``fused_adamw``
   updates (wd 0.01); parameters and both moments must be bit-identical.
   Then timed per update (after an L2 flush) beside the plain ``foreach``
   walk, ``torch.optim.AdamW(fused=True)`` (the library yardstick, timed
   only) and the bytes bound.
k. The reference workload: ``cluster.initialize()`` from a one-worker
   DTPU_CONFIG (an NCCL group of world 1) and a ``DataParallel()`` scope;
   ``mnist_cnn`` as the JAX package's ``bench_mnist`` configures it
   (synthetic images, global batch 256, ``SGD(0.001)``; 10 warm-up and
   100 timed steps) and ``cifar_cnn`` as ``bench_cifar`` does (batch 256
   from ``default_rng(0)``, ``SGD(0.01, momentum=0.9)``; 5 + 50 steps),
   both through ``fit`` with TF32 off: steps/s, images/s, finite losses.
   Then 5 mnist steps under ``DataParallel`` (world 1) and under
   ``SingleDevice`` from the same parameters, cuDNN deterministic: the
   losses must be equal.
l. GPT-2-small under the same ``DataParallel`` scope with
   ``fused_adamw(3e-4, weight_decay=0.01)``, otherwise phase h's
   configuration: 2 warm-up and 5 timed steps (counts zeroed just before,
   read just after): steps/s, tokens/s, MFU, peak memory, launches per
   step of K11 and K3-K10. Then 3 steps with ``fused_adamw`` and 3 with
   the plain ``AdamW`` from the same parameters and batch: the losses
   must be equal. The process group is destroyed at the end.
m. ResNet-50's kernels against their plain versions at the model's own
   shapes, batch 256 at 224x224 (read from the built model): K12 at the 17
   distinct (M, K, N) of a step's 72 products (the 36 1x1 convolutions'
   forwards and their dX products (M, N) @ (N, K)), K13 and K14 at the 12
   distinct (M, C) of its 53 BatchNorms, in bf16, and each at one shape in
   f32. K12: every entry within one bf16 ulp of the plain version's plus
   the f32 sums' rounding bound 2 K 2^-24 sum|x||w| (f32: 2e-5 of that
   sum); K13/K14: rtol 1e-5 plus 1e-5 times the sum of the terms'
   magnitudes (summed in another order), and the same bits on a second
   call. Each launch is timed after an L2 flush beside the plain version,
   the bound and a library call that computes the same function, timed
   only (``torch.matmul``; ``torch.batch_norm_stats`` and
   ``torch.batch_norm_backward_reduce`` on an NCHW view); the JSON row
   holds per-step totals over the 72 products (the 53 calls).
n. ResNet-50 training as the JAX package's ``bench_resnet50`` configures
   it (``resnet(50, 1000, dtype="bfloat16")``, ``bn_shift="running"``,
   ``stem="conv7"``; ``SGD(0.1, momentum=0.9)``, sparse cross-entropy,
   accuracy; global batch 256 at 224x224x3 from ``default_rng(0)``
   normals, labels in [0, 1000)) under phase k's ``DataParallel``: 3
   warm-up steps, then 20 timed steps through ``fit`` (counts zeroed just
   before, read just after): per-step losses and the BN buffers (finite),
   steps/s, images/s, MFU (8.17 GFLOP forward per image, 2 x 4.09 G
   multiply-adds), peak memory and launches per step: exactly 72 of K12
   (36 forward, 36 dX) and 53 calls of K13 and of K14.
o. A small f32 ResNet (``resnet(50, 10, small_inputs=True, stage_blocks=
   (1, 1, 1, 1), width=16)``, 32x32, batch 32), TF32 off, 3 momentum-SGD
   steps from the same parameters on the card (kernels) and on the CPU
   (plain versions): losses within 1e-4 relative. Then, cuDNN
   deterministic, world-1 ``DataParallel`` and ``SingleDevice`` on the
   card: equal losses and equal BN buffers. The process group is
   destroyed at the end.
p. K15, the launch probe, against ``x * 1.0001`` on an (8, 128) f32 tile,
   bit for bit; its per-launch time by the differential method (host
   clock, 10 and 60 launches, each run ending in a synchronize), beside
   its plain version and ``torch.mul(x, 1.0001)``, the library call.
Then the kernel table as one JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

# H100 SXM, NVIDIA's data sheet: HBM bandwidth and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Flash attention, (atol, rtol) per entry. bf16: rtol 2e-2 is 2.5 ulps at
# worst (the two sides may round one output a last bit apart); atol 2e-3
# covers entries near zero, where the bf16 probabilities' rounding at
# other running maxima (forward) adds up in absolute terms.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-3, 2e-2)}
# The flash kernels replace the lane-packed variants too (flash_attention.py
# :384, :448, :490): one strided kernel family reads both layouts.
REPLACES = {
    "paged_attention": "distributed_tpu/ops/paged_attention.py:93",
    "paged_attention_int8": "distributed_tpu/ops/paged_attention.py:151",
    "xent_fwd": "distributed_tpu/ops/pallas_kernels.py:35",
    "xent_bwd": "distributed_tpu/ops/pallas_kernels.py:46",
    "flash_fwd": "distributed_tpu/ops/flash_attention.py:83",
    "flash_dq": "distributed_tpu/ops/flash_attention.py:199",
    "flash_dkv": "distributed_tpu/ops/flash_attention.py:238",
    "fused_adam": "distributed_tpu/ops/fused_update.py:82",
    "conv1x1": "examples/pallas_conv1x1.py:33",
    "bn_stats": "examples/bn_pallas.py:80",
    "bn_bwd_reduce": "examples/bn_pallas.py:119",
    "launch_probe": "examples/profile_op_floor.py:92",
}
SOURCES = {
    "paged_attention": "paged_attention", "paged_attention_int8":
    "paged_attention", "xent_fwd": "xent", "xent_bwd": "xent",
    "flash_fwd": "flash_attention", "flash_dq": "flash_attention",
    "flash_dkv": "flash_attention", "fused_adam": "fused_adam",
    "conv1x1": "conv1x1", "bn_stats": "bn_reduce", "bn_bwd_reduce":
    "bn_reduce", "launch_probe": "launch_probe",
}

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


# ------------------------------------------------------------------ phase a
def sass_opcode_counts(lib_path, opcode):
    """{kernel: count of ``opcode`` in its SASS} by ``cuobjdump -sass``, or
    None where the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    return counts


def wgmma_report(fa, lib_path, log):
    """The bf16 flash kernels (wgmma): registers and spills as ptxas
    reported them (``log``: a fresh build's output), the dynamic shared
    memory a block asks for, and the HGMMA instructions in their SASS;
    exits if a kernel has none."""
    entries, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            entries[cur] = []
        elif cur and ("registers" in line or "spill" in line):
            entries[cur].append(line.split("ptxas info    :")[-1].strip())
    hgmma = sass_opcode_counts(lib_path, "HGMMA")
    for mangled in sorted(set(entries) | set(hgmma or {})):
        hit = re.search(r"(flash_(fwd|dkv)_wgmma_kernel)ILi(\d+)E", mangled)
        if not hit:
            continue
        name, width = hit.group(1), int(hit.group(3))
        smem = fa.wgmma_smem_bytes(f"flash_{hit.group(2)}", width)
        n = "no cuobjdump" if hgmma is None else hgmma.get(mangled, 0)
        print(f"  {name} W={width}: {'; '.join(entries.get(mangled, []))}; "
              f"{smem} B dynamic shared memory; HGMMA in SASS: {n}")
        if hgmma is not None and not hgmma.get(mangled):
            raise SystemExit(f"{name} W={width}: no HGMMA in its SASS")


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


# ------------------------------------------------------------ phase f, g
def cuda_ms_flushed(torch, fn, iters, ahead=False):
    """Mean device ms of ``fn(i)`` over ``iters`` launches, each timed
    between its own CUDA events right after a 128 MB write that evicts the
    50 MB L2, so every launch reads its inputs from HBM. ``ahead``: the
    card first spins ~50 ms so the host queues every call before the
    first starts, and the events time the device, not the host's
    preparation of a call that launches many kernels."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn(0)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    if ahead:
        torch.cuda._sleep(100_000_000)
    for i, (a, b) in enumerate(ev):
        flush.zero_()
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def bound_ms(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def phase_xent(torch, xent):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = {}
    g = torch.Generator(device=dev).manual_seed(11)

    def inputs(n):
        logits = (2 * torch.randn((n, VOCAB), generator=g, device=dev)).to(
            torch.bfloat16)
        labels = torch.randint(0, VOCAB, (n,), generator=g, device=dev)
        gout = torch.full((n,), 1.0 / n, device=dev)
        return logits, labels, gout

    # The LM head's rows at the main path's batch: 32 x 1024 tokens.
    n = 32 * LM["max_len"]
    logits, labels, gout = inputs(n)
    loss = xent.xent_fwd(logits, labels)
    want = xent.xent_fwd_ref(logits, labels)
    torch.cuda.synchronize()
    # f32 losses of about 12: sums of 32768 exponentials in another order.
    err = max_err(loss, want)
    print(f"  xent_fwd   N={n} C={VOCAB} bf16 max_abs_err={err:.3e} "
          f"(limit 1e-04) {'ok' if err <= 1e-4 else 'MISMATCH'}")
    rows["xent_fwd"] = {"max_abs_err": err}
    failed = err > 1e-4
    del loss, want
    dl = xent.xent_bwd(logits, labels, gout)
    want = xent.xent_bwd_ref(logits, labels, gout)
    torch.cuda.synchronize()
    # dlogits: one bf16 ulp of each reference entry. Both sides round one
    # f32 value once to bf16; a last-bit difference before the rounding
    # can move it by one ulp, and nothing more.
    diff = (dl.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(1e-30))) - 7)
    worst = (diff / ulp).max().item()
    err = diff.max().item()
    print(f"  xent_bwd   N={n} C={VOCAB} bf16 max_abs_err={err:.3e}, worst "
          f"entry {worst:.2f} of its own bf16 ulp (limit 1) "
          f"{'ok' if worst <= 1 else 'MISMATCH'}")
    rows["xent_bwd"] = {"max_abs_err": err}
    failed |= worst > 1
    del dl, want, diff, ulp
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit("xent: a kernel disagrees with its plain version")

    lf = logits.float().requires_grad_(True)
    lib_out = F.cross_entropy(lf, labels, reduction="none")
    logit_bytes = logits.numel() * logits.element_size()
    timings = {  # bytes: each input read once, each output written once
        "xent_fwd": dict(
            kernel=lambda i: xent.xent_fwd(logits, labels),
            plain=lambda i: xent.xent_fwd_ref(logits, labels),
            library=lambda i: F.cross_entropy(logits.float(), labels,
                                              reduction="none"),
            nbytes=logit_bytes + 8 * n + 4 * n, flops=3 * logits.numel()),
        "xent_bwd": dict(
            kernel=lambda i: xent.xent_bwd(logits, labels, gout),
            plain=lambda i: xent.xent_bwd_ref(logits, labels, gout),
            library=lambda i: torch.autograd.grad(lib_out, lf, gout,
                                                  retain_graph=True),
            nbytes=2 * logit_bytes + 8 * n + 4 * n,
            flops=5 * logits.numel()),
    }
    for name, t in timings.items():
        ms = cuda_ms_flushed(torch, t["kernel"], 20)
        plain_ms = cuda_ms_flushed(torch, t["plain"], 3)
        library_ms = cuda_ms_flushed(torch, t["library"], 5)
        b_ms, b_by = bound_ms(t["nbytes"], t["flops"], "float32")
        rows[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"  {name:10s} N={n} C={VOCAB} bf16: {ms * 1e3:.1f} us/launch, "
              f"plain {plain_ms * 1e3:.1f} us, F.cross_entropy "
              f"{library_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
              f"({b_by}: {t['nbytes'] / 1e9:.3f} GB), {b_ms / ms:.1%} of bound")
    del logits, labels, gout, lf, lib_out
    torch.cuda.empty_cache()
    return rows


def flash_bounds(b, t, h, d, causal, elem):
    """{kernel: (bytes, flops)} of one call: each input read once, each
    output written once; products over the (i, j) pairs the mask keeps
    (2*D operations per pair and product: 2 in the forward, 3 for dQ, 4
    for dK/dV)."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor = b * t * h * d * elem
    stats = b * h * t * 4
    return {
        "flash_fwd": (4 * tensor + 2 * stats, 4 * d * pairs),
        "flash_dq": (5 * tensor + 3 * stats, 6 * d * pairs),
        "flash_dkv": (6 * tensor + 3 * stats, 8 * d * pairs),
    }


def check_flash(torch, fa, q, k, v, do, causal, rows):
    """Forward, dQ and dK/dV against the plain versions on the same inputs:
    every entry of O, dQ, dK, dV within ``FLASH_TOL`` and ``m`` within
    1e-5 (+ 1e-5 relative). Updates each kernel's ``max_abs_err`` in
    ``rows``; exits if any disagrees."""
    b, t, h, d = q.shape
    dname = str(q.dtype).split(".")[-1]
    o, m, l = fa.flash_fwd(q, k, v, causal)
    delta = fa.flash_delta(do, o)
    dq, dk, dv = fa.flash_bwd(q, k, v, do, m, l, delta, causal)
    o_ref, m_ref, _ = fa.flash_fwd_ref(q, k, v, causal)
    refs = fa.flash_bwd_ref(q, k, v, do, m, l, delta, causal)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dname]
    failed = []
    m_err = max_err(m, m_ref)
    m_worst = ((m - m_ref).abs() / (1e-5 + 1e-5 * m_ref.abs())).max().item()
    print(f"  flash m  B={b} T={t} H={h} D={d} {dname:8s} max_abs_err={m_err:.3e}"
          f", worst {m_worst:.3f} of 1e-5 + 1e-5 * |ref| (limit 1) "
          f"{'ok' if m_worst <= 1 else 'MISMATCH'}")
    if m_worst > 1:
        failed.append("m")
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]),
                            ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        err = diff.max().item()
        # Elementwise: every entry within atol + rtol * |its reference|.
        worst = (diff / (atol + rtol * want.abs())).max().item()
        rel_l2 = (torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want)).item()
        ok = worst <= 1
        print(f"  flash {name:2s} B={b} T={t} H={h} D={d} causal {dname:8s} "
              f"max_abs_err={err:.3e}, worst entry {worst:.3f} of atol "
              f"{atol:g} + rtol {rtol:g} * |ref| (limit 1), relative L2 "
              f"{rel_l2:.2e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(name)
        kernel = {"o": "flash_fwd", "dq": "flash_dq"}.get(name, "flash_dkv")
        row = rows.setdefault(kernel, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del got, want, diff
    del o_ref, refs
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"flash {failed} ({dname}, D={d}): kernels disagree "
                         "with their plain versions")
    return m, l, o


def phase_flash(torch, fa):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    b, t, h, d = 32, LM["max_len"], LM["num_heads"], LM["d_model"] // LM["num_heads"]
    rows = {}
    # bf16 at D = 128 (the wgmma kernels' other width), at full length.
    g = torch.Generator(device=dev).manual_seed(17)
    wide = [torch.randn((8, t, 6, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4)]
    check_flash(torch, fa, *wide, True, rows)
    del wide
    g = torch.Generator(device=dev).manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
                       for _ in range(4))
        m, l, o = check_flash(torch, fa, q, k, v, do, True, rows)
        if dtype != torch.bfloat16:
            continue
        delta = fa.flash_delta(do, o)
        # The main path's dtype: time each kernel, the plain versions, and
        # PyTorch's SDPA forward and whole backward (dQ, dK and dV in one
        # call) on the same inputs.
        qt, kt, vt = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        do_t = do.transpose(1, 2)
        bwd_plain = cuda_ms_flushed(
            torch, lambda i: fa.flash_bwd_ref(q, k, v, do, m, l, delta, True), 3)
        lib_bwd = cuda_ms_flushed(torch, lambda i: torch.autograd.grad(
            lib_o, (qt, kt, vt), do_t, retain_graph=True), 10)
        timings = {
            "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, True),
                          cuda_ms_flushed(torch, lambda i: fa.flash_fwd_ref(
                              q, k, v, True), 3),
                          cuda_ms_flushed(torch, lambda i: F.scaled_dot_product_attention(
                              qt, kt, vt, is_causal=True), 10)),
            "flash_dq": (lambda i: fa._flash_dq_cuda(q, k, v, do, m, l, delta,
                                                      True),
                         bwd_plain, lib_bwd),
            "flash_dkv": (lambda i: fa._flash_dkv_cuda(q, k, v, do, m, l,
                                                        delta, True),
                          bwd_plain, lib_bwd),
        }
        bounds = flash_bounds(b, t, h, d, True, q.element_size())
        for name, (fn, plain_ms, library_ms) in timings.items():
            ms = cuda_ms_flushed(torch, fn, 20)
            nbytes, flops = bounds[name]
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            rows[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=b_ms, bound_by=b_by)
            print(f"  {name:10s} bf16: {ms * 1e3:.1f} us/launch "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain "
                  f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us, "
                  f"bound {b_ms * 1e3:.1f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.1f} GFLOP), {b_ms / ms:.1%} of bound")
        bwd = rows["flash_dq"]["ms"] + rows["flash_dkv"]["ms"]
        bwd_flops = bounds["flash_dq"][1] + bounds["flash_dkv"][1]
        print(f"  backward, dQ + dK/dV: {bwd * 1e3:.1f} us "
              f"({bwd_flops / bwd / 1e9:.1f} TFLOP/s) against SDPA's whole "
              f"backward {lib_bwd * 1e3:.1f} us: {bwd / lib_bwd:.2f}x")
        del qt, kt, vt, lib_o
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase h, i
def lm_fwd_flops_per_token(num_layers, d_model, seq_len, vocab):
    """Analytic matmul FLOPs per token, forward (the formula of the JAX
    package's LM bench): per block qkv+proj (8 d^2) + MLP (2 d d_ff * 2,
    d_ff = 4d) + attention scores/values (4 s d); LM head (2 d V)."""
    d_ff = 4 * d_model
    return (num_layers * (8 * d_model ** 2 + 4 * d_model * d_ff
                          + 4 * seq_len * d_model)
            + 2 * d_model * vocab)


def lm_batch(batch, seq_len, seed=0):
    """Next-token batch as the JAX package's LM bench makes it."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (batch, seq_len + 1), dtype=np.int64)
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def phase_train(torch, dtt, kernel_mods, batch=32, warmup=2, steps=5):
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    model = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16", **LM))
    model.compile(optimizer=dtt.optim.Adam(1e-4),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.build((t_len,), seed=0)
    t = time.perf_counter()
    model.fit(x, y, batch_size=batch, epochs=warmup, steps_per_epoch=1,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    print(f"  {model.num_params / 1e6:.1f}M params; {warmup} warm-up steps "
          f"in {time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_mods:
        mod.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {}
    for mod in kernel_mods:
        launches.update(mod.launches)
    losses = hist.history["loss"]
    sps = steps / wall
    tokens = batch * t_len
    fwd = lm_fwd_flops_per_token(LM["num_layers"], LM["d_model"], t_len, VOCAB)
    mfu = 3 * fwd * tokens * sps / PEAK_FLOPS["bfloat16"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {[round(v, 5) for v in losses]}, accuracy "
          f"{hist.history['accuracy'][-1]:.5f}")
    print(f"  {steps} steps in {wall:.3f} s: {sps:.3f} steps/s, "
          f"{sps * tokens:.0f} tokens/s, MFU {mfu:.4f} (3 x {fwd / 1e6:.1f} "
          f"MFLOP/token at 989 TFLOP/s), peak memory {peak_gb:.2f} GB")
    per_step = {k: v / steps for k, v in launches.items()
                if not k.startswith("paged")}
    print(f"  launches per step {per_step}")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise SystemExit(f"training losses not finite and falling: {losses}")
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": LM["num_layers"],
            "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"]}
    if per_step != want:
        raise SystemExit(f"launches per step {per_step}, expected {want}")
    routes = {k: v / steps for mod in kernel_mods
              for k, v in getattr(mod, "route_launches", {}).items() if v}
    print(f"  flash routes per step {routes}")
    want_routes = {"flash_fwd/wgmma": want["flash_fwd"],
                   "flash_dkv/wgmma": want["flash_dkv"]}
    if routes != want_routes:
        raise SystemExit(f"flash routes per step {routes}, expected "
                         f"{want_routes}")
    del model
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


def phase_kernel_vs_plain(torch, dtt, batch=4, steps=3):
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len, seed=1)

    def train(flash, loss):
        model = dtt.Model(dtt.models.transformer_lm(
            VOCAB, flash=flash, **dict(LM, num_layers=2)))
        model.compile(optimizer=dtt.optim.Adam(1e-4), loss=loss,
                      metrics=["accuracy"])
        model.build((t_len,), seed=1)
        hist = model.fit(x, y, batch_size=batch, epochs=steps,
                         steps_per_epoch=1, shuffle=False, verbose=0)
        return hist.history["loss"], dtt.interop.params_to_numpy(model.params)

    kern_losses, kern_params = train(True, "pallas_sparse_categorical_crossentropy")
    plain_losses, plain_params = train(False, "sparse_categorical_crossentropy")
    rel = max(abs(a - b) / abs(b) for a, b in zip(kern_losses, plain_losses))
    dparam = max(float(np.abs(kern_params[p] - plain_params[p]).max())
                 for p in kern_params)
    print(f"  kernels {kern_losses}\n  plain   {plain_losses}\n  max "
          f"relative loss difference {rel:.3e} (limit 1e-5), max parameter "
          f"difference {dparam:.3e}")
    if rel > 1e-5:
        raise SystemExit("the kernel path's losses disagree with the plain path")


# ------------------------------------------------------------------ phase j
def phase_fused_adam(torch, dtt, adam_ops, lr=3e-4, wd=0.01):
    dev = torch.device("cuda")
    lm = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16", **LM))
    lm.build((LM["max_len"],), seed=0)
    base = [p.detach() for p in lm.params.values()]
    n = sum(p.numel() for p in base)
    g = torch.Generator(device=dev).manual_seed(17)
    grads = [torch.randn(p.shape, generator=g, device=dev) * 1e-2 for p in base]
    per_update = math.ceil(len(base) / adam_ops.MAX_LEAVES)
    print(f"  {len(base)} leaves, {n / 1e6:.1f}M f32 entries: {per_update} "
          f"launches per update ({adam_ops.MAX_LEAVES} leaves per launch)")
    err, failed = 0.0, []
    for fused, plain in (("fused_adam", "adam"), ("fused_adamw", "adamw")):
        runs = []
        for name in (fused, plain):
            opt = dtt.optim.get(name, learning_rate=lr)
            params = [p.clone() for p in base]
            state = opt.init(params)
            for _ in range(3):
                opt.update(params, grads, state)
            runs.append(params + state["mu"] + state["nu"])
        torch.cuda.synchronize()
        bad = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for a, b in zip(*runs))
        e = max(max_err(a, b) for a, b in zip(*runs))
        err = max(err, e)
        print(f"  {fused:11s} vs {plain:5s} (plain), 3 updates: {bad} of "
              f"{3 * n} p/m/v entries differ in any bit, max_abs_err "
              f"{e:.3e} (limit: bit-identical) {'ok' if not bad else 'MISMATCH'}")
        if bad:
            failed.append(fused)
        del runs
    if failed:
        raise SystemExit(f"{failed}: the fused Adam kernel disagrees with its "
                         "plain version")

    def f32(v):
        return float(torch.tensor(v, dtype=torch.float32))

    s = adam_ops.AdamScalars(
        neg_lr=-f32(lr), b1=f32(0.9), b2=f32(0.999), c1=f32(1 - f32(0.9)),
        c2=f32(1 - f32(0.999)), eps=f32(1e-8), wd=f32(wd),
        bc1=f32(1 - f32(0.9) ** 4), bc2=f32(1 - f32(0.999) ** 4))
    p = [x.clone() for x in base]
    m = [torch.zeros_like(x) for x in base]
    v = [torch.zeros_like(x) for x in base]
    ms = cuda_ms_flushed(torch, lambda i: adam_ops.adam_update(p, grads, m, v, s),
                         20, ahead=True)
    plain_ms = cuda_ms_flushed(
        torch, lambda i: adam_ops.adam_update_ref(p, grads, m, v, s), 5,
        ahead=True)
    lib_params = [torch.nn.Parameter(x.clone()) for x in base]
    for q, gr in zip(lib_params, grads):
        q.grad = gr
    lib = torch.optim.AdamW(lib_params, lr=lr, weight_decay=wd, fused=True)
    library_ms = cuda_ms_flushed(torch, lambda i: lib.step(), 5, ahead=True)
    # Each entry reads p, g, m, v and writes p, m, v (f32); 16 operations
    # (7 in the moments, 5 in the normalised step, 2 each for the decay
    # and the apply).
    nbytes, flops = 28 * n, 16 * n
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    print(f"  fused_adamw update: {ms * 1e3:.1f} us ({per_update} launches), "
          f"plain foreach {plain_ms * 1e3:.1f} us, torch.optim.AdamW(fused="
          f"True) {library_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
          f"({b_by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), "
          f"{b_ms / ms:.1%} of bound")
    del lm, base, grads, p, m, v, lib, lib_params
    torch.cuda.empty_cache()
    return {"fused_adam": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=b_ms,
                               bound_by=b_by)}


# ------------------------------------------------------------------ phase k
def fit_timed(torch, model, x, y, batch, warmup, steps):
    """(mean loss of the timed steps, wall s): ``warmup`` steps, then
    ``steps`` steps as one epoch of ``fit`` on the repeated batch (one
    host sync at its end)."""
    model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=warmup,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    return hist.history["loss"][0], time.perf_counter() - t


def phase_cnn(torch, dtt, batch=256):
    port = dtt.cluster.free_port()
    os.environ["DTPU_CONFIG"] = dtt.cluster.ClusterSpec(
        workers=[f"127.0.0.1:{port}"], index=0).to_json()
    spec = dtt.cluster.initialize(timeout=120)
    strategy = dtt.DataParallel()
    print(f"  cluster: {spec.num_processes} worker(s), process group "
          f"{torch.distributed.get_backend()} of world "
          f"{strategy.num_replicas_in_sync}, device {strategy.device}")
    loss = "sparse_categorical_crossentropy"
    x, y = dtt.data.synthetic_images(batch, (28, 28), 10, 0)
    x = x[..., None].astype(np.float32) / 255.0

    def mnist(strat, seed=0):
        with strat.scope():
            m = dtt.Model(dtt.models.mnist_cnn())
            m.compile(optimizer=dtt.optim.SGD(0.001), loss=loss,
                      metrics=["accuracy"])
        m.build((28, 28, 1), seed=seed)
        return m

    rng = np.random.default_rng(0)
    cx = rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)
    cy = rng.integers(0, 10, (batch,), dtype=np.int64).astype(np.int32)
    with strategy.scope():
        cifar = dtt.Model(dtt.models.cifar_cnn())
        cifar.compile(optimizer=dtt.optim.SGD(0.01, momentum=0.9), loss=loss,
                      metrics=["accuracy"])
    cifar.build((32, 32, 3))
    for name, model, xs, ys, warmup, steps in (
            ("mnist_cnn", mnist(strategy), x, y, 10, 100),
            ("cifar_cnn", cifar, cx, cy, 5, 50)):
        mean_loss, wall = fit_timed(torch, model, xs, ys, batch, warmup, steps)
        sps = steps / wall
        print(f"  {name} ({model.num_params} params), global batch {batch}, "
              f"TF32 off: {steps} steps in {wall:.3f} s after {warmup} warm-up: "
              f"{sps:.2f} steps/s, {sps * batch:.0f} images/s, mean loss "
              f"{mean_loss:.5f}")
        if not np.isfinite(mean_loss):
            raise SystemExit(f"{name}: training loss not finite")
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for strat in (strategy, dtt.SingleDevice()):
            hist = mnist(strat, seed=1).fit(x, y, batch_size=batch, epochs=5,
                                            steps_per_epoch=1, shuffle=False,
                                            verbose=0)
            runs.append(hist.history["loss"])
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  DataParallel (world 1) {runs[0]}\n  SingleDevice           "
          f"{runs[1]}: {'equal' if runs[0] == runs[1] else 'DIFFER'}")
    if runs[0] != runs[1]:
        raise SystemExit("DataParallel over one rank and SingleDevice differ")
    return strategy


# ------------------------------------------------------------------ phase l
def phase_dp_lm(torch, dtt, strategy, kernel_mods, batch=32, warmup=2,
                steps=5):
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)

    def lm(optimizer):
        with strategy.scope():
            model = dtt.Model(dtt.models.transformer_lm(
                VOCAB, dtype="bfloat16", **LM))
            model.compile(optimizer=optimizer,
                          loss="pallas_sparse_categorical_crossentropy",
                          metrics=["accuracy"])
        model.build((t_len,), seed=0)
        return model

    model = lm(dtt.optim.fused_adamw(3e-4, weight_decay=0.01))
    model.fit(x, y, batch_size=batch, epochs=warmup, steps_per_epoch=1,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_mods:
        mod.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {}
    for mod in kernel_mods:
        launches.update(mod.launches)
    losses = hist.history["loss"]
    sps = steps / wall
    tokens = batch * t_len
    fwd = lm_fwd_flops_per_token(LM["num_layers"], LM["d_model"], t_len, VOCAB)
    mfu = 3 * fwd * tokens * sps / PEAK_FLOPS["bfloat16"]
    print(f"  losses {[round(v, 5) for v in losses]}")
    print(f"  {steps} steps in {wall:.3f} s: {sps:.3f} steps/s, "
          f"{sps * tokens:.0f} tokens/s, MFU {mfu:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    per_step = {k: v / steps for k, v in launches.items()
                if not k.startswith("paged")}
    print(f"  launches per step {per_step}")
    leaves = len(model.params)
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": LM["num_layers"],
            "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"],
            "fused_adam": math.ceil(leaves / 64)}
    if per_step != want:
        raise SystemExit(f"launches per step {per_step}, expected {want}")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise SystemExit(f"training losses not finite and falling: {losses}")
    del model
    torch.cuda.empty_cache()
    runs = []
    for opt in (dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                dtt.optim.AdamW(3e-4, weight_decay=0.01)):
        model = lm(opt)
        runs.append(model.fit(x, y, batch_size=batch, epochs=3,
                              steps_per_epoch=1, shuffle=False,
                              verbose=0).history["loss"])
        del model
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    print(f"  fused_adamw {runs[0]}\n  AdamW       {runs[1]}\n  "
          f"{'identical' if runs[0] == runs[1] else 'not identical'}, max "
          f"relative difference {rel:.3e} (limit 1e-5)")
    if rel > 1e-5:
        raise SystemExit("fused_adamw and AdamW losses disagree")
    return launches["fused_adam"]


# ------------------------------------------------------------------ phase m
RESNET_BATCH = 256
# Forward FLOPs of ResNet-50 per 224x224 image: 4.09 G multiply-adds, 2
# FLOPs each (bench.py's 4.089e9 counts multiply-adds as FLOPs).
RESNET50_FWD_FLOPS = 8.17e9


def resnet50_shapes(torch, dtt, batch=RESNET_BATCH):
    """{(M, K, N): count} of ResNet-50's 1x1 convolutions and {(M, C):
    count} of its BatchNorms at ``batch`` images of 224x224, read from the
    layers of a built model."""
    module = dtt.models.resnet50(1000)
    module.build((224, 224, 3), torch.Generator().manual_seed(0))
    convs, bns = {}, {}
    for layer in module.modules():
        if isinstance(layer, dtt.nn.Conv2D) and layer.kernel_size == (1, 1):
            h, w, cin = layer.input_shape
            sh, sw = layer.strides
            key = (batch * -(-h // sh) * -(-w // sw), cin, layer.filters)
            convs[key] = convs.get(key, 0) + 1
        elif isinstance(layer, dtt.nn.BatchNorm):
            h, w, c = layer.input_shape
            bns[(batch * h * w, c)] = bns.get((batch * h * w, c), 0) + 1
    return convs, bns


def check_conv1x1(torch, conv_ops, x, w):
    """(max_abs_err, worst, ok) of K12 against its plain version."""
    got = conv_ops.conv1x1(x, w)
    want = conv_ops.conv1x1_ref(x, w)
    bound = x.float().abs() @ w.float().abs()
    torch.cuda.synchronize()
    err = max_err(got, want)
    if x.dtype == torch.float32:
        limit = 2e-5 * bound
    else:  # one bf16 ulp of each entry plus the f32 sums' rounding bound
        want = want.float()
        limit = (torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
            + 2 * x.shape[1] * 2.0 ** -24 * bound)
    worst = ((got.float() - want).abs() / (limit + 1e-30)).max().item()
    del got, want, bound, limit
    return err, worst, worst <= 1


def check_sums(got, want, magnitude):
    """(max_abs_err, worst, ok): (2, C) sums within rtol 1e-5 plus 1e-5 x
    ``magnitude``, each sum's sum of |terms| (a sum of signed terms can
    cancel to near 0; the order of the additions moves it by a share of
    the terms' magnitudes)."""
    atol = 1e-5 * magnitude
    worst = ((got - want).abs() / (1e-5 * want.abs() + atol + 1e-30)).max().item()
    return (got - want).abs().max().item(), worst, worst <= 1


def library_ms_or_none(torch, fn, iters, what):
    """A library yardstick's time, or None (printed) when it does not take
    these inputs; only the yardstick is optional, never a kernel."""
    try:
        return cuda_ms_flushed(torch, fn, iters)
    except RuntimeError as e:
        print(f"    {what}: no library time ({str(e).splitlines()[0][:120]})")
        return None


def phase_resnet_kernels(torch, dtt, conv_ops, bn_ops):
    dev = torch.device("cuda")
    convs, bns = resnet50_shapes(torch, dtt)
    print(f"  ResNet-50 at batch {RESNET_BATCH}: {sum(convs.values())} 1x1 "
          f"convolutions at {len(convs)} forward shapes, {sum(bns.values())} "
          f"BatchNorms at {len(bns)} shapes")
    g = torch.Generator(device=dev).manual_seed(19)
    failed = []
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                         nbytes=0, flops=0, max_abs_err=0.0)
              for name in ("conv1x1", "bn_stats", "bn_bwd_reduce")}

    def add(name, count, err, ms, plain_ms, lib_ms, nbytes, flops, dtype):
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if dtype != torch.bfloat16:
            return
        b_ms, _ = bound_ms(nbytes, flops, "float32" if name != "conv1x1"
                           else "bfloat16")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("library_ms", lib_ms)):
            t[k] = None if v is None or t[k] is None else t[k] + count * v
        t["nbytes"] += count * nbytes
        t["flops"] += count * flops

    # K12: x @ w at every shape of a training step in bf16, one shape in
    # f32. A step runs each 1x1 convolution's forward (M, K) @ (K, N) and
    # its dX, (M, N) @ (N, K) with W^T made contiguous.
    products = {}
    for (m, k, n), count in convs.items():
        for shape in ((m, k, n), (m, n, k)):
            products[shape] = products.get(shape, 0) + count
    cases = [(shape, torch.bfloat16) for shape in sorted(products)]
    cases.append(((50176, 256, 1024), torch.float32))
    for (m, k, n), dtype in cases:
        x = torch.randn((m, k), generator=g, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
        err, worst, ok = check_conv1x1(torch, conv_ops, x, w)
        dname = str(dtype).split(".")[-1]
        count = products[(m, k, n)] if dtype == torch.bfloat16 else 0
        line = (f"  conv1x1 ({m:>7}, {k:>4}, {n:>4}) {dname:8s} x{count}: "
                f"max_abs_err {err:.3e}, worst {worst:.3f} of its limit "
                f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(f"conv1x1 {(m, k, n)} {dname}")
        e = x.element_size()
        nbytes, flops = (m * k + k * n + m * n) * e, 2 * m * k * n
        ms = plain_ms = lib_ms = None
        if dtype == torch.bfloat16:
            ms = cuda_ms_flushed(torch, lambda i: conv_ops.conv1x1(x, w), 10)
            plain_ms = cuda_ms_flushed(
                torch, lambda i: conv_ops.conv1x1_ref(x, w), 3)
            lib_ms = cuda_ms_flushed(torch, lambda i: torch.matmul(x, w), 10)
            b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
            line += (f"; {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f}, "
                     f"torch.matmul {lib_ms * 1e3:.1f}, bound {b_ms * 1e3:.1f} "
                     f"({b_by}), {b_ms / ms:.1%} of bound")
        print(line)
        add("conv1x1", count, err, ms, plain_ms, lib_ms, nbytes, flops, dtype)
        del x, w
    torch.cuda.empty_cache()

    # K13 and K14 at every BatchNorm shape in bf16, one shape in f32.
    cases = [(shape, torch.bfloat16) for shape in sorted(bns)]
    cases.append(((50176, 256), torch.float32))
    for (m, c), dtype in cases:
        x = (torch.randn((m, c), generator=g, device=dev) * 2 + 1).to(dtype)
        dy = torch.randn((m, c), generator=g, device=dev).to(dtype)
        shift = torch.randn((c,), generator=g, device=dev) * 0.5
        mean = torch.randn((c,), generator=g, device=dev) * 0.5
        inv = torch.rand((c,), generator=g, device=dev) + 0.5
        count = bns.get((m, c), 0) if dtype == torch.bfloat16 else 0
        dname = str(dtype).split(".")[-1]
        stats = bn_ops.bn_stats(x, shift)
        again = bn_ops.bn_stats(x, shift)
        bwd = bn_ops.bn_bwd_reduce(dy, x, mean, inv)
        bwd_again = bn_ops.bn_bwd_reduce(dy, x, mean, inv)
        xc = x.float() - shift
        mag = torch.stack([xc.abs().sum(0), xc.square().sum(0)])
        del xc
        s_err, s_worst, s_ok = check_sums(stats, bn_ops.bn_stats_ref(x, shift),
                                          mag)
        dyf = dy.float()
        mag = torch.stack([dyf.abs().sum(0),
                           (dyf * (x.float() - mean) * inv).abs().sum(0)])
        del dyf
        b_err, b_worst, b_ok = check_sums(
            bwd, bn_ops.bn_bwd_reduce_ref(dy, x, mean, inv), mag)
        del mag
        same = torch.equal(stats, again) and torch.equal(bwd, bwd_again)
        ok = s_ok and b_ok and same
        line = (f"  bn ({m:>7}, {c:>4}) {dname:8s} x{count}: bn_stats "
                f"max_abs_err {s_err:.3e} worst {s_worst:.3f}, bn_bwd_reduce "
                f"{b_err:.3e} worst {b_worst:.3f}, repeat calls "
                f"{'bit-identical' if same else 'DIFFER'} "
                f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(f"bn {(m, c)} {dname}")
        e = x.element_size()
        s_bytes, s_flops = m * c * e + 12 * c, 4 * m * c
        b_bytes, b_flops = 2 * m * c * e + 16 * c, 5 * m * c
        times = {"bn_stats": (None,) * 3, "bn_bwd_reduce": (None,) * 3}
        if dtype == torch.bfloat16:
            # The library's reductions on the NCHW view of the same rows
            # (mean/invstd and the backward's sums, in another form).
            x4, dy4 = x.view(m, c, 1, 1), dy.view(m, c, 1, 1)
            weight = torch.ones((c,), device=dev)
            times = {
                "bn_stats": (
                    cuda_ms_flushed(torch, lambda i: bn_ops.bn_stats(x, shift), 10),
                    cuda_ms_flushed(torch, lambda i: bn_ops.bn_stats_ref(x, shift), 3),
                    library_ms_or_none(torch, lambda i: torch.batch_norm_stats(
                        x4, 1e-5), 10, "torch.batch_norm_stats")),
                "bn_bwd_reduce": (
                    cuda_ms_flushed(torch, lambda i: bn_ops.bn_bwd_reduce(
                        dy, x, mean, inv), 10),
                    cuda_ms_flushed(torch, lambda i: bn_ops.bn_bwd_reduce_ref(
                        dy, x, mean, inv), 3),
                    library_ms_or_none(
                        torch, lambda i: torch.batch_norm_backward_reduce(
                            dy4, x4, mean, inv, weight, True, True, True), 10,
                        "torch.batch_norm_backward_reduce")),
            }
            for name, (ms, plain_ms, lib_ms) in times.items():
                nb, fl = (s_bytes, s_flops) if name == "bn_stats" else (b_bytes, b_flops)
                b_ms, b_by = bound_ms(nb, fl, "float32")
                lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f}"
                line += (f"\n      {name:13s} {ms * 1e3:.1f} us ("
                         f"{bn_ops.LAUNCHES_PER_CALL} launches), plain "
                         f"{plain_ms * 1e3:.1f}, library {lib}, bound "
                         f"{b_ms * 1e3:.1f} ({b_by}), {b_ms / ms:.1%} of bound")
        print(line)
        add("bn_stats", count, s_err, *times["bn_stats"], s_bytes, s_flops, dtype)
        add("bn_bwd_reduce", count, b_err, *times["bn_bwd_reduce"], b_bytes,
            b_flops, dtype)
        del x, dy, stats, again, bwd, bwd_again
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"{failed}: kernels disagree with their plain versions")
    rows = {}
    for name, t in totals.items():
        what = ("72 products, 36 forward and 36 dX" if name == "conv1x1"
                else "53 calls")
        b_ms, b_by = bound_ms(t["nbytes"], t["flops"],
                              "bfloat16" if name == "conv1x1" else "float32")
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        print(f"  {name:13s} per step ({what}): {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f}, library {lib}, bound {b_ms:.3f} ms "
              f"({b_by}: {t['nbytes'] / 1e9:.2f} GB, {t['flops'] / 1e9:.1f} "
              f"GFLOP), {b_ms / t['ms']:.1%} of bound")
        rows[name] = dict(max_abs_err=t["max_abs_err"], ms=t["ms"],
                          plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                          library_ms=t["library_ms"])
    return rows


# ------------------------------------------------------------------ phase n
def resnet_batch(batch, size=224, classes=1000, seed=0):
    """``bench_resnet50``'s batch: normals and labels from default_rng."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3), dtype=np.float32)
    y = rng.integers(0, classes, (batch,), dtype=np.int64).astype(np.int32)
    return x, y


def phase_resnet_train(torch, dtt, strategy, conv_ops, bn_ops, warmup=3,
                       steps=20):
    batch = RESNET_BATCH
    x, y = resnet_batch(batch)
    with strategy.scope():
        model = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16"))
        model.compile(optimizer=dtt.optim.SGD(0.1, momentum=0.9),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])
    model.build((224, 224, 3), seed=0)
    t = time.perf_counter()
    model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=warmup,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    print(f"  {model.num_params} params in {len(model.params)} leaves, "
          f"{len(model.state)} BN buffers; {warmup} warm-up steps in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    conv_ops.reset_launch_counts()
    bn_ops.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(conv_ops.launches, **bn_ops.launches)
    losses = hist.history["loss"]
    sps = steps / wall
    mfu = 3 * RESNET50_FWD_FLOPS * batch * sps / PEAK_FLOPS["bfloat16"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {[round(v, 5) for v in losses]}, accuracy "
          f"{hist.history['accuracy'][-1]:.5f}")
    print(f"  {steps} steps in {wall:.3f} s: {sps:.3f} steps/s, "
          f"{sps * batch:.1f} images/s, MFU {mfu:.4f} (3 x 8.17 GFLOP/image "
          f"at 989 TFLOP/s), peak memory {peak_gb:.2f} GB")
    per_call = bn_ops.LAUNCHES_PER_CALL
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"  launches per step {per_step} (K13/K14: {per_call} per call)")
    buffers = all(bool(torch.isfinite(b).all()) for b in model.state.values())
    print(f"  BN buffers finite: {buffers}; running var of the stem BN "
          f"{model.state['batch_norm/var'][:4].tolist()}")
    want = {"conv1x1": 72, "bn_stats": 53 * per_call,
            "bn_bwd_reduce": 53 * per_call}
    if per_step != want:
        raise SystemExit(f"launches per step {per_step}, expected {want}")
    if not all(np.isfinite(losses)) or not buffers:
        raise SystemExit(f"ResNet-50 losses or BN buffers not finite: {losses}")
    del model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase o
def phase_resnet_kernel_vs_plain(torch, dtt, strategy, batch=32, steps=3):
    x, y = resnet_batch(batch, size=32, classes=10, seed=1)
    tiny = dict(small_inputs=True, stage_blocks=(1, 1, 1, 1), width=16)
    compile_kw = dict(loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])

    def train(strat):
        with strat.scope():
            model = dtt.Model(dtt.models.resnet(50, 10, **tiny))
            model.compile(optimizer=dtt.optim.SGD(0.01, momentum=0.9),
                          **compile_kw)
        model.build((32, 32, 3), seed=1)
        hist = model.fit(x, y, batch_size=batch, epochs=steps,
                         steps_per_epoch=1, shuffle=False, verbose=0)
        return hist.history["loss"], dtt.interop.state_to_numpy(model.state)

    card, _ = train(dtt.SingleDevice())
    cpu, _ = train(dtt.SingleDevice("cpu"))
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"  card (kernels) {card}\n  CPU (plain)    {cpu}\n  max relative "
          f"loss difference {rel:.3e} (limit 1e-4)")
    if rel > 1e-4:
        raise SystemExit("the kernel path's losses disagree with the plain path")
    torch.backends.cudnn.deterministic = True
    try:
        (dp, dp_state), (single, single_state) = (train(strategy),
                                                  train(dtt.SingleDevice()))
    finally:
        torch.backends.cudnn.deterministic = False
    same_state = all(np.array_equal(dp_state[k], single_state[k])
                     for k in single_state)
    print(f"  DataParallel (world 1) {dp}\n  SingleDevice           {single}: "
          f"losses {'equal' if dp == single else 'DIFFER'}, BN buffers "
          f"{'equal' if same_state else 'DIFFER'}")
    if dp != single or not same_state:
        raise SystemExit("DataParallel over one rank and SingleDevice differ")


# ------------------------------------------------------------------ phase p
def differential_s(torch, fn, n1=10, n2=60, warmup=3):
    """Seconds per call of ``fn()`` by the difference of two run lengths,
    each ending in a synchronize (the JAX package's profile_op_floor
    method): the fixed cost of a run (the sync) cancels."""
    def run(n):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run(n1)
    t1 = run(n1)
    t2 = run(n2)
    return max(t2 - t1, 1e-9) / (n2 - n1)


def phase_launch_probe(torch, probe_ops):
    dev = torch.device("cuda")
    x = torch.randn(probe_ops.SHAPE, generator=torch.Generator(
        device=dev).manual_seed(23), device=dev)
    probe_ops.reset_launch_counts()
    got = probe_ops.launch_probe(x)
    want = probe_ops.launch_probe_ref(x)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    print(f"  launch_probe {tuple(x.shape)} f32 vs x * 1.0001: "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("launch_probe disagrees with its plain version")
    ms = 1e3 * differential_s(torch, lambda: probe_ops.launch_probe(x))
    plain_ms = 1e3 * differential_s(torch, lambda: probe_ops.launch_probe_ref(x))
    library_ms = 1e3 * differential_s(torch, lambda: torch.mul(x, 1.0001))
    launches = probe_ops.launches["launch_probe"]
    nbytes = 2 * x.numel() * 4
    b_ms, b_by = bound_ms(nbytes, x.numel(), "float32")
    print(f"  per launch (differential, 10 vs 60 calls): {ms * 1e3:.2f} us; "
          f"plain version {plain_ms * 1e3:.2f} us; torch.mul(x, 1.0001) "
          f"{library_ms * 1e3:.2f} us; bound {b_ms * 1e6:.2f} ns ({b_by}: "
          f"{nbytes} bytes); {launches} launches")
    return {"launch_probe": dict(max_abs_err=max_err(got, want), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=library_ms,
                                 launches=launches)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import _build
    from distributed_tpu_torch.ops import bn_reduce as bn_ops
    from distributed_tpu_torch.ops import conv1x1 as conv_ops
    from distributed_tpu_torch.ops import flash_attention as flash_ops
    from distributed_tpu_torch.ops import fused_update as adam_ops
    from distributed_tpu_torch.ops import launch_probe as probe_ops
    from distributed_tpu_torch.ops import paged_attention as paged_ops
    from distributed_tpu_torch.ops import pallas_kernels as xent_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {card}")

    print("phase a: build")
    t = time.perf_counter()
    built = _build.build(*sorted(set(SOURCES.values())))
    print(f"  built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t:.1f} s (one nvcc per source, in parallel)")
    for _, log in built.values():
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"    {line.split('Compiling entry function')[-1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"      {line.strip()}")
    wgmma_report(flash_ops, *built["flash_attention"])

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
    q8, tel8, wall8 = serve(dtt, model, reqs, kv_dtype="int8",
                            decode_kernel="fused")
    launches = dict(paged_ops.launches)
    report("int8 KV", tel8, wall8)
    print(f"  launches {launches}")
    if launches["paged_attention_int8"] == 0:
        raise SystemExit("the int8 run never launched the int8 kernel")
    check_outputs(q8, reqs, VOCAB)
    rows["paged_attention_int8"]["launches"] = launches["paged_attention_int8"]
    share8, _ = agreement(q8, fused, reqs)
    print(f"  int8 vs bf16 KV: token agreement {share8:.4f}")
    del model
    torch.cuda.empty_cache()

    print(f"phase f: fused cross-entropy kernels vs plain (C={VOCAB}, bf16)")
    rows.update(phase_xent(torch, xent_ops))

    print("phase g: flash-attention kernels vs plain (B=32, T=1024, H=12, "
          "D=64, causal)")
    rows.update(phase_flash(torch, flash_ops))

    print("phase h: GPT-2-small LM training, bf16 layers, Adam(1e-4), pallas "
          "loss, batch 32 x 1024")
    train_launches = phase_train(torch, dtt, (xent_ops, flash_ops))
    for name, n in train_launches.items():
        rows[name]["launches"] = n

    print("phase i: 2 layers, f32, TF32 off: kernel path vs plain path, 3 "
          "Adam steps")
    phase_kernel_vs_plain(torch, dtt)

    print("phase j: fused Adam kernel vs plain, GPT-2-small's parameter tree")
    rows.update(phase_fused_adam(torch, dtt, adam_ops))

    print("phase k: mnist_cnn and cifar_cnn under DataParallel (NCCL, world 1)")
    strategy = phase_cnn(torch, dtt)

    print("phase l: GPT-2-small under DataParallel, fused_adamw(3e-4, wd "
          "0.01), pallas loss, batch 32 x 1024")
    rows["fused_adam"]["launches"] = phase_dp_lm(
        torch, dtt, strategy, (xent_ops, flash_ops, adam_ops))

    print("phase m: K12, K13, K14 vs plain at ResNet-50's shapes (batch 256, "
          "224x224)")
    rows.update(phase_resnet_kernels(torch, dtt, conv_ops, bn_ops))

    print("phase n: ResNet-50 training under DataParallel, bf16, SGD(0.1, "
          "momentum=0.9), batch 256 x 224x224")
    resnet_launches = phase_resnet_train(torch, dtt, strategy, conv_ops,
                                         bn_ops)
    for name in ("conv1x1", "bn_stats", "bn_bwd_reduce"):
        rows[name]["launches"] = resnet_launches[name]

    print("phase o: small f32 ResNet, TF32 off: card vs CPU, then "
          "DataParallel (world 1) vs SingleDevice")
    phase_resnet_kernel_vs_plain(torch, dtt, strategy)
    dtt.cluster.shutdown()

    print("phase p: the launch probe (K15) vs x * 1.0001")
    rows.update(phase_launch_probe(torch, probe_ops))

    kernels = [
        {"name": name, "route": "cuda",
         "source": f"distributed_tpu_torch/csrc/{SOURCES[name]}.cu",
         "replaces": REPLACES[name], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
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
