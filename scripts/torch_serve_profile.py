#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one NVIDIA card.

    python3 scripts/torch_serve_profile.py [--layers 12] [--kv-dtype int8]

Serves chip_smoke.py's workload (the GPT-2-small LM at full width, bf16
layers, random weights from seed 0; 16 greedy requests, prompts of 32-512
tokens, 64-128 new tokens) through ``Engine(max_slots=8, block_size=16,
max_len=1024)`` with the fused decode kernel, three times:

1. a warm-up run;
2. a timed run: the host wall time of every prefill and decode dispatch
   (each ends by copying its sampled token to the host, so it includes
   the device work), and the rest of the loop (scheduling, bookkeeping);
3. a profiled run (``torch.profiler``, CPU and CUDA): device time by
   kernel and the GPU spans of the prefill and decode ranges. The
   profiler slows the host, not the device, so the device's busy share
   is the kernels' total over the timed run's wall time.

Prints a summary and writes the numbers to ``chiprun_out/serve_profile.json``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the workload definition)
import distributed_tpu_torch as dtt  # noqa: E402


def timed(fn, bucket):
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        bucket.append(time.perf_counter() - t)
        return out
    return wrapper


def labelled(fn, label):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=chip_smoke.LM["num_layers"])
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "serve_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2

    model = dtt.Model(dtt.models.transformer_lm(
        chip_smoke.VOCAB, dtype="bfloat16",
        **dict(chip_smoke.LM, num_layers=args.layers)))
    model.build((chip_smoke.LM["max_len"],), seed=0)
    reqs = chip_smoke.requests(16, (32, 512), (64, 128))
    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                max_len=chip_smoke.LM["max_len"],
                                kv_dtype=args.kv_dtype, decode_kernel="fused")

    def run():
        t = time.perf_counter()
        engine.run([dtt.serving.Request(p, m) for p, m in reqs])
        return time.perf_counter() - t

    run()  # warm-up

    prefill_s, decode_s = [], []
    plain_prefill, plain_decode = engine._prefill, engine._decode
    engine._prefill = timed(plain_prefill, prefill_s)
    engine._decode = timed(plain_decode, decode_s)
    wall = run()
    tel = engine.last_run_telemetry
    other = wall - sum(prefill_s) - sum(decode_s)

    engine._prefill = labelled(plain_prefill, "prefill")
    engine._decode = labelled(plain_decode, "decode")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        prof_wall = run()
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    def dev_total_us(e):
        return float(getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0)))

    # Device-side events only (kernels and copies), without the GPU spans
    # of the prefill/decode annotations: their sum is the device busy time.
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(
        ({"name": e.key, "count": int(e.count), "device_ms": dev_us(e) / 1e3}
         for e in events
         if e.device_type == cuda and e.key not in ("prefill", "decode")
         and dev_us(e) > 0),
        key=lambda r: -r["device_ms"],
    )
    busy_ms = sum(k["device_ms"] for k in kernels)
    # GPU span of each annotated range: first to last kernel, idle included.
    ranges = {e.key: {"count": int(e.count),
                      "device_span_ms": dev_total_us(e) / 1e3}
              for e in events
              if e.key in ("prefill", "decode") and e.device_type == cuda}
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": chip_smoke.card_line(),
        "layers": args.layers,
        "kv_dtype": args.kv_dtype,
        "timed_run": {
            "wall_s": wall,
            "tokens_per_sec": tel["tokens_per_sec"],
            "ttft_p50_s": tel["time_to_first_token"]["p50"],
            "ttft_p99_s": tel["time_to_first_token"]["p99"],
            "decode_steps": tel["decode_steps"],
            "prefill_dispatches": tel["prefill_dispatches"],
            "prefill_s": sum(prefill_s),
            "decode_s": sum(decode_s),
            "decode_ms_per_step": 1e3 * float(np.mean(decode_s)),
            "loop_other_s": other,
        },
        "profiled_run": {
            "wall_s": prof_wall,
            "device_busy_ms": busy_ms,
            "device_busy_share_of_timed_run": busy_ms / (1e3 * wall),
            "ranges": ranges,
            "top_kernels": kernels[:15],
        },
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    t = result["timed_run"]
    print(f"{result['card']} | layers {args.layers} kv {args.kv_dtype}")
    print(f"timed run: {wall:.3f} s, {t['tokens_per_sec']:.1f} tokens/s; "
          f"prefill {t['prefill_s']:.3f} s over {t['prefill_dispatches']} "
          f"dispatches, decode {t['decode_s']:.3f} s over "
          f"{t['decode_steps']} steps ({t['decode_ms_per_step']:.2f} ms/step),"
          f" loop other {other:.3f} s")
    p = result["profiled_run"]
    print(f"profiled run: {prof_wall:.3f} s wall; device busy {busy_ms:.1f} "
          f"ms = {p['device_busy_share_of_timed_run']:.1%} of the timed run")
    for name, r in ranges.items():
        print(f"  range {name}: {r['count']} calls, device span "
              f"{r['device_span_ms']:.1f} ms")
    for k in kernels[:15]:
        print(f"  {k['device_ms']:9.2f} ms  x{k['count']:6d}  {k['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
