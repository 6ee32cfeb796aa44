#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one NVIDIA card.

    python3 scripts/torch_serve_profile.py [--layers 12] [--kv-dtype int8]
        [--spec-k 4 --draft-layers 6]

Serves chip_smoke.py's workload (the GPT-2-small LM at full width, bf16
layers, random weights from seed 0; 16 greedy requests, prompts of 32-512
tokens, 64-128 new tokens) through ``Engine(max_slots=8, block_size=16,
max_len=1024)`` with the fused decode kernel, three times. With
``--spec-k``, speculatively, with chip_smoke.py's truncated-depth draft
of ``--draft-layers`` blocks (0: the target is its own draft).

1. a warm-up run;
2. a timed run: the engine's own spans, host seconds of every prefill,
   draft-chain and decode/verify pass (each ends by copying its sampled
   tokens to the host, so it includes the device work), and the rest of
   the loop (scheduling, bookkeeping);
3. a profiled run (``torch.profiler``, CPU and CUDA): device time by
   kernel and the GPU spans of the engine's prefill, draft and decode
   ranges. The profiler slows the host, not the device, so the device's
   busy share is the kernels' total over the timed run's wall time.

Prints a summary and writes the numbers to ``chiprun_out/serve_profile.json``.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the workload definition)
import distributed_tpu_torch as dtt  # noqa: E402


SPANS = ("prefill", "draft", "decode")  # the engine's obs spans


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=chip_smoke.LM["num_layers"])
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--spec-k", type=int, default=None)
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="blocks of the truncated draft (0: self-draft; "
                         "default half the target's)")
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
    spec = {}
    if args.spec_k:
        layers = (args.layers // 2 if args.draft_layers is None
                  else args.draft_layers)
        spec = {"spec_k": args.spec_k, "draft_model": model if layers == 0
                else chip_smoke.truncated_draft(dtt, model, layers,
                                                dtype="bfloat16", seed=1)}
    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                max_len=chip_smoke.LM["max_len"],
                                kv_dtype=args.kv_dtype, decode_kernel="fused",
                                **spec)

    def run():
        t = time.perf_counter()
        engine.run([dtt.serving.Request(p, m) for p, m in reqs])
        return time.perf_counter() - t

    run()  # warm-up

    wall = run()
    tel = engine.last_run_telemetry
    other = wall - sum(tel.get(name, 0.0) for name in SPANS)

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
    # of the engine's ranges: their sum is the device busy time.
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(
        ({"name": e.key, "count": int(e.count), "device_ms": dev_us(e) / 1e3}
         for e in events
         if e.device_type == cuda and e.key not in SPANS
         and dev_us(e) > 0),
        key=lambda r: -r["device_ms"],
    )
    busy_ms = sum(k["device_ms"] for k in kernels)
    # GPU span of each annotated range: first to last kernel, idle included.
    ranges = {e.key: {"count": int(e.count),
                      "device_span_ms": dev_total_us(e) / 1e3}
              for e in events
              if e.key in SPANS and e.device_type == cuda}
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": chip_smoke.card_line(),
        "layers": args.layers,
        "kv_dtype": args.kv_dtype,
        "speculative": tel.get("speculative"),
        "timed_run": {
            "wall_s": wall,
            "tokens_per_sec": tel["tokens_per_sec"],
            "ttft_p50_s": tel["time_to_first_token"]["p50"],
            "ttft_p99_s": tel["time_to_first_token"]["p99"],
            "decode_steps": tel["decode_steps"],
            "prefill_dispatches": tel["prefill_dispatches"],
            "prefill_s": tel["prefill"],
            "draft_s": tel.get("draft", 0.0),
            "decode_s": tel["decode"],
            "decode_ms_per_step": 1e3 * tel["decode"] / tel["decode_steps"],
            "draft_ms_per_round": 1e3 * tel.get("draft", 0.0)
            / tel["decode_steps"],
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
    print(f"{result['card']} | layers {args.layers} kv {args.kv_dtype} "
          f"speculative {result['speculative']}")
    print(f"timed run: {wall:.3f} s, {t['tokens_per_sec']:.1f} tokens/s; "
          f"prefill {t['prefill_s']:.3f} s over {t['prefill_dispatches']} "
          f"dispatches, draft chain {t['draft_s']:.3f} s "
          f"({t['draft_ms_per_round']:.2f} ms a round), decode/verify "
          f"{t['decode_s']:.3f} s over {t['decode_steps']} steps "
          f"({t['decode_ms_per_step']:.2f} ms/step), loop other "
          f"{other:.3f} s")
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
