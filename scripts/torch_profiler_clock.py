#!/usr/bin/env python3
"""How a short ``torch.profiler`` capture keeps the card's kernels as
the process ages, on one card.

    python3 scripts/torch_profiler_clock.py [--ages 0,60,120,200]
                                            [--sessions 5] 2> kineto.log

At each age (seconds since the script started; the card is kept busy
with 4096 x 4096 f32 matmuls in between) it runs ``--sessions`` captures
back to back, each around a small probe (five 256 x 256 matmuls, a sum
and ``.item()``: 11 kernels) with CPU and CUDA activities, written
through the TensorBoard trace handler as ``utils.profiler.trace``
writes them. Per capture it prints the kernel events kept and Kineto's
own account from the trace's metadata (``KINETO_LOG_LEVEL=0``): the
device records dropped as outside the capture ("Out-of-range"), those
kept but stamped before their launch ("CPU GPU out-of-order"), and the
largest lead of a kernel's stamp over its launch's that Kineto warned
of. Then the card's name and power limit, and the rows as one JSON line.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("KINETO_LOG_LEVEL", "0")  # read when Kineto starts


def capture(torch, x):
    """(kernel events kept, Kineto's INFO/WARNING metadata lines) of one
    capture of the probe."""
    tmp = tempfile.mkdtemp(prefix="profiler-clock-")
    try:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(tmp)):
            y = x
            for _ in range(5):
                y = y @ x
            y.sum().item()
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            trace = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = sum(e.get("cat") == "kernel" for e in trace["traceEvents"])
    lines = [v for k, vs in trace.items() if k != "traceEvents"
             and isinstance(vs, list) for v in vs if isinstance(v, str)]
    return kernels, lines


def counts(lines):
    """Kineto's record counts and its largest kernel-before-launch lead
    (µs) in one capture's metadata."""
    text = "\n".join(lines)

    def first(pattern):
        m = re.search(pattern, text)
        return int(m.group(1)) if m else None

    leads = [int(v) for v in re.findall(
        r"GPU op timestamp \(\d+\) < runtime timestamp \(\d+\) by (\d+)us",
        text)]
    return {"out_of_range": first(r"Out-of-range = (\d+)"),
            "out_of_order": first(r"CPU GPU out-of-order = (\d+)"),
            "max_lead_us": max(leads) if leads else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ages", default="0,60,120,200")
    ap.add_argument("--sessions", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    x = torch.randn(256, 256, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    rows = []
    for age in (float(v) for v in args.ages.split(",")):
        while time.perf_counter() - t0 < age:
            for _ in range(50):
                a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize()
        for i in range(args.sessions):
            at = time.perf_counter() - t0
            kernels, lines = capture(torch, x)
            row = {"age_s": round(at, 1), "session": i, "kernels": kernels,
                   **counts(lines)}
            rows.append(row)
            print(f"  age {row['age_s']:7.1f} s, capture {i}: {kernels} of 11 "
                  f"kernels kept; out of range {row['out_of_range']}, kept "
                  f"before their launch {row['out_of_order']}, largest lead "
                  f"{row['max_lead_us']} us", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: none")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
