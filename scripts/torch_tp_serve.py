#!/usr/bin/env python3
"""The serving Engine under tensor parallelism across the cards of one host.

    python3 scripts/torch_tp_serve.py [--model-parallel 1 2 4]
        [--timeout 900]

For each model-parallel size m, starts m processes with the port's
``launch.LocalLauncher`` (one per card, each forming the NCCL group with
``cluster.initialize()``). Every rank builds chip_smoke.py's phase-c LM
(GPT-2-small at full width: vocab 32,768, 12 blocks, d 768, 12 heads,
max_len 1,024, bf16 layers, random weights from seed 0) under
``DataTensorParallel(model_parallel=m)`` (data 1), so it holds its
Megatron blocks of every attention and MLP product and its 12/m heads of
each pool, and serves phase c's 16 greedy requests (prompts of 32-512
tokens, 64-128 new) through ``Engine(max_slots=8, block_size=16,
max_len=1024, decode_kernel="fused")`` after a warm-up run. TF32 off.

Each size reports, from its ranks: the tokens (every rank of the line
must return the same), tokens/s and TTFT p50/p99 (the engine's
telemetry, rank 0), the host ms a decode step (the engine's decode span
over its steps), the served parameter and pool bytes a card and their
ratio to one card's, the hinted leaves served whole (none), and K1's
launches (once a layer and decode step). Then each size's tokens against
the one-card engine's: the share of generated tokens that agree, and
for every request that parts, where it first does and whether the two
tokens were a bf16 rounding tie there: their f32 logits from one
forward of the common prefix through the one-card model on card 0,
within chip_smoke.py's bf16 tolerance of the logit (the partial sums of
a split product round in another order, so a near tie may flip; any
other difference fails the run).

Prints a summary and writes the numbers to ``chiprun_out/tp_serve.json``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def worker(m):
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import paged_attention as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = dtt.cluster.initialize(timeout=300)
    model = chip_smoke.tp_lm(dtt, dtt.DataTensorParallel(model_parallel=m))
    reqs = chip_smoke.requests(16, (32, 512), (64, 128))
    chip_smoke.serve(dtt, model, chip_smoke.requests(2, (8, 16), (4, 4),
                                                     seed=1),
                     decode_kernel="fused")  # warm-up
    toks, _, tel, wall, launches, pair, served = chip_smoke.tp_serve_arm(
        torch, dtt, paged_ops, model, reqs)
    params_b, pool_b, whole = served
    dtt.launch.report_result({
        "rank": spec.index, "device": torch.cuda.get_device_name(),
        "tokens": [t.tolist() for t in toks], "wall_s": wall,
        "tokens_per_s": tel["tokens_per_sec"],
        "ttft_p50_ms": 1e3 * tel["time_to_first_token"]["p50"],
        "ttft_p99_ms": 1e3 * tel["time_to_first_token"]["p99"],
        "decode_steps": tel["decode_steps"],
        "host_ms_per_decode_step": 1e3 * tel["decode"] / tel["decode_steps"],
        "params_bytes": params_b, "pool_bytes": pool_b,
        "whole_hinted": whole, "launches": launches, "pair": pair})
    dtt.cluster.shutdown()


def ties(torch, dtt, chip_smoke, reqs, one, other):
    """For every request whose tokens part from the one-card run's: (its
    index, the first parting position, the f32 logit gap of the two
    tokens there, whether it is within bf16's tolerance of the logit)."""
    model = chip_smoke.tp_lm(dtt, dtt.DataParallel())
    out = []
    for i, (a, b) in enumerate(zip(one, other)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        pos = int(np.nonzero(a != b)[0][0])
        prefix = torch.from_numpy(a[None, :pos].astype(np.int64)).cuda()
        with torch.inference_mode():
            logits = model.module(prefix)[0, -1].float()
        x, y = float(logits[int(a[pos])]), float(logits[int(b[pos])])
        gap = abs(x - y)
        out.append([i, pos, gap, gap <= chip_smoke.TOL["bfloat16"]
                    * max(1.0, abs(x))])
    del model
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-parallel", type=int, nargs="+",
                    default=[1, 2, 4])
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "tp_serve.json"))
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    import torch

    import chip_smoke
    import distributed_tpu_torch as dtt

    if not torch.cuda.is_available():
        print("needs NVIDIA cards", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), f"x {torch.cuda.device_count()}")
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    out, failed = {}, False
    for m in args.model_parallel:
        t = time.perf_counter()
        rows = dtt.launch.LocalLauncher(env_extra=env).run(
            [sys.executable, os.path.abspath(__file__), "--worker", str(m)],
            m, timeout=args.timeout)
        bad = [r for r in rows if not r.ok]
        for r in bad:
            print(f"m={m} worker {r.index} FAILED ({r.error})\n{r.log_tail}")
        if bad:
            failed = True
            continue
        vals = [r.value for r in rows]
        head = vals[0]
        agree = all(v["tokens"] == head["tokens"] for v in vals)
        whole = sorted({p for v in vals for p in v["whole_hinted"]})
        out[m] = dict(head, ranks_agree=agree, whole_hinted=whole,
                      params_bytes=max(v["params_bytes"] for v in vals),
                      pool_bytes=max(v["pool_bytes"] for v in vals),
                      seconds=time.perf_counter() - t)
        want_k1 = head["decode_steps"] * chip_smoke.LM["num_layers"]
        print(f"m={m}: {head['tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{head['ttft_p50_ms']:.1f} ms p99 {head['ttft_p99_ms']:.1f} "
              f"ms, host {head['host_ms_per_decode_step']:.3f} ms a decode "
              f"step, parameters {out[m]['params_bytes'] / 1e6:.1f} MB and "
              f"pools {out[m]['pool_bytes'] / 1e6:.1f} MB a card; ranks "
              f"agree {agree}; hinted leaves whole {whole}; launches "
              f"{head['launches']} (K1 want {want_k1}); Megatron pair "
              f"{head['pair']}; devices {[v['device'] for v in vals]}")
        failed |= (not agree or bool(whole)
                   or head["launches"].get("paged_attention") != want_k1)
    if 1 in out:
        one = out[1]
        reqs = chip_smoke.requests(16, (32, 512), (64, 128))
        for m, row in out.items():
            if m == 1:
                continue
            share, _ = chip_smoke.agreement(
                [np.asarray(t) for t in row["tokens"]],
                [np.asarray(t) for t in one["tokens"]], reqs)
            row["agreement"] = share
            row["ties"] = ties(torch, dtt, chip_smoke, reqs, one["tokens"],
                               row["tokens"])
            row["params_ratio"] = row["params_bytes"] / one["params_bytes"]
            row["pool_ratio"] = row["pool_bytes"] / one["pool_bytes"]
            row["tokens_per_s_ratio"] = (row["tokens_per_s"]
                                         / one["tokens_per_s"])
            print(f"m={m} against one card: token agreement {share:.4f}, "
                  f"parting requests [index, position, logit gap, bf16 "
                  f"tie] {row['ties']}; parameters {row['params_ratio']:.4f}"
                  f"x, pools {row['pool_ratio']:.4f}x, tokens/s "
                  f"{row['tokens_per_s_ratio']:.4f}x")
            failed |= not all(t[3] for t in row["ties"])
    for row in out.values():
        row.pop("tokens")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(chip_smoke.card_line(), f"x {torch.cuda.device_count()}")
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
