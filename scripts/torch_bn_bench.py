#!/usr/bin/env python3
"""BatchNorm's reductions (K13/K14) at ResNet-50's shapes, on one card.

    python3 scripts/torch_bn_bench.py [--package-root DIR] [--label NAME]
                                      [--out PATH]

Times ``bn_stats`` (K13) and ``bn_bwd_reduce`` (K14) of the
``distributed_tpu_torch`` found under ``--package-root`` (default: this
checkout; another checkout's, such as an unpacked parent commit, to
compare two versions in one run) at the 12 BatchNorm shapes of ResNet-50
at batch 256 and 224x224 in bf16, as ``chip_smoke.py``'s phase m does:

- device time per call: 10 launches, each after a 128 MB write that
  evicts the L2 and timed between its own CUDA events, with the host
  queueing every call before the first starts (``ahead``), so the events
  time the device; and the same after a 128 MB read instead (``clean``),
  whose L2 lines need no write-back while the call runs;
- host cost per call: the enqueue clock (50 calls back to back, read
  before the closing synchronize);
- the clock's floor: one launch of the probe kernel K15, timed alike;
- launches per call (the wrapper's count over one call), the bytes bound
  (each input read once, the (2, C) f32 output written once, at 3.35
  TB/s) and ``torch.batch_norm_stats`` / ``batch_norm_backward_reduce``
  on an NCHW view of the same rows (timed only).

Prints one line per shape, the per-step totals (each shape times its
count of BatchNorms), the card's name and power limit, and the numbers as
one JSON line (``--out`` also writes them there).
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py (its timers), whatever package root
    is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=ROOT,
                    help="directory holding the distributed_tpu_torch to time")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.package_root))
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import bn_reduce as bn_ops

    print(f"{args.label}: {dtt.__file__}")
    dev = torch.device("cuda")
    _, bns = cs.resnet50_shapes(torch, dtt)
    g = torch.Generator(device=dev).manual_seed(19)
    rows, totals = [], {}
    for (m, c), count in sorted(bns.items()):
        x = (torch.randn((m, c), generator=g, device=dev) * 2 + 1).bfloat16()
        dy = torch.randn((m, c), generator=g, device=dev).bfloat16()
        shift = torch.randn((c,), generator=g, device=dev) * 0.5
        mean = torch.randn((c,), generator=g, device=dev) * 0.5
        inv = torch.rand((c,), generator=g, device=dev) + 0.5
        x4, dy4 = x.view(m, c, 1, 1), dy.view(m, c, 1, 1)
        weight = torch.ones((c,), device=dev)
        calls = {
            "bn_stats": (lambda: bn_ops.bn_stats(x, shift),
                         lambda: torch.batch_norm_stats(x4, 1e-5),
                         m * c * 2 + 12 * c, 4 * m * c),
            "bn_bwd_reduce": (lambda: bn_ops.bn_bwd_reduce(dy, x, mean, inv),
                              lambda: torch.batch_norm_backward_reduce(
                                  dy4, x4, mean, inv, weight, True, True, True),
                              2 * m * c * 2 + 16 * c, 5 * m * c),
        }
        for name, (kernel, library, nbytes, flops) in calls.items():
            before = bn_ops.launches[name]
            kernel()
            per_call = bn_ops.launches[name] - before
            ms = cs.cuda_ms_flushed(torch, lambda i: kernel(), 10, ahead=True)
            ms_clean = cs.cuda_ms_flushed(torch, lambda i: kernel(), 10,
                                          ahead=True, clean=True)
            host_us = 1e6 * cs.enqueue_s(torch, kernel)
            lib_ms = cs.library_ms_or_none(torch, lambda i: library(), 10, name)
            b_ms, _ = cs.bound_ms(nbytes, flops, "float32")
            row = dict(name=name, m=m, c=c, count=count, ms=ms,
                       ms_clean=ms_clean, host_us=host_us, launches_per_call=per_call,
                       bound_ms=b_ms, library_ms=lib_ms)
            rows.append(row)
            t = totals.setdefault(name, dict(ms=0.0, ms_clean=0.0, host_ms=0.0,
                                             bound_ms=0.0, library_ms=0.0,
                                             launches=0))
            t["ms"] += count * ms
            t["ms_clean"] += count * ms_clean
            t["host_ms"] += count * host_us / 1e3
            t["bound_ms"] += count * b_ms
            t["library_ms"] = (None if lib_ms is None or t["library_ms"] is None
                               else t["library_ms"] + count * lib_ms)
            t["launches"] += count * per_call
            lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f}"
            print(f"  {name:13s} ({m:>7}, {c:>4}) x{count:<2}: {ms * 1e3:7.1f} "
                  f"us device ({ms_clean * 1e3:.1f} after a clean flush), "
                  f"{host_us:6.1f} us host, {per_call} launch(es), "
                  f"bound {b_ms * 1e3:6.1f} us ({b_ms / ms:.1%}), library {lib}")
        del x, dy, x4, dy4
        torch.cuda.empty_cache()
    # The clock's floor: one launch of the probe kernel K15 on an (8, 128)
    # tile, timed the same way.
    from distributed_tpu_torch.ops import launch_probe as probe_ops

    tile = torch.zeros(probe_ops.SHAPE, device=dev)
    floor_ms = cs.cuda_ms_flushed(
        torch, lambda i: probe_ops.launch_probe(tile), 10, ahead=True)
    print(f"  floor: one launch of K15 on an (8, 128) tile {floor_ms * 1e3:.1f} "
          "us on the same clock")
    for name, t in totals.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        print(f"  {name:13s} per step (53 calls): {t['ms']:.3f} ms device "
              f"({t['ms_clean']:.3f} after a clean flush), "
              f"{t['host_ms']:.3f} ms host, {t['launches']} launches, bound "
              f"{t['bound_ms']:.3f} ms ({t['bound_ms'] / t['ms']:.1%}), "
              f"library {lib}")
    card = cs.card_line()
    print(card)
    result = {"label": args.label, "card": card, "floor_ms": floor_ms,
              "shapes": rows, "per_step": totals}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
