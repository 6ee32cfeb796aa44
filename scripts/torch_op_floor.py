#!/usr/bin/env python3
"""The per-launch floor of the PyTorch port on one NVIDIA card.

    python3 scripts/torch_op_floor.py [--out PATH]

The port of the JAX package's ``examples/profile_op_floor.py``: the same
five sections, each timed by its differential two-run-length method (10
and 60 calls, each run ending in a synchronize; the difference over 50
calls cancels the fixed cost of a run), on the card:

a. N independent tiny (256,) mul-adds (``x * 1.0001 + 0.1``) for N = 1,
   40, 160: PyTorch runs each as its own kernels, so this is the eager
   launch cost per op;
b. one SGD-with-momentum update over 25.6M f32 entries (``m = 0.9 m + g;
   p = p - 0.1 m``, in place): bytes per second of a large elementwise
   pass;
c. ``torch.cat`` of 25.6M f32 entries from 8 and from 161 parts;
d. one launch of the port's probe kernel K15 (``ops.launch_probe``, ``x *
   1.0001`` on an (8, 128) f32 tile), beside the same multiply as one
   torch op;
e. a loop of 161 tiny mul-adds over the rows of a (161, 256) buffer, the
   eager counterpart of the JAX package's ``lax.scan``.

Prints one line per measurement, the card's name and power limit, and
the numbers as one JSON line (``--out`` also writes them there).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (card_line, differential_s)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from distributed_tpu_torch.ops import launch_probe as probe_ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def timed(name, fn, **extra):
        s = chip_smoke.differential_s(torch, fn)
        rows[name] = dict(ms=1e3 * s, **extra)
        return s

    # (a) N independent tiny mul-adds
    for n in (1, 40, 160):
        xs = [torch.randn((256,), generator=g, device=dev) for _ in range(n)]
        t = timed(f"a_tiny_muladds_{n}",
                  lambda xs=xs: [x * 1.0001 + 0.1 for x in xs], ops=n)
        print(f"{n:4d} tiny (256,) mul-adds       {t * 1e3:8.3f} ms "
              f"({t / n * 1e6:7.1f} us/op)", flush=True)

    # (b) one big elementwise SGD+momentum update, in place
    n = 25_600_000
    p = torch.randn((n,), generator=g, device=dev)
    m = torch.zeros_like(p)
    grad = torch.randn((n,), generator=g, device=dev) * 0.01

    def sgdm():
        m.mul_(0.9).add_(grad)
        p.sub_(0.1 * m)

    t = timed("b_sgd_momentum_25.6M", sgdm)
    gbps = 5 * n * 4 / t / 1e9  # p, m, g read; p, m written
    rows["b_sgd_momentum_25.6M"]["GB_per_s"] = gbps
    print(f"one 25.6M-elem SGD+momentum    {t * 1e3:8.3f} ms ({gbps:6.1f} GB/s)",
          flush=True)
    del p, m, grad

    # (c) N-operand concatenation of 25.6M entries
    for parts_n in (8, 161):
        parts = [torch.randn((n // parts_n,), generator=g, device=dev)
                 for _ in range(parts_n)]
        t = timed(f"c_concat_{parts_n}", lambda parts=parts: torch.cat(parts))
        gbps = 2 * n * 4 / t / 1e9
        rows[f"c_concat_{parts_n}"]["GB_per_s"] = gbps
        print(f"concat {parts_n:4d} x {n // parts_n / 1e3:7.0f}K        "
              f"{t * 1e3:8.3f} ms ({gbps:6.1f} GB/s)", flush=True)
        del parts

    # (d) the probe kernel (K15) and the same multiply as one torch op
    x = torch.randn(probe_ops.SHAPE, generator=g, device=dev)
    t = timed("d_launch_probe", lambda: probe_ops.launch_probe(x))
    t_op = timed("d_torch_mul", lambda: x * 1.0001)
    print(f"one launch_probe kernel (K15)  {t * 1e3:8.3f} ms; x * 1.0001 as "
          f"one torch op {t_op * 1e3:.3f} ms", flush=True)

    # (e) a loop of 161 tiny iterations over a (161, 256) buffer
    xs = torch.randn((161, 256), generator=g, device=dev)
    ys = torch.empty_like(xs)

    def loop():
        for i in range(xs.shape[0]):
            torch.add(xs[i] * 1.0001, 0.1, out=ys[i])

    t = timed("e_loop_161", loop)
    print(f"loop of 161 tiny iterations    {t * 1e3:8.3f} ms", flush=True)

    card = chip_smoke.card_line()
    print(card)
    result = {"device": torch.cuda.get_device_name(0), "card": card,
              "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
