"""CLI: gang-launch a training script on this machine.

    python -m distributed_tpu_torch.launch --num-workers 4 script.py [args...]

Spawns N workers, each with its own ``DTPU_CONFIG`` (the script calls
``distributed_tpu_torch.cluster.initialize()`` first), prints one result
row per worker (the reference's collect() shape) and exits nonzero if any
worker failed. Remote hosts over ssh and restarts are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import core


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m distributed_tpu_torch.launch",
                                 description=__doc__)
    ap.add_argument("--num-workers", type=int, default=1,
                    help="local processes to spawn (one per card, or a "
                         "gloo gang on the CPU)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before every worker still running is "
                         "killed")
    ap.add_argument("--base-port", type=int, default=None)
    ap.add_argument("--python", type=str, default=sys.executable)
    ap.add_argument("--results-json", type=str, default=None,
                    help="write the worker result rows to this file")
    ap.add_argument("script", type=str)
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    results = core.LocalLauncher().run(
        [args.python, args.script] + list(args.script_args),
        args.num_workers, timeout=args.timeout, base_port=args.base_port,
    )
    rows = [
        {
            "index": r.index,
            "ok": r.ok,
            "value": r.value,
            "error": r.error,
            "exit_code": r.exit_code,
        }
        for r in results
    ]
    for r in results:
        status = "ok" if r.ok else f"FAILED ({r.error})"
        print(f"worker {r.index}: {status}  value={r.value!r}")
        if not r.ok and r.log_tail:
            print("  --- log tail ---")
            for line in r.log_tail.splitlines()[-15:]:
                print(f"  {line}")
    if args.results_json:
        with open(args.results_json, "w") as f:
            json.dump(rows, f, indent=2)
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
