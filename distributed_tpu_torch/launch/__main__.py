"""CLI: gang-launch a training script.

    python -m distributed_tpu_torch.launch --num-workers 4 script.py [args...]
    python -m distributed_tpu_torch.launch --hosts host1,host2 script.py [args...]

Spawns N local workers (one per card, or a gloo gang on the CPU) or one
worker per ssh host, each with its own ``DTPU_CONFIG`` (the script calls
``distributed_tpu_torch.cluster.initialize()`` first); ``--max-restarts``
relaunches a failed gang (resume with ``ModelCheckpoint(restore=True)``)
and ``--liveness-timeout`` kills a worker whose heartbeat stalls. Prints
one result row per worker (the reference's collect() shape) and exits
nonzero if any worker failed.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import core

#: The JAX CLI's resilience flags (its ``resilience.Supervisor`` path).
_RESILIENCE_FLAGS = ("supervise", "checkpoint_dir", "elastic_min_workers",
                     "elastic_max_workers", "elastic_divisor",
                     "buddy_store_dir", "event_log")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m distributed_tpu_torch.launch",
                                 description=__doc__)
    ap.add_argument("--num-workers", type=int, default=None,
                    help="local processes to spawn (one per card, or a "
                         "gloo gang on the CPU)")
    ap.add_argument("--hosts", type=str, default=None,
                    help="comma-separated remote hosts (one worker per "
                         "host, via ssh)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before every worker still running is "
                         "killed")
    ap.add_argument("--base-port", type=int, default=None)
    ap.add_argument("--python", type=str, default=sys.executable)
    ap.add_argument("--results-json", type=str, default=None,
                    help="write the worker result rows to this file")
    ap.add_argument("--liveness-timeout", type=float, default=None,
                    help="kill a worker whose heartbeat (beaten each "
                         "dispatch by Model.fit) stalls for this many "
                         "seconds; arms per worker after its first beat, "
                         "so a slow start or kernel build never trips it")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="on worker failure, relaunch the whole gang up to "
                         "N times; pair with ModelCheckpoint(restore=True) "
                         "in the script so relaunches resume from the "
                         "latest checkpoint")
    ap.add_argument("--supervise", action="store_true",
                    help="not yet ported (ROADMAP 1.8, resilience/)")
    for flag in ("--checkpoint-dir", "--buddy-store-dir", "--event-log"):
        ap.add_argument(flag, type=str, default=None,
                        help="not yet ported (ROADMAP 1.8, resilience/)")
    for flag in ("--elastic-min-workers", "--elastic-max-workers",
                 "--elastic-divisor"):
        ap.add_argument(flag, type=int, default=None,
                        help="not yet ported (ROADMAP 1.8, resilience/)")
    ap.add_argument("script", type=str)
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    for name in _RESILIENCE_FLAGS:
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(
                f"--{name.replace('_', '-')}: not yet ported (ROADMAP 1.8, "
                "resilience/: the supervisor, its restart and elastic "
                "policies)")

    worker_argv = [args.python, args.script] + list(args.script_args)
    if args.hosts:
        kw = {"port": args.base_port} if args.base_port else {}
        launcher = core.SSHLauncher(args.hosts.split(","), **kw)
        results = core.run_with_restart(
            launcher, worker_argv, max_restarts=args.max_restarts,
            timeout=args.timeout, liveness_timeout=args.liveness_timeout)
    else:
        results = core.run_with_restart(
            core.LocalLauncher(), worker_argv, args.num_workers or 1,
            max_restarts=args.max_restarts, timeout=args.timeout,
            base_port=args.base_port,
            liveness_timeout=args.liveness_timeout)

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
