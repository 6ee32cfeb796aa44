"""CLI: gang-launch a training script.

    python -m distributed_tpu_torch.launch --num-workers 4 script.py [args...]
    python -m distributed_tpu_torch.launch --hosts host1,host2 script.py [args...]

Spawns N local workers (one per card, or a gloo gang on the CPU) or one
worker per ssh host, each with its own ``DTPU_CONFIG`` (the script calls
``distributed_tpu_torch.cluster.initialize()`` first); ``--max-restarts``
relaunches a failed gang (resume with ``ModelCheckpoint(restore=True)``)
and ``--liveness-timeout`` kills a worker whose heartbeat stalls.
``--supervise`` runs the gang under ``resilience.Supervisor`` instead:
backoff and a restart budget (``--max-restarts``, default 3), preemptions
restarted for free, elastic re-formation (``--elastic-min-workers``,
``--elastic-max-workers``, ``--elastic-divisor``), the buddy tier's RAM
store (``--buddy-store-dir``) and an event log (``--event-log``; read it
with ``python -m distributed_tpu_torch.obs.cli``). Prints one result row
per worker (the reference's collect() shape) and exits nonzero if any
worker failed.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import core


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
                    help="run under resilience.Supervisor: restart policy "
                         "with backoff + budget (--max-restarts, default "
                         "3), budget-free preemption restarts, structured "
                         "event log")
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="(with --supervise) the workers' checkpoint dir: "
                         "the supervisor reports the resume step and clears "
                         "the resume marker when the run completes")
    ap.add_argument("--elastic-min-workers", type=int, default=None,
                    help="(with --supervise) enable elastic gangs: on "
                         "permanent worker loss re-form the gang at a "
                         "smaller world size (>= this) instead of a "
                         "fixed-size relaunch")
    ap.add_argument("--elastic-max-workers", type=int, default=None,
                    help="(with --elastic-min-workers) ceiling for "
                         "grow-back; default: the launch size")
    ap.add_argument("--elastic-divisor", type=int, default=None,
                    help="(with --elastic-min-workers) snap every resized "
                         "world size down to a divisor of this; set it to "
                         "the global batch size so resizes keep exact "
                         "batch math")
    ap.add_argument("--buddy-store-dir", type=str, default=None,
                    help="(with --supervise) RAM-backed buddy-redundancy "
                         "store dir (tmpfs, e.g. under /dev/shm): exported "
                         "to workers as DTPU_BUDDY_STORE so "
                         "ModelCheckpoint(buddy=True) arms the diskless "
                         "recovery tier; the supervisor invalidates failed "
                         "ranks' segments before each relaunch")
    ap.add_argument("--event-log", type=str, default=None,
                    help="(with --supervise) JSONL event log path; also "
                         "exported to workers as DTPU_EVENT_LOG")
    ap.add_argument("script", type=str)
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    worker_argv = [args.python, args.script] + list(args.script_args)
    if args.hosts:
        kw = {"port": args.base_port} if args.base_port else {}
        launcher = core.SSHLauncher(args.hosts.split(","), **kw)
        n = len(launcher.hosts)
        run_kw = {"timeout": args.timeout,
                  "liveness_timeout": args.liveness_timeout}
    else:
        launcher = core.LocalLauncher()
        n = args.num_workers or 1
        run_kw = {"timeout": args.timeout, "base_port": args.base_port,
                  "liveness_timeout": args.liveness_timeout}

    if args.supervise:
        from ..resilience import ElasticPolicy, RestartPolicy, Supervisor
        from ..utils.events import EventLog

        elastic = None
        if args.elastic_min_workers is not None:
            elastic = ElasticPolicy(
                min_workers=args.elastic_min_workers,
                max_workers=args.elastic_max_workers,
                divisor_of=args.elastic_divisor,
            )
        sup = Supervisor(
            worker_argv, n, launcher=launcher,
            policy=RestartPolicy(max_restarts=args.max_restarts or 3),
            elastic=elastic,
            checkpoint_dir=args.checkpoint_dir,
            buddy_store_dir=args.buddy_store_dir,
            event_log=EventLog(args.event_log) if args.event_log else None,
            liveness_timeout=args.liveness_timeout,
        )
        base_port = run_kw.pop("base_port", None)
        run_kw.pop("liveness_timeout", None)  # the Supervisor injects it
        if base_port is not None:
            run_kw["base_port"] = base_port
        sup_result = sup.run(**run_kw)
        results = sup_result.results
        print(f"supervisor: attempts={sup_result.attempts} "
              f"restarts={sup_result.restarts_used} "
              f"preemptions={sup_result.preemptions}"
              + (f" resizes={sup_result.resizes} "
                 f"world_size={sup_result.world_size}"
                 if elastic is not None else ""))
    elif args.hosts:
        results = core.run_with_restart(
            launcher, worker_argv, max_restarts=args.max_restarts, **run_kw)
    else:
        results = core.run_with_restart(
            launcher, worker_argv, n, max_restarts=args.max_restarts,
            **run_kw)

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
