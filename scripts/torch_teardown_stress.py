#!/usr/bin/env python3
"""How often a rank of a 2-rank gloo gang aborts at exit, on the CPU.

    python3 scripts/torch_teardown_stress.py [--gangs 256] [--at-once 16]
        [--repo PATH] [--names]

Starts ``--gangs`` gangs of 2 processes through the port's
``launch.LocalLauncher``, ``--at-once`` of them at a time (more gangs
than cores load the host, which is what the abort needs). Each rank is
a script of its own (``WORKER``, written to a temporary directory), all
at module level as a user's is: it forms the gloo group
(``cluster.initialize(device="cpu")``), builds ``DataExpertParallel(
expert_parallel=2)`` and ``CompositeParallel({"data": 1, "model": 2})``,
runs one all-reduce on the expert line and on the composite's model
line and row group, calls ``cluster.shutdown()`` and exits, reporting
how many threads its process had before ``initialize`` and after
``shutdown`` (with ``--names``, also the names of those left but the
interpreter's own; reading them delays the exit, so a late worker may
finish first). A gloo worker thread still alive at exit may release a
collective's tensor while the interpreter finalizes and end the rank
with ``std::terminate`` (exit -6).

Prints the gangs that failed (with each failed rank's exit and the tail
of its log), the failed ranks by their error ("exit code -6" is the
abort; a rendezvous port another gang took first fails otherwise), and
the counts of (threads before, threads after, the named ones left) over
the ranks. ``--repo`` runs the ranks on another checkout of the package
(a parent commit, say).
"""

import argparse
import collections
import concurrent.futures
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# A rank: a script of its own, all at module level as a user's is, so its
# strategies and tensors live until the interpreter finalizes. torch
# names its threads: the gloo workers pt_gloo_runloop, gloo_tcp_loop,
# pt_tcpstore_uv.
WORKER = """
import os, sys

import torch
torch.set_num_threads(1)
T0 = len(os.listdir("/proc/self/task"))
import torch.distributed as dist
import distributed_tpu_torch as dtt

spec = dtt.cluster.initialize(device="cpu", timeout=60)
ep = dtt.DataExpertParallel(expert_parallel=2, device="cpu")
t = torch.ones(1); dist.all_reduce(t, group=ep.ep_group)
cp = dtt.CompositeParallel({"data": 1, "model": 2}, device="cpu")
t = torch.ones(1); dist.all_reduce(t, group=cp.tp_group)
t = torch.ones(1); dist.all_reduce(t, group=cp._rows)
dtt.cluster.shutdown()
tasks = os.listdir("/proc/self/task")
# Reading the names delays the exit enough for a late worker to finish.
named = (sorted(n for n in (open(f"/proc/self/task/{k}/comm").read().strip()
                            for k in tasks) if n != "python")
         if "--names" in sys.argv else [])
dtt.launch.report_result([T0, len(tasks), named])
"""


def gang(dtt, repo, script, names):
    rows = dtt.launch.LocalLauncher(env_extra={"PYTHONPATH": repo}).run(
        [sys.executable, script, *(["--names"] if names else [])], 2,
        timeout=120)
    return ([r.value for r in rows if r.ok],
            [(r.index, r.error, r.log_tail[-300:]) for r in rows
             if not r.ok])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gangs", type=int, default=256)
    ap.add_argument("--at-once", type=int, default=16)
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--names", action="store_true",
                    help="also name the threads left after shutdown()")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import distributed_tpu_torch as dtt

    script = os.path.join(tempfile.mkdtemp(), "rank.py")
    with open(script, "w") as f:
        f.write(WORKER)
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(args.at_once) as ex:
        runs = list(ex.map(lambda _: gang(dtt, repo, script, args.names),
                           range(args.gangs)))
    shutil.rmtree(os.path.dirname(script))
    threads = collections.Counter(
        f"{a}->{b} {' '.join(named)}".strip()
        for values, _ in runs for a, b, named in values)
    failed = [bad for _, bad in runs if bad]
    for bad in failed[:3]:
        print(f"failed gang: {bad}")
    print(json.dumps({
        "repo": repo, "gangs": args.gangs, "at_once": args.at_once,
        "cores": os.cpu_count(), "failed_gangs": len(failed),
        "failed_ranks": dict(collections.Counter(
            error for bad in failed for _, error, _ in bad)),
        "threads_before_after_named": dict(sorted(threads.items())),
        "seconds": round(time.perf_counter() - t, 1)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
