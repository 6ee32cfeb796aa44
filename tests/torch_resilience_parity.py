"""Drive the JAX package's and the port's ``Supervisor`` through the same
scripted launcher and compare what they did.

A scenario is a dict:

- ``script``: one entry per attempt, ``"raise"`` (the launch raises) or
  a callable ``(rows, world) -> [WorkerResult]`` built with ``rows`` (the
  package's row makers below);
- ``n`` (default 1), ``policy`` (``RestartPolicy`` keywords), ``elastic``
  (``ElasticPolicy`` keywords; ``probe`` a list of capacities read in
  turn), ``hosts`` (a host-list launcher instead of a sized one),
  ``buddy`` (a store with a segment per rank), ``marker`` (a resume
  marker at that step in a checkpoint dir), ``worker_events`` (records
  the fake workers append to the event log on every attempt).

:func:`run_both` returns each package's record: the result's fields and
rows, the backoff sleeps, the launched worlds or host lists, the worker
environment and the event stream (less the transport's ``ts``/``pid``,
the attempt's wall ``duration`` and the recovery rows' seconds, which are
clock readings).
"""

import json
import time
import types
from pathlib import Path


def _package(name):
    if name == "jax":
        from distributed_tpu import resilience as res
        from distributed_tpu.launch import WorkerResult
        from distributed_tpu.utils.events import EventLog
    else:
        from distributed_tpu_torch import resilience as res
        from distributed_tpu_torch.launch import WorkerResult
        from distributed_tpu_torch.utils.events import EventLog
    return res, WorkerResult, EventLog


def row_makers(WorkerResult, preempt_code=75):
    def ok(i=0):
        return WorkerResult(index=i, ok=True, value="fine", exit_code=0,
                            disposition="exited")

    def fail(i=0, code=17, disposition="exited", error=None):
        return WorkerResult(index=i, ok=False,
                            error=error or f"exit code {code}",
                            exit_code=code, disposition=disposition)

    def legacy_fail(i=0, code=1):
        return WorkerResult(index=i, ok=False, error=f"exit code {code}",
                            exit_code=code)

    def pre(i=0):
        return WorkerResult(index=i, ok=False,
                            error=f"exit code {preempt_code}",
                            exit_code=preempt_code)

    def collateral(i=0, error="killed after peer failure (gang semantics)",
                   disposition="gang_killed"):
        return WorkerResult(index=i, ok=False, error=error, exit_code=None,
                            disposition=disposition)

    def gang_fail(world, initiator):
        return [fail(i) if i == initiator else collateral(i)
                for i in range(world)]

    def gang_ok(world):
        return [ok(i) for i in range(world)]

    return types.SimpleNamespace(ok=ok, fail=fail, legacy_fail=legacy_fail,
                                 pre=pre, collateral=collateral,
                                 gang_fail=gang_fail, gang_ok=gang_ok)


class _Sized:
    """A LocalLauncher-shaped fake: ``env_extra`` and a world argument."""

    def __init__(self, script, rows, worker_events):
        self.script = list(script)
        self.rows = rows
        self.worker_events = worker_events
        self.env_extra = {}
        self.seen = []
        self.seen_env = []

    def run(self, argv, num_workers, **kw):
        self.seen.append(num_workers)
        self.seen_env.append(dict(self.env_extra))
        _append(self.env_extra, self.worker_events)
        out = self.script.pop(0)
        if out == "raise":
            raise RuntimeError("preflight failed for relaunch")
        return out(self.rows, num_workers)


class _Hosts:
    """An SSHLauncher-shaped fake: a host list, env as a run keyword."""

    def __init__(self, hosts, script, rows, worker_events):
        self.hosts = list(hosts)
        self.script = list(script)
        self.rows = rows
        self.worker_events = worker_events
        self.seen = []
        self.seen_env = []

    def run(self, argv, *, env_extra=None, **kw):
        self.seen.append(list(self.hosts))
        self.seen_env.append(dict(env_extra or {}))
        _append(env_extra or {}, self.worker_events)
        out = self.script.pop(0)
        if out == "raise":
            raise RuntimeError("preflight failed for relaunch")
        return out(self.rows, len(self.hosts))


def _append(env, records):
    """The fake workers' events, appended to the supervisor's log."""
    path = env.get("DTPU_EVENT_LOG")
    if not path or not records:
        return
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps({"ts": time.time(), "pid": 0, **rec}) + "\n")


def _normal_event(e):
    out = {k: v for k, v in e.items() if k not in ("ts", "pid", "duration")}
    if e["event"] == "recovery":
        out = {k: v for k, v in out.items() if not k.endswith("_s")}
    return out


def run_one(name, sc, tmp: Path):
    res, WorkerResult, EventLog = _package(name)
    tmp.mkdir(parents=True, exist_ok=True)
    rows = row_makers(WorkerResult, res.PREEMPTED_EXIT_CODE)
    events_path = tmp / "ev.jsonl"
    log = EventLog(events_path)
    worker_events = sc.get("worker_events")
    if sc.get("hosts"):
        launcher = _Hosts(sc["hosts"], sc["script"], rows, worker_events)
    else:
        launcher = _Sized(sc["script"], rows, worker_events)
    kw = {}
    store = tmp / "store"
    if sc.get("buddy"):
        for r in range(sc.get("n", 1)):
            (store / f"rank-{r}" / "self").mkdir(parents=True, exist_ok=True)
        kw["buddy_store_dir"] = store
    ckpt = tmp / "ckpt"
    if sc.get("marker") is not None:
        res.write_resume_marker(ckpt, sc["marker"])
        kw["checkpoint_dir"] = ckpt
    if sc.get("elastic") is not None:
        el = dict(sc["elastic"])
        if "probe" in el:
            el["probe"] = iter(el["probe"]).__next__
        kw["elastic"] = res.ElasticPolicy(**el)
    sleeps = []
    sup = res.Supervisor(
        ["prog"], sc.get("n", 1), launcher=launcher,
        policy=res.RestartPolicy(**sc.get("policy", {})),
        event_log=log, sleep=sleeps.append,
        straggler_threshold=sc.get("straggler_threshold"), **kw)
    out = sup.run(timeout=5)
    subst = {str(events_path): "<log>", str(store): "<store>"}
    return {
        "result": (out.ok, out.attempts, out.restarts_used, out.preemptions,
                   out.resizes, out.world_size, out.event_log is not None),
        "rows": [(r.index, r.ok, r.value, r.error, r.exit_code,
                  r.disposition) for r in out.results],
        "sleeps": sleeps,
        "seen": launcher.seen,
        "hosts_after": getattr(launcher, "hosts", None),
        "env": [{k: subst.get(v, v) for k, v in env.items()}
                for env in launcher.seen_env],
        "events": [_normal_event(e) for e in log.read()],
        "marker_left": (ckpt / "resume-marker.json").exists(),
        "segments_left": sorted(p.name for p in store.glob("rank-*")),
    }


def run_both(sc_factory, tmp: Path):
    """``(jax record, port record)``; ``sc_factory()`` builds a fresh
    scenario for each run (scripts are consumed)."""
    return (run_one("jax", sc_factory(), tmp / "jax"),
            run_one("port", sc_factory(), tmp / "port"))
