"""Gang launcher: run the same program on every worker, gather results.

A copy of the JAX package's ``launch/core.py`` (which imports no JAX),
pointed at the port and cut to its local half: ``LocalLauncher`` spawns N
processes on this machine, each with its own ``DTPU_CONFIG`` (the
TF_CONFIG descendant), gang semantics (one worker's crash kills the rest
after ``grace``; a deadline bounds every run), and results and errors come back through a per-worker JSON
file as one ``WorkerResult`` row per worker, errors included as data
(never a hang). A worker calls ``cluster.initialize()``, which forms the
``torch.distributed`` group from that spec. The SSH launcher, the
restart loop and the heartbeat-liveness probe are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..cluster import config as config_lib
from ..cluster import net

RESULT_ENV = "DTPU_RESULT_FILE"


@dataclasses.dataclass
class WorkerResult:
    """One row per worker, the shape of the reference's Spark collect().

    ``disposition`` records how the row ended: ``"exited"`` (the worker's
    own exit, code in ``exit_code``), ``"gang_killed"`` (killed because a
    peer failed) or ``"timeout"`` (the run's deadline expired)."""

    index: int
    ok: bool
    value: Optional[object] = None  # worker-reported result (report_result)
    error: Optional[str] = None  # exception text, tryCatch-style
    exit_code: Optional[int] = None
    log_tail: str = ""
    disposition: Optional[str] = None


def report_result(value):
    """Called by worker code to return a JSON-able value to the launcher
    (the Spark closure's return value in the reference), through the
    worker's result file; a no-op outside a gang."""
    path = os.environ.get(RESULT_ENV)
    if path:
        with open(path, "w") as f:
            json.dump({"value": value}, f)


def _read_result(path: Path):
    try:
        with open(path) as f:
            return json.load(f).get("value")
    except (OSError, json.JSONDecodeError):
        return None


def _tail(path: Path, max_bytes: int = 4096) -> str:
    try:
        data = path.read_bytes()
        return data[-max_bytes:].decode(errors="replace")
    except OSError:
        return ""


class LocalLauncher:
    """Spawn N worker processes on this machine (one per card of a host,
    or a gloo gang on the CPU). Gang semantics: all start together; on any
    worker's crash the rest are killed after ``grace`` rather than hanging
    at the next collective, and the failure surfaces as that worker's
    result row."""

    def __init__(self, env_extra: Optional[Dict[str, str]] = None):
        self.env_extra = dict(env_extra or {})

    def run(
        self,
        argv: Sequence[str],
        num_workers: int,
        *,
        timeout: float = 600.0,
        grace: float = 10.0,
        workdir: Optional[str] = None,
        base_port: Optional[int] = None,
    ) -> List[WorkerResult]:
        """Run ``argv`` as ``num_workers`` workers, each with its own
        ``DTPU_CONFIG`` (workers on 127.0.0.1, ports from ``base_port``
        or free ones); kill them all at ``timeout`` seconds."""
        if base_port is not None:
            ports = [base_port + i for i in range(num_workers)]
        else:
            ports = net.free_ports(num_workers)
        workers = [f"127.0.0.1:{p}" for p in ports]
        tmp = Path(tempfile.mkdtemp(prefix="dtpu_launch_"))
        procs = []
        for i in range(num_workers):
            spec = config_lib.ClusterSpec(workers=workers, index=i)
            env = dict(os.environ)
            env.update(self.env_extra)
            env[config_lib.ENV_VAR] = spec.to_json()
            env[RESULT_ENV] = str(tmp / f"result-{i}.json")
            log = open(tmp / f"worker-{i}.log", "wb")
            procs.append(
                (
                    subprocess.Popen(
                        list(argv),
                        env=env,
                        stdout=log,
                        stderr=subprocess.STDOUT,
                        cwd=workdir,
                    ),
                    log,
                )
            )
        deadline = time.time() + timeout
        results: List[Optional[WorkerResult]] = [None] * num_workers
        pending = set(range(num_workers))
        first_failure: Optional[float] = None

        def kill_and_record(i: int, reason: str, disposition: str):
            proc, _ = procs[i]
            proc.kill()
            proc.wait()
            pending.discard(i)
            results[i] = WorkerResult(
                index=i,
                ok=False,
                value=_read_result(tmp / f"result-{i}.json"),
                error=reason,
                exit_code=None,
                log_tail=_tail(tmp / f"worker-{i}.log"),
                disposition=disposition,
            )

        while pending:
            now = time.time()
            for i in list(pending):
                proc, _ = procs[i]
                rc = proc.poll()
                if rc is not None:
                    pending.discard(i)
                    log_path = tmp / f"worker-{i}.log"
                    value = _read_result(tmp / f"result-{i}.json")
                    err = None if rc == 0 else f"exit code {rc}"
                    results[i] = WorkerResult(
                        index=i,
                        ok=rc == 0,
                        value=value,
                        error=err,
                        exit_code=rc,
                        log_tail=_tail(log_path) if rc != 0 else "",
                        disposition="exited",
                    )
                    if rc != 0 and first_failure is None:
                        first_failure = now
            if pending and (
                now > deadline
                or (first_failure is not None and now > first_failure + grace)
            ):
                timed_out = now > deadline
                reason = (
                    "timeout"
                    if timed_out
                    else "killed after peer failure (gang semantics)"
                )
                for i in list(pending):
                    kill_and_record(
                        i, reason, "timeout" if timed_out else "gang_killed"
                    )
                pending.clear()
            time.sleep(0.05)
        for proc, log in procs:
            log.close()
        return [r for r in results if r is not None]


def launch_local(argv: Sequence[str], num_workers: int, **kw) -> List[WorkerResult]:
    return LocalLauncher().run(argv, num_workers, **kw)


__all__ = ["LocalLauncher", "WorkerResult", "launch_local", "report_result"]
