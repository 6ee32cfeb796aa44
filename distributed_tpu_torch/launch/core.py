"""Gang launcher: run the same program on every worker, gather results.

A copy of the JAX package's ``launch/core.py`` (which imports no JAX),
pointed at the port. ``LocalLauncher`` spawns N processes on this machine
(one per card of a host, or a gloo gang on the CPU) and ``SSHLauncher``
one per remote host; each worker gets its own ``DTPU_CONFIG`` (the
TF_CONFIG descendant) and calls ``cluster.initialize()``, which forms the
``torch.distributed`` group from it. Gang semantics: one worker's failure
kills the rest after ``grace`` (SIGKILL: a survivor blocked in an NCCL
collective waits for no watchdog), a deadline bounds every run, and a
worker whose heartbeat (``heartbeat()``, beaten by ``Model.fit``) stops
for ``liveness_timeout`` seconds is killed as hung. Results and errors
come back as one ``WorkerResult`` row per worker, errors included as
data (never a hang); ``run_with_restart`` relaunches a failed gang, which
resumes from its ``ModelCheckpoint(restore=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..cluster import config as config_lib
from ..cluster import net
from ..utils import logging as dlog

RESULT_ENV = "DTPU_RESULT_FILE"
RESULT_STDOUT_ENV = "DTPU_RESULT_STDOUT"  # ssh mode: frame result on stdout
STDOUT_MARK = "___DTPU_RESULT___"
HEARTBEAT_ENV = "DTPU_HEARTBEAT_FILE"  # local mode: touch this file
HEARTBEAT_STDOUT_ENV = "DTPU_HEARTBEAT_STDOUT"  # ssh mode: tick on stdout
HEARTBEAT_MARK = "___DTPU_HB___"
PID_MARK = "___DTPU_PID___"  # ssh mode: remote worker announces its pid

_last_heartbeat = 0.0


def heartbeat(min_interval: float = 0.5) -> None:
    """Publish worker liveness to the launcher (no-op outside a gang).

    The training loop calls this every dispatch (training/model.py; a
    K-step CUDA-graph dispatch beats once), so a worker that is
    *computing* keeps beating while one stuck at a collective,
    deadlocked, or SIGSTOPped goes silent — the launcher's
    ``liveness_timeout`` then treats it like a crashed peer (gang-kill +
    restart) instead of burning the full run ``timeout`` (the reference's
    "restart if any fails", extended to hung-but-alive workers). Custom
    loops can call it directly.

    Transport matches the launcher: an mtime touch on ``$DTPU_HEARTBEAT_FILE``
    for local gangs, a marker line on stdout for ssh workers. Throttled to
    one beat per ``min_interval`` seconds so a fast step loop costs nothing.
    """
    global _last_heartbeat
    now = time.monotonic()
    if now - _last_heartbeat < min_interval:
        return
    path = os.environ.get(HEARTBEAT_ENV)
    tick_stdout = os.environ.get(HEARTBEAT_STDOUT_ENV) == "1"
    if not path and not tick_stdout:
        return
    _last_heartbeat = now
    if path:
        try:
            with open(path, "a"):
                pass
            os.utime(path, None)
        except OSError:
            pass
    if tick_stdout:
        print(HEARTBEAT_MARK, flush=True)


@dataclasses.dataclass
class WorkerResult:
    """One row per worker — the shape of the reference's Spark collect().

    ``disposition`` records HOW the row ended, structurally — the launcher
    knows whether it killed the worker and why, and downstream policy
    (the supervisor's preemption/failure classification, the elastic
    ledger's per-rank attribution) must not re-derive that from error
    strings. Values: ``"exited"`` (the worker's own exit, code in
    ``exit_code``), ``"gang_killed"`` (killed because a PEER failed —
    collateral, never an independent fault), ``"liveness_killed"``
    (heartbeat went silent: hung, an initiated fault), ``"timeout"``
    (the whole run deadline expired — unattributable), ``"launch_error"``
    (the gang never started). ``None`` on rows from launchers predating
    the field; consumers then fall back to exit_code/error heuristics.
    """

    index: int
    ok: bool
    value: Optional[object] = None  # worker-reported result (report_result)
    error: Optional[str] = None  # exception text, tryCatch-style
    exit_code: Optional[int] = None
    log_tail: str = ""
    disposition: Optional[str] = None


def report_result(value):
    """Called by worker code to return a JSON-able value to the launcher
    (the Spark closure's return value in the reference).

    Transport depends on how the worker was launched: a result file for
    local gangs, stdout framing for ssh workers."""
    path = os.environ.get(RESULT_ENV)
    if path:
        with open(path, "w") as f:
            json.dump({"value": value}, f)
    elif os.environ.get(RESULT_STDOUT_ENV) == "1":
        print(STDOUT_MARK + json.dumps(value), flush=True)


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


# What a gloo collective raises in a worker whose peer died (or whose peer
# exited after one did): on the CPU a survivor's collective fails at once
# instead of blocking (as NCCL's does) until the gang kill. Gloo's errors
# name the source of its TCP transport, so no other backend's text can
# match.
_GLOO_TRANSPORT = "gloo/transport/"
_PEER_LOST = ("Connection closed by peer", "Connection reset by peer",
              "Broken pipe")


def _gloo_lost_peer(log_tail: str) -> bool:
    """Whether a worker's log holds gloo's lost-peer error: a line of
    gloo's TCP transport that says the connection to a peer is gone."""
    return any(_GLOO_TRANSPORT in line and any(m in line for m in _PEER_LOST)
               for line in log_tail.splitlines())


def _mark_lost_peers(results: List[WorkerResult]) -> List[WorkerResult]:
    """Rows of workers of a gloo gang that exited on their own only
    because a peer died (their log holds gloo's lost-peer error) become
    collateral (``gang_killed``), as the same workers blocked in an NCCL
    collective would be, so that the supervisor blames the rank that
    died. An NCCL gang's survivors block until the gang kill, so no row
    of theirs matches. Kept as they are when every failed worker lost a
    peer (no rank to blame)."""
    lost = [r for r in results if r.disposition == "exited" and not r.ok
            and _gloo_lost_peer(r.log_tail)]
    if not lost or len(lost) == sum(not r.ok for r in results):
        return results
    for r in lost:
        r.error = f"{r.error}: a peer failed (its collective lost the peer)"
        r.disposition = "gang_killed"
    return results


class LocalLauncher:
    """Spawn N worker processes on this machine (one per card of a host,
    or a gloo gang on the CPU). Gang semantics: all start together; on any
    worker's crash the rest are killed after ``grace`` rather than hanging
    at the next collective — the failure surfaces as that worker's result
    row."""

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
        liveness_timeout: Optional[float] = None,
    ) -> List[WorkerResult]:
        """``liveness_timeout``: seconds a worker may go without a heartbeat
        (``launch.heartbeat()``, called per batch by Model.fit and its
        eval/epoch-boundary loops) before it is treated as hung — killed
        and recorded as failed, which then gang-kills its peers after
        ``grace`` exactly like a crash. ``None`` (default) disables the
        probe. The probe arms per worker only after its FIRST beat, so
        slow startup/compile never trips it — but later SINGLE blocking
        operations emit no beats while they run: a kernel's first ``nvcc``
        build (seconds to minutes; a relaunched worker finds the kernels
        its gang already built in ``_build/``), a CUDA graph's capture, a
        large checkpoint write. Choose a liveness_timeout comfortably
        above the longest such operation, not above a step time. Ports
        come from ``base_port`` or, by default, free ones each run, so a
        relaunched gang never meets the dead gang's rendezvous store."""
        if base_port is not None:
            ports = [base_port + i for i in range(num_workers)]
        else:
            ports = net.free_ports(num_workers)
        workers = [f"127.0.0.1:{p}" for p in ports]
        tmp = Path(tempfile.mkdtemp(prefix="dtpu_launch_"))
        procs = []
        hb_paths = [tmp / f"heartbeat-{i}" for i in range(num_workers)]
        for i in range(num_workers):
            spec = config_lib.ClusterSpec(workers=workers, index=i)
            env = dict(os.environ)
            env.update(self.env_extra)
            env[config_lib.ENV_VAR] = spec.to_json()
            env[RESULT_ENV] = str(tmp / f"result-{i}.json")
            env[HEARTBEAT_ENV] = str(hb_paths[i])
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
            if liveness_timeout is not None:
                for i in list(pending):
                    try:
                        last = os.path.getmtime(hb_paths[i])
                    except OSError:
                        continue  # not armed until the first beat
                    if now - last <= liveness_timeout:
                        continue
                    kill_and_record(
                        i,
                        f"liveness timeout (no heartbeat for "
                        f"{liveness_timeout:.0f}s; worker hung?)",
                        "liveness_killed",
                    )
                    if first_failure is None:
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
        return _mark_lost_peers([r for r in results if r is not None])


class SSHLauncher:
    """Spawn one worker per remote host over ssh (each host runs the same
    program against its own card — the reference's per-machine manual
    sessions, automated).

    Assumes passwordless ssh and a shared filesystem or pre-synced code,
    the same operational posture as the reference's EC2 recipe. Results
    come back over stdout framing rather than files.
    """

    MARK = STDOUT_MARK

    def __init__(self, hosts: Sequence[str], *, ssh_cmd: str = "ssh", port: int = 8476):
        self.hosts = list(hosts)
        self.ssh_cmd = ssh_cmd
        self.port = port

    def run(
        self,
        argv: Sequence[str],
        *,
        timeout: float = 3600.0,
        grace: float = 10.0,
        env_extra: Optional[Dict[str, str]] = None,
        liveness_timeout: Optional[float] = None,
    ) -> List[WorkerResult]:
        """``liveness_timeout``: see LocalLauncher.run — same contract, but
        liveness rides stdout (``heartbeat()`` prints a marker line when
        ``DTPU_HEARTBEAT_STDOUT=1``; any later output also counts as a
        beat). Armed per worker only after its first marker, so compile
        time and ssh startup never trip it."""
        workers = [f"{h}:{self.port}" for h in self.hosts]
        unreachable = [w for w, ok in net.preflight(workers).items() if not ok]
        if unreachable:
            raise RuntimeError(f"Preflight failed for: {unreachable}")
        procs = []
        for i, host in enumerate(self.hosts):
            spec = config_lib.ClusterSpec(workers=workers, index=i)
            exports = {
                config_lib.ENV_VAR: spec.to_json(),
                RESULT_STDOUT_ENV: "1",
                HEARTBEAT_STDOUT_ENV: "1",
                **(env_extra or {}),
            }
            # shlex.quote everything: env values hold JSON and argv may hold
            # paths with spaces; unquoted, the remote shell would word-split
            # and expand $/backtick metacharacters. The worker announces its
            # remote pid first and `exec`s so $$ IS the worker process —
            # that pid is what a liveness kill must target (killing only
            # the local ssh client leaves a hung remote worker holding the
            # host's card, and the relaunched gang can't acquire it).
            export_str = "; ".join(
                f"export {k}={shlex.quote(v)}" for k, v in exports.items()
            )
            cmd = " ".join(shlex.quote(a) for a in argv)
            remote = f"echo {PID_MARK}$$; {export_str}; exec {cmd}"
            procs.append(
                subprocess.Popen(
                    [self.ssh_cmd, host, remote],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        # Drain all stdout pipes concurrently, line by line: one log-heavy
        # worker must not fill its pipe and stall the gang at a collective
        # while we block on a different worker (the "never a hang"
        # contract). Heartbeat marker lines update last_beat and are
        # filtered out of the captured output.
        # Per-worker line buffers are shared with the drain threads: the
        # main thread can assemble partial output WITHOUT joining a thread
        # that may be blocked forever on a pipe an orphaned remote child
        # still holds open (closing our read end cannot unblock a reader
        # parked inside the stream's lock — it would deadlock the closer).
        bufs: List[List[str]] = [[] for _ in procs]
        last_beat: List[Optional[float]] = [None] * len(procs)
        pids: List[Optional[int]] = [None] * len(procs)

        def _drain(i, proc):
            for line in proc.stdout:
                if line.startswith(PID_MARK):
                    try:
                        pids[i] = int(line[len(PID_MARK):].strip())
                    except ValueError:
                        pass
                    continue
                if line.startswith(HEARTBEAT_MARK):
                    last_beat[i] = time.time()
                    continue
                bufs[i].append(line)
                if last_beat[i] is not None:
                    # Once armed, any output counts as liveness: a
                    # worker busy printing logs is not hung.
                    last_beat[i] = time.time()

        def _remote_kill(i):
            """Best-effort SIGKILL of the remote worker process itself:
            killing only the local ssh client cannot stop a SIGSTOPped or
            deadlocked remote (sshd's HUP is not deliverable to a stopped
            process), which would keep holding the host's card."""
            if pids[i] is None:
                return
            try:
                subprocess.Popen(
                    [self.ssh_cmd, self.hosts[i], f"kill -9 {pids[i]}"],
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
            except OSError:
                pass

        drains = [
            threading.Thread(target=_drain, args=(i, p), daemon=True,
                             name=f"dtpu-ssh-drain-{i}")
            for i, p in enumerate(procs)
        ]
        for t in drains:
            t.start()
        # Gang semantics (same as LocalLauncher): when one worker dies, its
        # peers are blocked at their next collective waiting for it — kill
        # them after `grace` instead of letting them burn the full timeout.
        killed: set = set()
        hung: set = set()
        first_failure: Optional[float] = None
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            now = time.time()
            if first_failure is None and any(
                p.poll() not in (None, 0) for p in procs
            ):
                first_failure = now
            if liveness_timeout is not None:
                for i, p in enumerate(procs):
                    if (
                        p.poll() is None
                        and i not in hung
                        and last_beat[i] is not None
                        and now - last_beat[i] > liveness_timeout
                    ):
                        hung.add(i)
                        _remote_kill(i)
                        p.kill()
                        if first_failure is None:
                            first_failure = now
            if now > deadline or (
                first_failure is not None and now > first_failure + grace
            ):
                killed_timeout = now > deadline
                kill_reason = (
                    "timeout" if killed_timeout
                    else "killed after peer failure (gang semantics)"
                )
                for i, p in enumerate(procs):
                    if p.poll() is None:
                        killed.add(i)
                        _remote_kill(i)
                        p.kill()
                break
            time.sleep(0.2)
        # Bounded drain joins ("never a hang"): a wrapper script or remote
        # child that inherited stdout can hold the pipe open past the kill.
        # After the deadline the daemon drain threads are simply ABANDONED —
        # every line they read so far is already in bufs, and they die with
        # the process. (Closing the read end from here cannot unblock a
        # reader and can deadlock on the stream lock instead.)
        join_deadline = time.time() + 30.0
        for t in drains:
            t.join(max(0.0, join_deadline - time.time()))
        results = []
        for i, proc in enumerate(procs):
            out = "".join(bufs[i])
            value = None
            for line in (out or "").splitlines():
                if line.startswith(self.MARK):
                    try:
                        value = json.loads(line[len(self.MARK):])
                    except json.JSONDecodeError:
                        pass
            if proc.returncode == 0 and i not in hung:
                err, disposition = None, "exited"
            elif i in hung:
                err = (
                    f"liveness timeout (no heartbeat for "
                    f"{liveness_timeout:.0f}s; worker hung?)"
                )
                disposition = "liveness_killed"
            elif i in killed:
                err = kill_reason
                disposition = "timeout" if killed_timeout else "gang_killed"
            else:
                err = f"exit code {proc.returncode}"
                disposition = "exited"
            ok = proc.returncode == 0 and i not in hung
            results.append(
                WorkerResult(
                    index=i,
                    ok=ok,
                    value=value,
                    error=err,
                    # A launcher-killed worker's returncode is the kill
                    # signal, not its own exit — report None so exit-
                    # disposition consumers never mistake it for a fault.
                    exit_code=(proc.returncode
                               if disposition == "exited" else None),
                    log_tail="" if ok else (out or "")[-4096:],
                    disposition=disposition,
                )
            )
        return _mark_lost_peers(results)


def launch_local(argv: Sequence[str], num_workers: int, **kw) -> List[WorkerResult]:
    return LocalLauncher().run(argv, num_workers, **kw)


def run_with_restart(
    launcher,
    argv: Sequence[str],
    *run_args,
    max_restarts: int = 2,
    restart_backoff: float = 2.0,
    **run_kw,
) -> List[WorkerResult]:
    """Gang-run with automatic full-gang restart on worker failure.

    The reference documents its own gap here: "Workers will need to restart
    training if any fails" — an operator action. This automates it: on
    any failed attempt the WHOLE gang is relaunched (the launcher's
    gang-kill already tore down the survivors), up to ``max_restarts``
    times, with ``restart_backoff`` seconds between attempts. Leave
    ``base_port`` unset so that each attempt rendezvouses on fresh free
    ports.

    Recovery-without-rework is the training script's side of the contract:
    run with ``ModelCheckpoint(dir, restore=True)`` and a fixed seed, and a
    relaunch of the identical command restores the latest complete
    checkpoint and fast-forwards the batch stream to the exact next batch
    (training/model.py resume math) — the restarted run matches an
    uninterrupted one batch-for-batch (tests/test_torch_launch_restart.py).

    Returns the final attempt's results (per-worker rows, errors as data).
    """
    attempt = 0
    while True:
        try:
            results = launcher.run(argv, *run_args, **run_kw)
        except RuntimeError as e:
            # Keep the errors-as-data contract across attempts: an SSH
            # relaunch whose preflight finds the dead host unreachable
            # raises — synthesize one failed row PER EXPECTED WORKER
            # instead of propagating, so callers indexing results by rank
            # see a stable shape across attempts.
            n = run_kw.get("num_workers")
            if n is None and run_args and isinstance(run_args[0], int):
                n = run_args[0]
            if n is None:
                n = len(getattr(launcher, "hosts", None) or []) or 1
            results = [
                WorkerResult(index=i, ok=False, error=str(e))
                for i in range(n)
            ]
        if all(r.ok for r in results):
            return results
        if attempt >= max_restarts:
            dlog.warning(
                f"gang failed and restart budget exhausted "
                f"({max_restarts} restarts); returning failed results"
            )
            return results
        attempt += 1
        failed = [r.index for r in results if not r.ok]
        dlog.warning(
            f"gang failure on worker(s) {failed}; restart "
            f"{attempt}/{max_restarts} in {restart_backoff:.0f}s "
            "(resume from latest checkpoint is the script's "
            "ModelCheckpoint(restore=True) contract)"
        )
        time.sleep(restart_backoff)


__all__ = [
    "HEARTBEAT_ENV", "HEARTBEAT_MARK", "HEARTBEAT_STDOUT_ENV",
    "LocalLauncher", "PID_MARK", "RESULT_ENV", "RESULT_STDOUT_ENV",
    "SSHLauncher", "STDOUT_MARK", "WorkerResult", "heartbeat",
    "launch_local", "report_result", "run_with_restart",
]
