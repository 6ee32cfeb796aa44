"""Supervisor: a supervised, restartable training runtime.

The port's copy of the JAX package's ``resilience/supervisor.py`` (which
imports no JAX), on the port's gang launchers (``launch.LocalLauncher``,
``launch.SSHLauncher``): the same restart, preemption and elastic
decisions, and the same event stream, field for field.

The outermost layer of the resilience subsystem — it manages the process
lifecycle AROUND the trainer instead of code inside it. A ``Supervisor``
owns a gang launcher (``launch.LocalLauncher`` by default, ``SSHLauncher``
for remote hosts), runs the training command under heartbeat liveness tracking,
and on failure relaunches the whole gang under a
:class:`~distributed_tpu_torch.resilience.RestartPolicy` (bounded exponential
backoff, max-restart budget, preemptions exempt). Every lifecycle fact is
appended to the structured event log (``utils.events``), which it shares
with its workers via ``DTPU_EVENT_LOG``.

Recovery-without-rework stays the training script's side of the contract
(same as ``launch.run_with_restart``): run with ``ModelCheckpoint(dir,
restore=True)`` and a fixed seed, and a relaunch of the identical command
restores the latest *valid* checkpoint (corrupt files are skipped, see
``checkpoint.core``) and fast-forwards the batch stream — the supervised
run ends bit-identical to an uninterrupted one.

Elastic mode (``Supervisor(elastic=ElasticPolicy(...))``) extends the
relaunch with a per-attempt world size: a *permanent* worker loss —
detected by per-rank failure attribution across attempts, or reported by
a capacity probe — re-forms the gang at a new size N′ (budget-free, see
``elastic.py``) instead of burning the restart budget on a doomed fixed-N
relaunch, and grows back toward ``max_workers`` when capacity returns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..launch.core import LocalLauncher, WorkerResult
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import logging as dlog
from .elastic import ElasticPolicy, FailureLedger
from .policy import RestartPolicy
# From markers, not preemption: the controller needs only the marker I/O,
# not the worker side's callback and checkpointer.
from .markers import (
    PREEMPTED_EXIT_CODE,
    clear_resume_marker,
    read_resume_marker,
)

# Mirrors cluster.init.ELASTIC_WORLD_ENV (the workers read it).
ELASTIC_WORLD_ENV = "DTPU_ELASTIC_WORLD"
# Mirrors redundancy.ENV_VAR (the store is imported lazily where needed).
BUDDY_STORE_ENV = "DTPU_BUDDY_STORE"


def recovery_rows(events: Sequence[dict]) -> List[dict]:
    """Per-recovery MTTR breakdown from a supervised run's event records:
    one row per failed attempt whose successor relaunched, splitting the
    recovery into

    - ``detect_s``      — injected fault (``fault_injected``) to the
      launcher declaring the attempt dead (``attempt_end``); None for
      organic failures with no fault event.
    - ``gang_reform_s`` — attempt end to the relaunched gang opening its
      restore (``restore_begin``): process spawn, imports, the
      process group's formation, the model's build.
    - ``restore_s``     — ``restore_begin`` to ``restore_end`` (which
      carries the tier used and the disk blocks read).
    - ``recompile_s``   — ``restore_end`` to the first completed
      optimizer step (``post_restore_step``): the first dispatch (the
      kernels' loads, a CUDA graph's capture under steps_per_execution).

    Worker-side events are filtered to rank 0 (every rank restores; one
    timeline per recovery). Fields are None when the corresponding events
    are absent — a worker without ``ModelCheckpoint(restore=True)`` emits
    no restore markers, and the row then only attributes what it can.
    The supervisor emits each row as a ``recovery`` event at run end, so
    the time to recover is attributed, not one opaque restart latency.

    ``flight_dumps`` lists the flight-recorder dump files the FAILED
    attempt left behind (``flight_dump`` events, emitted by the
    fault/preemption/exception death paths — obs.flight): the postmortem
    row names the black boxes holding the seconds before that death."""

    def _rank0(e):
        return e.get("rank") in (None, 0)

    ends = {e.get("attempt"): e for e in events
            if e["event"] == evs.ATTEMPT_END and not e.get("ok", True)}
    starts = {e.get("attempt"): e for e in events
              if e["event"] == evs.ATTEMPT_START}
    rows: List[dict] = []
    for attempt in sorted(a for a in ends if a is not None):
        nxt = attempt + 1
        if nxt not in starts:
            continue
        t_fail = ends[attempt]["ts"]
        t_next_end = ends.get(nxt, {}).get("ts", float("inf"))
        window = [e for e in events
                  if starts[nxt]["ts"] <= e["ts"] <= t_next_end]
        fault = max((e for e in events
                     if e["event"] == evs.FAULT_INJECTED and e["ts"] <= t_fail),
                    key=lambda e: e["ts"], default=None)
        rb = next((e for e in window
                   if e["event"] == evs.RESTORE_BEGIN and _rank0(e)), None)
        re_ = next((e for e in window
                    if e["event"] == evs.RESTORE_END and _rank0(e)), None)
        ps = next((e for e in window
                   if e["event"] == evs.POST_RESTORE_STEP and _rank0(e)), None)
        first = next((e for e in window if e["event"] == evs.FIRST_STEP), None)

        def span(a, b):
            return round(b["ts"] - a["ts"], 4) if (a and b) else None

        dumps = sorted({
            e["path"] for e in events
            if e["event"] == evs.FLIGHT_DUMP and e.get("path")
            and (e.get("attempt") == attempt
                 or (e.get("attempt") is None and e["ts"] <= t_fail))
        })
        rows.append({
            "failed_attempt": attempt,
            "recovered_attempt": nxt,
            "flight_dumps": dumps,
            "detect_s": span(fault, ends[attempt]),
            "gang_reform_s": span(ends[attempt], rb),
            "restore_s": span(rb, re_),
            "recompile_s": span(re_, ps),
            "restore_tier": (re_ or {}).get("tier"),
            "restore_step": (re_ or {}).get("step"),
            "disk_block_reads": (re_ or {}).get("disk_block_reads"),
            "total_to_first_step_s": span(ends[attempt], ps or first),
        })
    return rows


@dataclasses.dataclass
class SupervisedResult:
    """Outcome of a supervised run: final-attempt worker rows plus the
    restart accounting a caller needs to reason about what happened.
    ``resizes`` counts elastic gang re-formations and ``world_size`` is the
    final attempt's gang size (== the launch size for fixed-size runs)."""

    ok: bool
    attempts: int
    restarts_used: int
    preemptions: int
    results: List[WorkerResult]
    event_log: Optional[str] = None
    resizes: int = 0
    world_size: Optional[int] = None

    @property
    def failed(self) -> List[WorkerResult]:
        return [r for r in self.results if not r.ok]


def _gang_collateral(r: WorkerResult) -> bool:
    """True for a row the launcher killed because of a PEER — a consequence
    of someone else's failure, never an independent fault. Decided from the
    launcher's structural disposition; rows from launchers predating the
    field fall back to exit disposition (a gang-killed worker never exits
    on its own, so it has no exit code) minus the other no-exit-code kills,
    which carry their reason in ``error``."""
    if r.disposition is not None:
        return r.disposition == "gang_killed"
    err = r.error or ""
    return r.exit_code is None and "liveness" not in err and "timeout" not in err


def _initiated(r: WorkerResult) -> bool:
    """True when this rank's own behavior started the gang failure — the
    rows the elastic ledger attributes. Collateral gang-kills, preemptions,
    whole-run timeouts, and launch errors don't count: those synthesize a
    row for EVERY rank, and blaming everyone is blaming no one (a dead
    coordinator is not rank 0's fault)."""
    if r.ok or r.exit_code == PREEMPTED_EXIT_CODE:
        return False
    if r.disposition in ("timeout", "launch_error"):
        return False
    if "timeout" == (r.error or ""):
        return False
    return not _gang_collateral(r)


def _classify_preemption(failed: Sequence[WorkerResult]) -> bool:
    """True when the attempt ended by preemption: at least one worker took
    the PreemptionHandler exit, and every other failure is the same or the
    launcher's gang-kill of its peers (a consequence of the preemption, not
    an independent fault). Collateral is judged by exit disposition — an
    error-string match would misread a peer row whose ``error`` is None
    and burn restart budget on a clean preemption."""
    if not failed:
        return False
    if not any(r.exit_code == PREEMPTED_EXIT_CODE for r in failed):
        return False
    return all(
        r.exit_code == PREEMPTED_EXIT_CODE or _gang_collateral(r)
        for r in failed
    )


class Supervisor:
    """Launch-and-monitor loop for one training command.

    ``argv``: the worker command (same on every attempt — the resume
    contract is "relaunch the identical command"). ``num_workers`` applies
    to local launchers; an ``SSHLauncher`` derives the gang from its host
    list. ``checkpoint_dir`` (optional) lets the supervisor report resume
    state in its events and clear the resume marker once the run finally
    completes. ``liveness_timeout`` arms the launcher's heartbeat probe so
    hangs are restartable too, not just crashes.

    ``elastic``: an :class:`~distributed_tpu_torch.resilience.ElasticPolicy`
    opts into gang re-formation at a new world size on permanent worker
    loss (and grow-back under a capacity probe). Each attempt's size rides
    the launcher (``num_workers`` for local launchers, a host-list prefix
    for SSH-style ones — permanently-lost ranks' hosts are excluded before
    trimming) and is exported to workers as ``DTPU_ELASTIC_WORLD`` so
    ``cluster.initialize()`` overrides any stale inherited spec.

    ``sleep`` is injectable for tests (backoff schedules assert without
    waiting them out).
    """

    def __init__(
        self,
        argv: Sequence[str],
        num_workers: int = 1,
        *,
        launcher=None,
        policy: Optional[RestartPolicy] = None,
        elastic: Optional[ElasticPolicy] = None,
        checkpoint_dir=None,
        buddy_store_dir=None,
        event_log: Optional[events_lib.EventLog] = None,
        env_extra: Optional[Dict[str, str]] = None,
        liveness_timeout: Optional[float] = None,
        straggler_threshold: Optional[float] = None,
        sleep=time.sleep,
    ):
        self.argv = list(argv)
        self.num_workers = int(num_workers)
        self.launcher = launcher if launcher is not None else LocalLauncher()
        self.policy = policy or RestartPolicy()
        self.elastic = elastic
        self.checkpoint_dir = checkpoint_dir
        # Diskless-recovery tier (resilience/redundancy.py):
        # when set, workers learn the RAM store via DTPU_BUDDY_STORE
        # (ModelCheckpoint(buddy=True) arms itself from it), and the
        # supervisor models per-host memory loss: before each relaunch it
        # drops the store segments of ranks that INITIATED the failure —
        # a crashed worker's resident mirrors did not survive it, while
        # gang-killed collateral peers (healthy hosts) keep theirs.
        self.buddy_store_dir = buddy_store_dir
        self.event_log = event_log
        self.env_extra = dict(env_extra or {})
        self.liveness_timeout = liveness_timeout
        # Cross-rank straggler attribution (obs/aggregate.py): a
        # worker whose median step time exceeds the gang median by this
        # factor gets named in a `straggler` event at run end (the
        # workers' metrics_snapshot flushes ride the event log this
        # supervisor already shares with them). None = the
        # obs.aggregate default.
        self.straggler_threshold = straggler_threshold
        self._sleep = sleep
        # SSH-style launchers derive the gang from a host list; elastic
        # resizes then operate on this working copy (lost ranks' hosts
        # excluded, excluded hosts re-admitted on grow, prefix trimmed to
        # the world size). None for sized (LocalLauncher-style) launchers.
        hosts = getattr(self.launcher, "hosts", None)
        self._all_hosts = list(hosts) if hosts else None
        self._active_hosts = list(hosts) if hosts else None

    # ------------------------------------------------------------------ event
    def _emit(self, kind: str, **fields):
        if self.event_log is not None:
            try:
                self.event_log.emit(kind, **fields)
            except OSError:
                pass

    # ----------------------------------------------------------------- launch
    def _attempt_env(self, attempt: int, world: int) -> Dict[str, str]:
        env = dict(self.env_extra)
        env["DTPU_ATTEMPT"] = str(attempt)
        if self.buddy_store_dir is not None:
            env[BUDDY_STORE_ENV] = str(self.buddy_store_dir)
        if self.elastic is not None:
            # The relaunched workers must form a clean N'-process runtime
            # even when a stale N-worker spec is inherited from the
            # environment (cluster/init.py honors this override).
            env[ELASTIC_WORLD_ENV] = str(world)
        if self.event_log is not None:
            env[events_lib.ENV_VAR] = str(self.event_log.path)
        return env

    def _launch(self, attempt: int, world: int, timeout: float, grace: float,
                **launch_kw) -> List[WorkerResult]:
        env = self._attempt_env(attempt, world)
        kw = dict(timeout=timeout, grace=grace, **launch_kw)
        if self.liveness_timeout is not None:
            kw.setdefault("liveness_timeout", self.liveness_timeout)
        try:
            if hasattr(self.launcher, "env_extra"):
                # LocalLauncher-style: env rides the launcher instance and
                # the gang size is this attempt's world.
                saved = self.launcher.env_extra
                self.launcher.env_extra = {**saved, **env}
                try:
                    return self.launcher.run(self.argv, world, **kw)
                finally:
                    self.launcher.env_extra = saved
            # SSHLauncher-style: env is a run kwarg, gang size comes from
            # the launcher's host list — which elastic resizes rewrite
            # (self._active_hosts), so launch through the working copy.
            if self._active_hosts is not None:
                saved_hosts = self.launcher.hosts
                self.launcher.hosts = list(self._active_hosts)
                try:
                    return self.launcher.run(self.argv, env_extra=env, **kw)
                finally:
                    self.launcher.hosts = saved_hosts
            return self.launcher.run(self.argv, env_extra=env, **kw)
        except RuntimeError as e:
            # Keep the errors-as-data contract (same as run_with_restart):
            # a preflight failure on relaunch becomes one failed row per
            # expected worker, so result shape is stable across attempts.
            return [
                WorkerResult(index=i, ok=False, error=str(e),
                             disposition="launch_error")
                for i in range(world)
            ]

    # ---------------------------------------------------------------- elastic
    def _elastic_candidate(
        self, world: int, default_max: int, preempted: bool,
        failed: Sequence[WorkerResult], ledger: FailureLedger, resizes: int,
    ) -> Optional[Tuple[int, dict]]:
        """The (new_world, event_fields) this restart boundary should
        re-form to, or None to keep the fixed-size behavior. Probe wins
        over attribution (an explicit capacity signal both shrinks and
        grows); attribution only ever shrinks — it cannot observe
        returning capacity. ``default_max`` is the run's launch size, the
        grow ceiling when the policy sets no ``max_workers``."""
        if self.elastic is None:
            return None
        lost: Tuple[int, ...] = ()
        if not preempted:
            ledger.record(r.index for r in failed if _initiated(r))
        if self.elastic.probe is not None:
            cand = self.elastic.snap(int(self.elastic.probe()), default_max)
            trigger = "probe"
        else:
            lost = tuple(sorted(
                r for r in ledger.permanent(self.elastic.failure_threshold)
                if r < world
            ))
            if not lost:
                return None
            cand = self.elastic.snap(world - len(lost), default_max)
            if cand is not None and cand >= world:
                cand = None  # attribution never grows
            trigger = "attribution"
        if cand is None or cand == world:
            return None
        if resizes >= self.elastic.max_resizes:
            self._emit(evs.RESIZE_CAP_EXHAUSTED, resizes=resizes,
                       wanted_world=cand)
            return None
        return cand, {
            "reason": "shrink" if cand < world else "grow",
            "trigger": trigger,
            "lost_ranks": list(lost),
        }

    def _apply_resize(self, world: int, new_world: int,
                      lost_ranks: Sequence[int]) -> None:
        """Rewrite the SSH-style working host list for the new world:
        permanently-lost ranks' hosts are excluded first (a shrink must
        route AROUND the bad host, not just truncate onto it), then the
        list is grown back from excluded hosts (original order) or trimmed
        to the world size."""
        if self._active_hosts is None:
            return
        active = [h for i, h in enumerate(self._active_hosts)
                  if i not in set(lost_ranks)]
        if len(active) < new_world:
            for h in self._all_hosts:
                if len(active) >= new_world:
                    break
                if h not in active:
                    active.append(h)
        self._active_hosts = active[:new_world]

    # -------------------------------------------------------------------- run
    def run(self, *, timeout: float = 600.0, grace: float = 10.0,
            **launch_kw) -> SupervisedResult:
        """Supervise until success, budget exhaustion, or preemption-cap.

        Returns the final attempt's per-worker rows (errors as data, never
        an exception) wrapped with restart accounting. Under an elastic
        policy the gang may complete at a different world size than it
        launched (``SupervisedResult.world_size`` / ``resizes``)."""
        attempt = 0
        restarts_used = 0
        preemptions = 0
        resizes = 0
        ledger = FailureLedger()
        world = (len(self._active_hosts) if self._active_hosts is not None
                 else self.num_workers)
        launch_world = world  # the grow ceiling when max_workers is unset
        if self.elastic is not None and self.elastic.probe is not None:
            # Launch at today's capacity, not the requested size — a run
            # started while the cluster is short shouldn't burn its budget
            # discovering that.
            cand = self.elastic.snap(int(self.elastic.probe()), launch_world)
            if cand is not None and cand != world:
                resizes += 1
                self._emit(evs.GANG_RESIZE, from_world=world, to_world=cand,
                           reason="shrink" if cand < world else "grow",
                           trigger="probe", lost_ranks=[], attempt=0)
                self._apply_resize(world, cand, ())
                world = cand
        while True:
            attempt += 1
            self._emit(evs.ATTEMPT_START, attempt=attempt, world_size=world,
                       restarts_used=restarts_used, preemptions=preemptions,
                       resizes=resizes)
            t0 = time.monotonic()
            results = self._launch(attempt, world, timeout, grace,
                                   **launch_kw)
            failed = [r for r in results if not r.ok]
            self._emit(
                evs.ATTEMPT_END, attempt=attempt, ok=not failed,
                world_size=world,
                duration=round(time.monotonic() - t0, 3),
                failed_ranks=[r.index for r in failed],
                exit_codes=[r.exit_code for r in failed],
            )
            if not failed:
                if self.checkpoint_dir is not None:
                    clear_resume_marker(self.checkpoint_dir)
                self._emit_recoveries()
                self._emit(evs.RUN_COMPLETE, attempts=attempt,
                           restarts_used=restarts_used,
                           preemptions=preemptions, resizes=resizes,
                           world_size=world)
                return self._result(True, attempt, restarts_used,
                                    preemptions, results, resizes, world)
            preempted = _classify_preemption(failed)
            resize = self._elastic_candidate(world, launch_world, preempted,
                                             failed, ledger, resizes)
            if preempted and self.policy.preemption_exempt:
                if not self.policy.allows_preemption_restart(preemptions):
                    self._emit_recoveries()
                    self._emit(evs.PREEMPTION_CAP_EXHAUSTED,
                               preemptions=preemptions)
                    dlog.warning(
                        f"Supervisor: preemption cap "
                        f"({self.policy.max_preemptions}) exhausted"
                    )
                    return self._result(False, attempt, restarts_used,
                                        preemptions, results, resizes, world)
                preemptions += 1
                delay, reason = 0.0, "preempted"
            elif resize is not None:
                # Re-forming the gang at a new size is capacity management,
                # not a defect of the job: budget-free, like preemption
                # (bounded by ElasticPolicy.max_resizes).
                delay, reason = 0.0, "resize"
            else:
                if not self.policy.allows_restart(restarts_used):
                    self._emit_recoveries()
                    self._emit(evs.BUDGET_EXHAUSTED,
                               restarts_used=restarts_used,
                               max_restarts=self.policy.max_restarts)
                    dlog.warning(
                        f"Supervisor: restart budget exhausted "
                        f"({self.policy.max_restarts} restarts); giving up"
                    )
                    return self._result(False, attempt, restarts_used,
                                        preemptions, results, resizes, world)
                restarts_used += 1
                delay = self.policy.delay(restarts_used)
                reason = "preempted" if preempted else "failure"
            if resize is not None:
                new_world, info = resize
                resizes += 1
                ledger.reset()  # a re-formed gang renumbers its ranks
                self._emit(evs.GANG_RESIZE, from_world=world,
                           to_world=new_world, attempt=attempt, **info)
                dlog.warning(
                    f"Supervisor: {info['reason']} gang {world} -> "
                    f"{new_world} workers ({info['trigger']}"
                    + (f", lost ranks {info['lost_ranks']}"
                       if info["lost_ranks"] else "")
                    + ")"
                )
                self._apply_resize(world, new_world, info["lost_ranks"])
                world = new_world
            if not preempted:
                # A rank that initiated the failure lost its host memory;
                # its buddy-store segment (its own shard's RAM copy + the
                # ring mirror it held) must not survive into the next
                # attempt's recovery decision. Preemptions and collateral
                # gang-kills keep their segments: those hosts are healthy.
                self._invalidate_buddy_segments(failed)
            resume = self._resume_state()
            self._emit(evs.RESTART, attempt=attempt + 1, reason=reason,
                       world_size=world, delay=delay,
                       restarts_used=restarts_used,
                       preemptions=preemptions, resizes=resizes, **resume)
            dlog.warning(
                f"Supervisor: {reason} on worker(s) "
                f"{[r.index for r in failed]}; relaunching in {delay:.1f}s "
                f"at world size {world} "
                f"(restarts {restarts_used}/{self.policy.max_restarts}, "
                f"preemptions {preemptions}, resizes {resizes})"
                + (f", resume from step {resume['resume_step']}"
                   if resume.get("resume_step") is not None else "")
            )
            if delay > 0:
                self._sleep(delay)

    def _invalidate_buddy_segments(self, failed: Sequence[WorkerResult]):
        if self.buddy_store_dir is None:
            return
        ranks = sorted({r.index for r in failed if _initiated(r)})
        if not ranks:
            return
        from .redundancy import BuddyStore  # plain numpy and files

        gone = BuddyStore(self.buddy_store_dir).invalidate_ranks(ranks)
        if gone:
            self._emit(evs.BUDDY_SEGMENTS_INVALIDATED, ranks=gone)

    def _resume_state(self) -> Dict[str, Optional[int]]:
        """What the relaunch is expected to resume from: the latest VALID
        checkpoint step (corrupt latest files excluded, same scan restore
        uses) plus any resume-marker step a preemption recorded."""
        if self.checkpoint_dir is None:
            return {}
        from ..checkpoint import Checkpointer

        step = Checkpointer(self.checkpoint_dir).latest_valid_step()
        marker = read_resume_marker(self.checkpoint_dir)
        return {
            "resume_step": step,
            "marker_step": marker["step"] if marker else None,
        }

    def _emit_recoveries(self):
        """MTTR telemetry: one `recovery` event per restart boundary with
        the detect/gang-reform/restore/recompile split, the restore
        tier used, and the failed attempt's flight-dump paths — computed
        from the run's own event stream right before the terminal event,
        so post-mortems read rows, not raw timestamps. Also the
        cross-rank skew boundary: a `rank_skew` summary over the workers'
        metrics_snapshot flushes, plus a `straggler` event naming the
        slowest rank when its median step time exceeds the gang median by
        `straggler_threshold`."""
        if self.event_log is None:
            return
        try:
            events = self.event_log.read()
            for row in recovery_rows(events):
                self._emit(evs.RECOVERY, **row)
            self._emit_skew(events)
        except OSError:
            pass

    def _emit_skew(self, events):
        from ..obs import aggregate  # plain event math

        report = aggregate.skew_report(events)
        if report is None:
            return
        self._emit(evs.RANK_SKEW, **report)
        threshold = (self.straggler_threshold
                     if self.straggler_threshold is not None
                     else aggregate.DEFAULT_THRESHOLD)
        row = aggregate.straggler(events, threshold)
        if row is not None:
            self._emit(evs.STRAGGLER, **row)
            dlog.warning(
                f"Supervisor: straggler rank {row['rank']} at "
                f"{row['skew']}x the gang median step time "
                f"({row['median_step_s']}s vs "
                f"{row['gang_median_step_s']}s, threshold {threshold})"
            )

    def _result(self, ok, attempts, restarts_used, preemptions, results,
                resizes=0, world_size=None):
        # Controller-side registry view: the run's
        # restart accounting as counters/gauges next to the rank_skew /
        # straggler events it emitted — a scraper on the supervisor
        # process sees gang health without parsing the event log.
        from ..obs import registry as obs_registry

        reg = obs_registry.default_registry()
        reg.counter("supervisor/attempts", attempts)
        reg.counter("supervisor/restarts", restarts_used)
        reg.counter("supervisor/preemptions", preemptions)
        reg.counter("supervisor/resizes", resizes)
        reg.gauge("supervisor/ok", 1.0 if ok else 0.0)
        if world_size is not None:
            reg.gauge("supervisor/world_size", world_size)
        return SupervisedResult(
            ok=ok,
            attempts=attempts,
            restarts_used=restarts_used,
            preemptions=preemptions,
            results=results,
            event_log=(str(self.event_log.path)
                       if self.event_log is not None else None),
            resizes=resizes,
            world_size=world_size,
        )


def supervise(argv: Sequence[str], num_workers: int = 1, **kw) -> SupervisedResult:
    """One-call form: ``supervise([sys.executable, "train.py"], 4,
    checkpoint_dir=..., liveness_timeout=60).ok``."""
    run_kw = {k: kw.pop(k) for k in ("timeout", "grace") if k in kw}
    return Supervisor(argv, num_workers, **kw).run(**run_kw)
