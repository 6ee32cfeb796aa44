"""Fault injection: prove the resilience machinery works, on demand.

The port's copy of the JAX package's ``resilience/faults.py``: the same
modes, the same ``DTPU_FAULT`` grammar and the same once-markers, with the
rank and world taken from the port's process group
(``utils.logging.rank_world``).

A supervised runtime is only trustworthy if its failure paths are
exercised — so fault injection is a first-class, shippable tool here
(usable from tests and the on-card restart script), not test-local
monkeypatching. :class:`FaultInjector` is a training callback that makes a
worker fail in a chosen mode at a chosen step, once:

- ``kill``: hard process death (``os._exit``) — the crash the launcher's
  exit-code monitoring sees.
- ``hang``: SIGSTOP the process — alive but frozen, the failure mode only
  heartbeat liveness tracking can see.
- ``slow_heartbeat``: the process stays schedulable but stops making
  progress (a long in-step sleep), so heartbeats stall below the
  launcher's ``liveness_timeout`` — hung-in-Python rather than
  hung-in-kernel.
- ``slow_steps``: a PERSISTENT degradation, not a death — from
  ``at_step`` on, every step sleeps ``slow_seconds``. The worker keeps
  heartbeating and finishing, just slower than its peers: the straggler
  the cross-rank skew aggregation (``obs.aggregate``) exists to name.
  Fires every step (no once-marker
  disarm after the first hit); ``fault_injected`` is emitted once.
- ``corrupt_checkpoint``: clobber the newest checkpoint file, then die —
  exercising restore's fall-back-to-previous-step path.
- ``replica_kill``: address a NAMED serving-fleet pool member (e.g.
  ``replica="decode-1"``) instead of a process rank. The fleet polls
  :meth:`FaultInjector.should_kill_replica` at its step boundaries and
  tears that replica down mid-request — the failure the router's
  requeue path exists for. Fleet-driven, not
  training-driven: ``on_batch_end`` ignores this mode.
- ``buddy_kill``: kill a worker AND its ring mirror holder
  (``rank`` and ``(rank+1) % world``) in the same step — the buddy-PAIR
  loss that takes out a shard's live copy and its only in-memory mirror
  together, forcing the recovery-tier selection down to the disk
  checkpoint. Uses per-rank once
  markers so both pair members fire exactly once each.
- ``kill_during_refresh``: die MID buddy-refresh — after the worker's
  ``self`` mirror commit, before the ``peer`` push commits
  (``redundancy.BuddyRedundancy.refresh`` calls
  :func:`fire_refresh_kill` in that window). The surviving mirror set is
  torn/stale, which the restore-tier selection must reject in favor of
  the disk tier. Refresh-driven, not step-driven: ``on_batch_end``
  ignores this mode; arming happens via callback registration at
  ``on_train_begin``.

``once_marker`` (a file path) arms the fault for the FIRST attempt only:
the restarted worker sees the marker and trains through — exactly the
kill-once/recover-once shape every restart test needs. The supervisor
exports ``DTPU_FAULT`` + ``DTPU_FAULT_MARKER`` so worker scripts can arm
injection with ``FaultInjector.from_env()`` without plumbing arguments.
"""

from __future__ import annotations

import os
import re
import signal
import time
from pathlib import Path
from typing import Optional

from ..training.callbacks import Callback
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils.logging import rank_world

ENV_VAR = "DTPU_FAULT"
MARKER_ENV_VAR = "DTPU_FAULT_MARKER"

MODES = ("kill", "hang", "slow_heartbeat", "slow_steps",
         "corrupt_checkpoint", "replica_kill", "buddy_kill",
         "kill_during_refresh")

# kill_during_refresh arming: injectors register here at on_train_begin
# and the buddy-refresh writer polls fire_refresh_kill() mid-refresh.
# Module-level (not plumbed through BuddyRedundancy) so worker scripts
# arm it with the same one-line FaultInjector.from_env() as every other
# mode; deregistered at on_train_end so in-process tests can't leak an
# armed kill into a later fit.
_REFRESH_FAULTS: list = []


def fire_refresh_kill(step: int) -> None:
    """The mid-refresh fault hook: called by
    ``redundancy.BuddyRedundancy.refresh`` between the ``self`` mirror
    commit and the ``peer`` push. Kills the process iff an armed
    ``kill_during_refresh`` injector matches (rank, step, once-marker) —
    same semantics as the step-boundary faults, different trigger
    point."""
    for inj in tuple(_REFRESH_FAULTS):
        inj._maybe_refresh_kill(int(step))


def corrupt_latest_checkpoint(directory) -> Optional[Path]:
    """Overwrite the newest checkpoint with garbage (not a zip, and
    shorter than the original — a torn write), simulating a crash
    mid-save that atomic renames alone cannot guard against. Handles both
    flavors: the newest ``ckpt-*.npz`` (``Checkpointer``; the latest
    pointer is left aimed at it), or — when the directory holds sharded
    ``ckpt-<step>/`` dirs instead — a shard file of the newest COMMITTED
    step (its manifest already promises the file, so restore must detect
    the damage, not re-classify the step as an aborted save). Returns the
    corrupted path, or None when the directory holds no checkpoints."""
    directory = Path(directory)
    steps = []
    for p in directory.glob("ckpt-*.npz"):
        m = re.fullmatch(r"ckpt-(\d+)\.npz", p.name)
        if m:
            steps.append((int(m.group(1)), p))
    if steps:
        _, path = max(steps)
        path.write_bytes(b"\x00not-a-zip\x00" * 3)
        return path
    sharded = []
    for p in directory.glob("ckpt-*"):
        m = re.fullmatch(r"ckpt-(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            sharded.append((int(m.group(1)), p))
    if not sharded:
        return None
    _, step_dir = max(sharded)
    shard = sorted(step_dir.glob("proc-*.npz"))
    if not shard:
        return None
    shard[0].write_bytes(b"\x00not-a-zip\x00" * 3)
    return shard[0]


class FaultInjector(Callback):
    """Inject one fault at ``at_step`` on process ``rank`` (see module doc).

    ``at_step`` is compared against the model's global step counter at
    batch end, with ``>=`` so multi-step execution (which advances the
    counter K at a time) still triggers at the first boundary past the
    target. ``rank=None`` faults every process.
    """

    def __init__(self, mode: str, *, at_step: int = 5,
                 rank: Optional[int] = 0, once_marker=None,
                 exit_code: int = 17, hang_seconds: float = 10_000.0,
                 slow_seconds: float = 0.25,
                 directory=None, replica: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "corrupt_checkpoint" and directory is None:
            raise ValueError(
                "corrupt_checkpoint mode needs directory= (the checkpoint "
                "dir whose newest file gets clobbered)"
            )
        if mode == "replica_kill" and not replica:
            raise ValueError(
                "replica_kill mode needs replica= (the pool-member name, "
                "e.g. 'decode-1', that the fleet should tear down)"
            )
        if mode in ("buddy_kill", "kill_during_refresh") and rank is None:
            raise ValueError(
                f"{mode} mode needs a concrete rank= (the shard owner the "
                "fault targets); rank='all' has no buddy-pair meaning"
            )
        self.mode = mode
        self.at_step = int(at_step)
        self.rank = rank
        self.once_marker = Path(once_marker) if once_marker else None
        self.exit_code = int(exit_code)
        self.hang_seconds = float(hang_seconds)
        self.slow_seconds = float(slow_seconds)
        self.directory = directory
        self.replica = replica
        self.fired = False
        self._slow_announced = False  # slow_steps: one fault_injected event

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        """Build from ``DTPU_FAULT`` ("mode" or "mode:key=val,key=val";
        keys: at_step, rank [int or 'all'], exit_code, hang_seconds,
        slow_seconds, directory, replica) and ``DTPU_FAULT_MARKER``
        (once-only arming). Returns
        None when the variable is unset — scripts can unconditionally
        append ``*filter(None, [FaultInjector.from_env()])``."""
        spec = os.environ.get(ENV_VAR)
        if not spec:
            return None
        mode, _, rest = spec.partition(":")
        kw = {}
        for part in filter(None, rest.split(",")):
            key, _, val = part.partition("=")
            key = key.strip()
            if key in ("at_step", "exit_code"):
                kw[key] = int(val)
            elif key == "rank":
                kw[key] = None if val == "all" else int(val)
            elif key in ("hang_seconds", "slow_seconds"):
                kw[key] = float(val)
            elif key in ("directory", "replica"):
                kw[key] = val
            else:
                raise ValueError(f"unknown {ENV_VAR} key {key!r} in {spec!r}")
        marker = os.environ.get(MARKER_ENV_VAR)
        if marker:
            kw["once_marker"] = marker
        return cls(mode.strip(), **kw)

    def _marker_path(self) -> Optional[Path]:
        """The once-marker this PROCESS checks/touches. buddy_kill kills a
        PAIR of ranks, each of which must fire exactly once — a shared
        marker would let whichever pair member fires first disarm the
        other — so the marker is suffixed per rank for that mode."""
        if self.once_marker is None:
            return None
        if self.mode != "buddy_kill":
            return self.once_marker
        return self.once_marker.with_name(
            self.once_marker.name + f".rank{rank_world()[0]}"
        )

    def _armed(self) -> bool:
        if self.fired:
            return False
        marker = self._marker_path()
        if marker is not None and marker.exists():
            return False
        if self.rank is not None:
            me, world = rank_world()
            if self.mode == "buddy_kill":
                # The targeted shard owner AND its ring mirror holder
                # ((rank+1) % world, see resilience.redundancy) die
                # together: the buddy-pair loss.
                if me not in (self.rank % world, (self.rank + 1) % world):
                    return False
            elif me != self.rank:
                return False
        return True

    # ---------------------------------------------------- refresh trigger --
    def on_train_begin(self, model):
        if self.mode == "kill_during_refresh" and self not in _REFRESH_FAULTS:
            _REFRESH_FAULTS.append(self)

    def on_train_end(self, model, history):
        if self in _REFRESH_FAULTS:
            _REFRESH_FAULTS.remove(self)

    def _maybe_refresh_kill(self, step: int) -> None:
        """Called (via :func:`fire_refresh_kill`) from the buddy-refresh
        writer, mid-refresh. Same arming rules as the step faults; the
        ``os._exit`` may run on the writer thread — it kills the whole
        process either way, which is the point."""
        if self.mode != "kill_during_refresh" or step < self.at_step:
            return
        if not self._armed():
            return
        self.fired = True
        marker = self._marker_path()
        if marker is not None:
            marker.parent.mkdir(parents=True, exist_ok=True)
            marker.touch()
        events_lib.emit(evs.FAULT_INJECTED, mode=self.mode, step=int(step))
        self._flight_dump(step)
        os._exit(self.exit_code)

    def should_kill_replica(self, name: str, step: int) -> bool:
        """Fleet-facing trigger: True exactly once, when ``name`` matches
        the armed ``replica`` target and ``step`` (the fleet's decode-step
        counter for that replica) has reached ``at_step`` — same ``>=``
        comparison and once-marker semantics as the process faults, so a
        marker left by a previous run keeps the fault disarmed. The fleet
        polls this at its step boundaries; process-rank gating does not
        apply (the fleet addresses replicas by name, not rank)."""
        if self.mode != "replica_kill" or name != self.replica:
            return False
        if step < self.at_step or self.fired:
            return False
        if self.once_marker is not None and self.once_marker.exists():
            return False
        self.fired = True
        if self.once_marker is not None:
            self.once_marker.parent.mkdir(parents=True, exist_ok=True)
            self.once_marker.touch()
        events_lib.emit(evs.FAULT_INJECTED, mode=self.mode, step=int(step),
                        replica=name)
        return True

    def on_batch_end(self, model, step, logs):
        if self.mode == "replica_kill":
            return  # fleet-driven (should_kill_replica), not training-driven
        if self.mode == "kill_during_refresh":
            return  # refresh-driven (fire_refresh_kill), not step-driven
        if self.mode == "slow_steps":
            # Persistent degradation: every step from at_step on runs
            # slow_seconds late. Never sets `fired` (a straggler keeps
            # straggling); a pre-existing once-marker still disarms it.
            if step < self.at_step:
                return
            marker = self._marker_path()
            if marker is not None and marker.exists():
                return
            if self.rank is not None and rank_world()[0] != self.rank:
                return
            if not self._slow_announced:
                self._slow_announced = True
                events_lib.emit(evs.FAULT_INJECTED, mode=self.mode,
                                step=int(step),
                                slow_seconds=self.slow_seconds)
            time.sleep(self.slow_seconds)
            return
        if step < self.at_step or not self._armed():
            return
        self.fired = True
        marker = self._marker_path()
        if marker is not None:
            marker.parent.mkdir(parents=True, exist_ok=True)
            marker.touch()
        events_lib.emit(evs.FAULT_INJECTED, mode=self.mode, step=int(step))
        if self.mode in ("kill", "buddy_kill"):
            self._flight_dump(step)
            os._exit(self.exit_code)
        elif self.mode == "hang":
            # Frozen, not dead: exit-code monitoring sees nothing; only the
            # launcher's heartbeat liveness probe can.
            signal.raise_signal(signal.SIGSTOP)
        elif self.mode == "slow_heartbeat":
            # Alive and schedulable but making no progress — the fit loop
            # (and with it launch.heartbeat()) stalls inside this sleep.
            time.sleep(self.hang_seconds)
        elif self.mode == "corrupt_checkpoint":
            corrupt_latest_checkpoint(self.directory)
            self._flight_dump(step)
            os._exit(self.exit_code)

    def _flight_dump(self, step):
        """Injected deaths leave the black box behind: dump the flight
        ring (the last N step records) before ``os._exit``, which skips
        every Python-level cleanup — so the dump IS the only record of
        the final seconds. Never blocks the kill (dump() swallows
        errors; no-op without a configured dump location)."""
        from ..obs import flight as obs_flight

        obs_flight.dump(reason=f"fault:{self.mode}", step=int(step))
