"""Preemption-aware training: catch SIGTERM, checkpoint, exit resumable.

The port's counterpart of the JAX package's ``resilience/preemption.py``.
Clusters deliver maintenance and preemption as SIGTERM with a short grace
window; the reference's only answer is "Workers will need to restart
training if any fails", losing all progress. A :class:`PreemptionHandler`
callback turns the signal into: flush every background checkpoint write,
save a final checkpoint, write a resume marker, dump the flight recorder,
and exit with :data:`PREEMPTED_EXIT_CODE`, which the supervisor recognizes
as a clean preemption (restarted without spending the failure budget, see
``resilience.policy``). The relaunched run's ``ModelCheckpoint(dir,
restore=True)`` then resumes from that exact step.

The signal handler itself only sets a flag (the only async-signal-safe
thing to do from Python); all real work happens at a batch boundary on
the normal Python stack.

In a gang (a process group of world > 1) the ranks agree on the step
before any of them saves, because the final save is collective (the
sharded commit's all-reduces, FSDP's gathers): a rank signalled one step
before its peers would otherwise enter the save while they run the next
step's gradient all-reduce, and the two collectives would meet. Each batch
end every rank starts one MAX all-reduce of its flag on a CPU group (the
default group under gloo, a gloo group beside NCCL), and reads the
previous batch end's result; when any rank was signalled, all of them
stop at the same batch end, one dispatch after the first signal. The
vote is host-side and read one dispatch late, so it never waits for the
card. Without a gang the handler stops at the batch end that sees its
own flag, as the JAX handler does.
"""

from __future__ import annotations

import signal
import sys
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..training.callbacks import Callback
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import logging as dlog

# The supervisor's half (exit code and resume-marker I/O) lives in
# markers.py; re-exported here for the worker-side API surface.
from .markers import (  # noqa: F401
    PREEMPTED_EXIT_CODE,
    RESUME_MARKER,
    clear_resume_marker,
    marker_path,
    read_resume_marker,
    write_resume_marker,
)


class PreemptionHandler(Callback):
    """Callback: graceful stop on SIGTERM (and any extra ``signals``).

    ``directory``: where the final checkpoint and resume marker go (shared
    with the run's ``ModelCheckpoint`` so the relaunch restores it; pass
    that callback's ``ckpt`` as ``checkpointer`` under ``sharded=True``).
    ``exit_code``: the process's exit code after the final checkpoint,
    :data:`PREEMPTED_EXIT_CODE` by default so a supervisor restarts for
    free. ``exit_code=None`` stops in-process instead (``fit`` returns
    early mid-epoch). In a gang every rank stops at the same batch end
    (module docstring).
    """

    def __init__(self, directory, *, signals=(signal.SIGTERM,),
                 exit_code: Optional[int] = PREEMPTED_EXIT_CODE,
                 keep: int = 3, checkpointer: Optional[Checkpointer] = None):
        self.directory = Path(directory)
        self.ckpt = checkpointer or Checkpointer(directory, keep=keep)
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self._flag = False
        self._prev = {}
        self.triggered = False  # post-hoc: did a preemption stop this run?
        self._group_ref = None  # the vote's CPU group (gang only), weakly
        self._vote = None
        self._work = None  # the vote started at the previous batch end

    # -- signal plumbing ----------------------------------------------------
    def _on_signal(self, signum, frame):
        # Async-signal context: set the flag and nothing else.
        self._flag = True

    def _install(self):
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)

    def _uninstall(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # non-main thread / closed interp
                pass
        self._prev = {}

    # -- the gang's vote ----------------------------------------------------
    def _vote_group(self):
        """Set the CPU group the flags are voted over (None without a
        gang). Every rank calls this at train begin (a new group is
        collective). The group is held weakly, as a strategy holds its
        groups (``parallel.collectives``), so ``cluster.shutdown()``
        destroys it; a later gang votes over a group of its own."""
        if not dist.is_initialized() or dist.get_world_size() < 2:
            self._group_ref = None
        elif self._group is None:
            self._group_ref = weakref.ref(
                dist.group.WORLD if dist.get_backend() == "gloo"
                else dist.new_group(backend="gloo"))

    @property
    def _group(self):
        return None if self._group_ref is None else self._group_ref()

    def _stop_now(self) -> bool:
        """Whether every rank stops at this batch end (module docstring)."""
        flag, self._flag = self._flag, False
        if self._group is None:
            return flag
        stop = False
        if self._work is not None:
            self._work.wait()
            stop = bool(int(self._vote.item()))
            self._work = None
        if not stop:
            self._vote = torch.tensor([int(flag)], dtype=torch.int32)
            self._work = dist.all_reduce(self._vote, op=dist.ReduceOp.MAX,
                                         group=self._group, async_op=True)
        return stop

    def _drain_vote(self):
        if self._work is not None:
            self._work.wait()
            self._work = None

    # -- callback hooks -----------------------------------------------------
    def on_train_begin(self, model):
        self._flag = False
        self.triggered = False
        self._work = None
        self._vote_group()
        self._install()

    def on_batch_end(self, model, step, logs):
        if not self._stop_now():
            return
        self.triggered = True
        from ..checkpoint.core import _is_chief, wait_all_async

        # Flush ordering (the preemption contract with async checkpointing):
        # (1) every in-flight background write, e.g. the run's
        # ModelCheckpoint(async_save=True) writer, lands first, so an older
        # step can never finish after (and point `latest` away from) the
        # preemption save; (2) the final save runs; (3) its own writer is
        # flushed, so exit 75 never abandons a half-written final
        # checkpoint.
        wait_all_async()
        self.ckpt.save(model, step=step)
        self.ckpt.wait()
        if _is_chief():
            write_resume_marker(self.directory, step)
            dlog.warning(
                f"PreemptionHandler: caught stop signal; checkpointed step "
                f"{step} and "
                + (f"exiting with code {self.exit_code}" if self.exit_code
                   is not None else "stopping training in-process")
            )
            events_lib.emit(evs.PREEMPTED, step=int(step),
                            exit_code=self.exit_code)
        if self.exit_code is not None:
            self._uninstall()
            # The black box before death: the last N step records land
            # next to the event log (a no-op unless a dump location is
            # configured).
            from ..obs import flight as obs_flight

            obs_flight.dump(reason="preempted", step=int(step))
            # sys.exit, not os._exit: SystemExit unwinds the stack so log
            # handles flush and the launcher's result file (if any) stays
            # consistent; fit() is abandoned by design.
            sys.exit(self.exit_code)
        model.stop_training = True  # fit() breaks at this batch boundary

    def on_train_end(self, model, history):
        self._drain_vote()
        self._uninstall()
