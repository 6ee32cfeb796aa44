"""Training callbacks.

The counterpart of the JAX package's ``training/callbacks.py``, with its
classes and hook points (``Model.fit`` calls them). The reference's own
log names what its loop lacks: "ModelCheckpoint callback is not
provided. Workers will need to restart training if any fails";
``ModelCheckpoint`` saves on a schedule and resumes.

Side effects (files, log lines, traces) happen on the chief (rank 0)
only; every rank runs the same control flow, so a callback never puts
the ranks of a ``DataParallel`` run out of step. ``EarlyStopping`` and
``ReduceLROnPlateau`` decide from the epoch's logs, which are reduced
over the ranks before any callback sees them, so every rank decides the
same.
"""

from __future__ import annotations

import inspect
import math
import os
import time
from pathlib import Path

import torch

from ..checkpoint import Checkpointer, ShardedCheckpointer
from ..checkpoint.core import _is_chief, broadcast_ints, flatten_tree
from ..interop import iter_leaf_paths
from ..obs import spans as obs_spans
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import logging as dlog
from ..utils import sync_check
from ..utils.logging import rank_world


class Callback:
    """Hook points around the training loop (all optional)."""

    def on_train_begin(self, model):
        pass

    def on_epoch_begin(self, model, epoch: int):
        pass

    def on_batch_end(self, model, step: int, logs: dict):
        """After each optimizer step. ``logs['loss']`` is a device scalar;
        reading it waits for the step, so a callback that is to cost
        nothing does not read it every step."""

    def on_epoch_end(self, model, epoch: int, logs: dict):
        pass

    def on_train_end(self, model, history):
        pass


class ModelCheckpoint(Callback):
    """Step-tagged checkpoints through a ``Checkpointer``.

    ``save_freq='epoch'`` saves at every epoch's end; an int saves each
    time the step counter crosses a multiple of it. ``restore=True``
    resumes from the newest checkpoint in the directory at train begin (a
    no-op when there is none; under a process group rank 0's directory
    decides), so a crashed run restarts by running the same command again.
    ``async_save=True`` saves in the background (``Checkpointer``); the
    writer is flushed at train end, so ``fit`` never returns with a write
    in flight. Time blocked on restores, saves and the flush goes to the
    active fit's ``checkpoint_wait`` span (``model.last_fit_telemetry``).
    ``sharded=True`` saves through a ``ShardedCheckpointer`` (each rank
    writes its own blocks; the JAX package's directory format), and its
    async commit is deferred to the next save or the train-end flush.

    ``buddy=`` arms the diskless recovery tier (requires ``sharded=True``):
    a ``resilience.BuddyRedundancy``, a ``BuddyStore`` or a path to one,
    or ``True`` to read the supervisor-exported ``DTPU_BUDDY_STORE``.
    Each time the step counter crosses a multiple of
    ``buddy_refresh_every`` the rank mirrors its blocks into the RAM
    store; ``restore=True`` then picks the tier per recovery, decided by
    rank 0 and broadcast: buddy (RAM, zero disk reads) when the mirror
    set is complete and at least as new as the disk's newest step, the
    sharded disk checkpoint otherwise, from scratch with neither. It emits
    ``restore_begin``/``restore_end`` (the tier and the disk blocks read)
    and, at the first step after, ``post_restore_step``, which the
    supervisor's ``recovery`` rows read.
    """

    def __init__(self, directory, *, save_freq="epoch", keep: int = 3,
                 restore: bool = False, sharded: bool = False,
                 async_save: bool = False, buddy=None,
                 buddy_refresh_every: int = 1):
        if buddy is not None and not sharded:
            raise ValueError(
                "buddy= needs sharded=True: the mirror encoding is the "
                "sharded block layout, and the disk fallback tier is "
                "the ShardedCheckpointer")
        if save_freq != "epoch" and not (
                isinstance(save_freq, int) and save_freq > 0):
            raise ValueError("save_freq must be 'epoch' or a positive int")
        cls = ShardedCheckpointer if sharded else Checkpointer
        self.ckpt = cls(directory, keep=keep, async_save=async_save)
        self.save_freq = save_freq
        self.restore = restore
        self._last_bucket = 0  # save_freq bucket already saved (int freq)
        # Imported here: resilience.faults imports this module for the
        # Callback base.
        if buddy is None or buddy is False:
            self._buddy = None
        else:
            from ..resilience.redundancy import BuddyRedundancy

            if buddy is True:
                self._buddy = BuddyRedundancy.from_env()  # None when unset
            elif isinstance(buddy, BuddyRedundancy):
                self._buddy = buddy
            else:  # a BuddyStore or a path
                self._buddy = BuddyRedundancy(buddy)
        if int(buddy_refresh_every) < 1:
            raise ValueError(
                f"buddy_refresh_every must be >= 1, got {buddy_refresh_every}")
        self.buddy_refresh_every = int(buddy_refresh_every)
        self._last_refresh_bucket = 0
        self._post_restore_pending = False  # emit one post_restore_step

    @staticmethod
    def _timed(model, fn):
        """Run a checkpoint operation that may block, in the fit's
        ``checkpoint_wait`` span (its stall timer, when a fit runs)."""
        timer = getattr(model, "_stall_timer", None)
        with obs_spans.span("checkpoint_wait", timer=timer):
            return fn()

    def _select_tier(self):
        """``(tier, step)`` of this recovery, the same on every rank: rank
        0's view of the store and the checkpoint directory decides and is
        broadcast (a split decision would put the ranks' collectives out
        of step)."""
        from ..resilience.redundancy import select_restore_tier

        codes = {"buddy": 0, "disk": 1, "restart": 2}
        tier, step = select_restore_tier(self._buddy, self.ckpt)
        code, got = broadcast_ints([codes[tier],
                                    -1 if step is None else int(step)])
        tier = {v: k for k, v in codes.items()}[code]
        return tier, None if got < 0 else got

    def _restore_tiered(self, model):
        """The buddy-aware restore: pick the tier, restore, and emit the
        events the supervisor's recovery rows read."""
        from ..checkpoint import sharded as sharded_lib

        tier, step = self._select_tier()
        if tier == "restart":
            return  # neither tier has state: train from scratch
        rank = rank_world()[0]
        attempt = os.environ.get("DTPU_ATTEMPT")
        events_lib.emit(evs.RESTORE_BEGIN, tier=tier, rank=rank,
                        attempt=int(attempt) if attempt else None)
        reads0 = dict(sharded_lib.read_stats)
        t0 = time.perf_counter()
        if tier == "buddy":
            step = self._timed(
                model, lambda: self._buddy.restore_into(model, step))
        else:
            # restore_into runs its own corrupt-skip scan; the step it
            # lands on (possibly a fallback) is the one reported.
            step = self._timed(model, lambda: self.ckpt.restore_into(model))
        events_lib.emit(
            evs.RESTORE_END, tier=tier, step=int(step), rank=rank,
            seconds=round(time.perf_counter() - t0, 4),
            disk_block_reads=(sharded_lib.read_stats["block_reads"]
                              - reads0["block_reads"]),
            disk_block_bytes=(sharded_lib.read_stats["block_bytes"]
                              - reads0["block_bytes"]),
            attempt=int(attempt) if attempt else None)
        model._resumed_step = step
        self._post_restore_pending = True
        if _is_chief():
            dlog.info(f"ModelCheckpoint: resumed from step {step} via the "
                      f"{tier} tier")

    def on_train_begin(self, model):
        if self.restore and self._buddy is not None:
            self._restore_tiered(model)
        elif self.restore:
            has_ckpt = self.ckpt.latest_step() is not None
            # Every rank takes rank 0's answer: without a shared file
            # system only it has the files.
            if broadcast_ints([int(has_ckpt)])[0]:
                step = self._timed(model,
                                   lambda: self.ckpt.restore_into(model))
                model._resumed_step = step
                if _is_chief():
                    dlog.info(f"ModelCheckpoint: resumed from step {step}")
        # Saves fire when the step counter crosses a save_freq boundary,
        # counted from the current step (0, a restored cursor, or an
        # earlier fit's).
        if isinstance(self.save_freq, int):
            self._last_bucket = model.step // self.save_freq
        # The refresh cadence follows the same crossing rule.
        if self._buddy is not None:
            self._last_refresh_bucket = model.step // self.buddy_refresh_every

    def on_batch_end(self, model, step, logs):
        if self._post_restore_pending:
            # The first step after a tiered restore: the end of the
            # recovery rows' recompile span.
            self._post_restore_pending = False
            events_lib.emit(evs.POST_RESTORE_STEP, step=int(step),
                            rank=rank_world()[0])
        if self._buddy is not None:
            bucket = step // self.buddy_refresh_every
            if bucket > self._last_refresh_bucket:
                self._last_refresh_bucket = bucket
                # A failed refresh degrades to a warning, never stops
                # training.
                self._buddy.refresh(model, step)
        if not isinstance(self.save_freq, int):
            return
        bucket = step // self.save_freq
        if bucket > self._last_bucket:
            self._last_bucket = bucket
            self._timed(model, lambda: self.ckpt.save(model))

    def on_epoch_end(self, model, epoch, logs):
        if self.save_freq == "epoch":
            self._timed(model, lambda: self.ckpt.save(model))

    def on_train_end(self, model, history):
        # Flush the background writers before fit returns: a run that
        # exits right after leaves a committed newest step and mirror.
        self._timed(model, self.ckpt.wait)
        if self._buddy is not None:
            self._timed(model, self._buddy.wait)
            # The tier's price rides the fit telemetry.
            model._redundancy_report = self._buddy.report(model)


def _metric_mode(monitor: str) -> str:
    """'max' for higher-is-better metric names, else 'min': the auto mode
    of every plateau-style callback."""
    return "max" if ("acc" in monitor or monitor.endswith("auc")) else "min"


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving by
    ``min_delta`` for more than ``patience`` epochs. ``restore_best``
    puts back the parameters and state of the best epoch at train end
    (host copies: the port updates its parameters in place)."""

    def __init__(self, monitor: str = "loss", *, patience: int = 0,
                 min_delta: float = 0.0, mode: str = "auto",
                 restore_best: bool = False):
        self.monitor = monitor
        self.patience = int(patience)
        self.min_delta = abs(float(min_delta))
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto/min/max, got {mode!r}")
        if mode == "auto":
            mode = _metric_mode(monitor)
        self.mode = mode
        self.restore_best = restore_best
        self._best = math.inf if mode == "min" else -math.inf
        self._wait = 0
        self._best_params = None
        self._best_state = None

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self._best - self.min_delta
        return value > self._best + self.min_delta

    def on_epoch_end(self, model, epoch, logs):
        if self.monitor not in logs:
            dlog.warning(
                f"EarlyStopping: metric {self.monitor!r} not in logs "
                f"{sorted(logs)}; skipping")
            return
        value = float(logs[self.monitor])
        if self._improved(value):
            self._best = value
            self._wait = 0
            if self.restore_best:
                self._best_params = flatten_tree(model.params)
                self._best_state = flatten_tree(model.state)
        else:
            self._wait += 1
            if self._wait > self.patience:
                model.stop_training = True
                if _is_chief():
                    dlog.info(
                        f"EarlyStopping: no {self.monitor} improvement for "
                        f"{self._wait} epochs (best {self._best:.4f})")

    def on_train_end(self, model, history):
        if self.restore_best and self._best_params is not None:
            model.load_params(self._best_params)
            model.load_state(self._best_state)


class CSVLogger(Callback):
    """Append each epoch's logs to a CSV file (chief-only), every row
    flushed and fsynced before training goes on, so a run killed mid-epoch
    leaves its finished epochs on disk."""

    def __init__(self, path):
        self.path = Path(path)
        self._keys = None

    def _append_durable(self, text: str):
        with open(self.path, "a") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())

    def on_epoch_end(self, model, epoch, logs):
        if not _is_chief():
            return
        if self._keys is None:
            self._keys = sorted(logs)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if not self.path.exists():
                self._append_durable("epoch," + ",".join(self._keys) + "\n")
        row = [str(epoch)] + [
            repr(float(logs.get(k, float("nan")))) for k in self._keys]
        self._append_durable(",".join(row) + "\n")


class LearningRateScheduler(Callback):
    """Per-epoch learning rate: ``schedule(epoch)`` or ``schedule(epoch,
    current_lr)``, applied through ``Model.set_learning_rate`` at each
    epoch's begin. The arity is read from the signature; only a bare
    ``*args`` signature (an unwrapped decorator) is probed once with two
    arguments, so a TypeError raised inside a two-argument schedule is
    never taken for a wrong arity."""

    def __init__(self, schedule, verbose: int = 0):
        self.schedule = schedule
        self.verbose = int(verbose)
        try:
            kinds = [p.kind for p in
                     inspect.signature(schedule).parameters.values()]
            positional = sum(
                k in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
                for k in kinds)
            two_arg = positional >= 2
            ambiguous = (positional < 2
                         and inspect.Parameter.VAR_POSITIONAL in kinds)
        except (TypeError, ValueError):
            two_arg, ambiguous = False, False
        self._two_arg = two_arg
        self._ambiguous = ambiguous

    def on_epoch_begin(self, model, epoch):
        if self._ambiguous:
            try:
                lr = self.schedule(epoch, model.get_learning_rate())
                self._two_arg = True
            except TypeError:
                lr = self.schedule(epoch)
            self._ambiguous = False
        elif self._two_arg:
            lr = self.schedule(epoch, model.get_learning_rate())
        else:
            lr = self.schedule(epoch)
        model.set_learning_rate(float(lr))
        if self.verbose and _is_chief():
            dlog.info(f"LearningRateScheduler: epoch {epoch + 1} lr={lr:g}")


class ReduceLROnPlateau(Callback):
    """Multiply the learning rate by ``factor`` after ``patience`` epochs
    without ``monitor`` improving by ``min_delta``, then wait ``cooldown``
    epochs. The rate lives in the optimizer state, so it is checkpointed;
    the counters are the process's own and start afresh on a restart (as
    in Keras)."""

    def __init__(self, monitor: str = "loss", *, factor: float = 0.5,
                 patience: int = 3, min_delta: float = 1e-4,
                 min_lr: float = 0.0, cooldown: int = 0, mode: str = "auto",
                 verbose: int = 0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.min_lr = float(min_lr)
        self.cooldown = int(cooldown)
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto/min/max, got {mode!r}")
        self.mode = _metric_mode(monitor) if mode == "auto" else mode
        self.verbose = int(verbose)
        self._best = math.inf
        self._wait = 0
        self._cooling = 0

    def on_train_begin(self, model):
        self._best = math.inf
        self._wait = 0
        self._cooling = 0

    def on_epoch_end(self, model, epoch, logs):
        cur = logs.get(self.monitor)
        if cur is None:
            dlog.warning(
                f"ReduceLROnPlateau: metric {self.monitor!r} not in logs "
                f"({sorted(logs)})")
            return
        # Max-mode metrics are negated, so the test is always a minimum;
        # the best is tracked through the cooldown too (Keras).
        val = (-1.0 if self.mode == "max" else 1.0) * float(cur)
        improved = val < self._best - self.min_delta
        if improved:
            self._best = val
        if self._cooling > 0:
            self._cooling -= 1
            self._wait = 0
            return
        if improved:
            self._wait = 0
            return
        self._wait += 1
        if self._wait < self.patience:
            return
        old = model.get_learning_rate()
        new = max(old * self.factor, self.min_lr)
        if new < old:
            model.set_learning_rate(new)
            if self.verbose and _is_chief():
                dlog.info(
                    f"ReduceLROnPlateau: {self.monitor} plateaued "
                    f"{self.patience} epochs; lr {old:g} -> {new:g}")
        self._wait = 0
        self._cooling = self.cooldown


class TensorBoard(Callback):
    """Each epoch's logs and the learning rate as TensorBoard scalars,
    chief-only, through ``torch.utils.tensorboard``. It is imported on the
    chief at train begin, so a worker without the ``tensorboard`` package
    can still construct the callback."""

    def __init__(self, log_dir):
        self.log_dir = str(log_dir)
        self._writer = None

    def on_train_begin(self, model):
        if not _is_chief():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "callbacks.TensorBoard needs the tensorboard package for "
                "event-file writing (CSVLogger is the dependency-free "
                "alternative)") from e
        self._writer = SummaryWriter(self.log_dir)

    def on_epoch_end(self, model, epoch, logs):
        if self._writer is None:
            return
        for key, value in logs.items():
            self._writer.add_scalar(key, float(value), epoch)
        self._writer.add_scalar("learning_rate", model.get_learning_rate(),
                                epoch)
        self._writer.flush()

    def on_train_end(self, model, history):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class LambdaCallback(Callback):
    """Ad-hoc hooks without subclassing."""

    def __init__(self, on_train_begin=None, on_epoch_begin=None,
                 on_batch_end=None, on_epoch_end=None, on_train_end=None):
        self._hooks = {
            "on_train_begin": on_train_begin,
            "on_epoch_begin": on_epoch_begin,
            "on_batch_end": on_batch_end,
            "on_epoch_end": on_epoch_end,
            "on_train_end": on_train_end,
        }

    def __getattribute__(self, name):
        if name.startswith("on_"):
            hook = object.__getattribute__(self, "_hooks").get(name)
            if hook is not None:
                return hook
        return object.__getattribute__(self, name)


class ProfilerCallback(Callback):
    """A ``torch.profiler`` trace of steps ``start_step + 1`` to
    ``start_step + num_steps`` (the profiler starts after step
    ``start_step``), chief-only, written as a Chrome trace to
    ``logdir/trace.json`` (the card's kernels too on a CUDA model)."""

    def __init__(self, logdir, *, start_step: int = 10, num_steps: int = 5):
        self.logdir = Path(logdir)
        self.start_step = int(start_step)
        self.stop_step = int(start_step) + int(num_steps)
        self._prof = None

    def on_batch_end(self, model, step, logs):
        if not _is_chief():
            return
        if self._prof is None and self.start_step <= step < self.stop_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if model.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and step >= self.stop_step:
            self._stop()

    def _stop(self):
        self._prof.stop()
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.logdir / "trace.json"))
        self._prof = None

    def on_train_end(self, model, history):
        if self._prof is not None:
            self._stop()


class SyncCheck(Callback):
    """Check at the end of every ``every``-th epoch that each parameter
    (and the state; the optimizer state with ``include_opt_state``) is
    bit-identical on every rank of the group: the synchronous
    data-parallel invariant, checked during training. Every rank must run
    it (it is a collective); a divergence raises AssertionError naming the
    first leaf that differs, after a ``sync_check_failed`` event."""

    def __init__(self, every: int = 1, include_opt_state: bool = False):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = int(every)
        self.include_opt_state = bool(include_opt_state)

    def on_epoch_end(self, model, epoch, logs):
        if (epoch + 1) % self.every:
            return
        try:
            sync_check.assert_replicas_identical(model.params, "params")
            sync_check.assert_replicas_identical(model.state, "state")
            if self.include_opt_state:
                tree = model._opt_tree("full")
                sync_check.assert_replicas_identical(
                    {p: torch.as_tensor(v) for p, v in iter_leaf_paths(tree)},
                    "opt_state")
        except AssertionError as e:
            # The run still fails; the event log names the drifted leaf
            # first, as the JAX callback's does.
            events_lib.emit(evs.SYNC_CHECK_FAILED, epoch=int(epoch),
                            step=int(model.step), error=str(e))
            raise


__all__ = [
    "CSVLogger", "Callback", "EarlyStopping", "LambdaCallback",
    "LearningRateScheduler", "ModelCheckpoint", "ProfilerCallback",
    "ReduceLROnPlateau", "SyncCheck", "TensorBoard",
]
