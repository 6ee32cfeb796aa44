"""Device prefetch: overlap host batch prep and the host-to-device copy
with compute.

:class:`DevicePrefetcher` is the JAX package's (``data/prefetch.py``,
copied and adapted): a bounded background producer stages the batch of
dispatch N+1 while dispatch N runs, so the train loop's per-dispatch input
cost is a queue pop. Batches come from ONE thread, in order, from the same
source cursor the synchronous loop advances, so the staged stream is
bit-identical to the unprefetched one at any depth. ``sizes`` fixes every
dispatch's size up front, so a finished epoch consumes exactly
``sum(sizes)`` source steps; an early stop leaves up to ``depth + 1``
staged dispatches unconsumed, and :attr:`unconsumed_steps` says how many
source steps those held, so a seekable source (``data.Pipeline``) can be
rewound to the step actually trained.

:class:`DeviceStager` is the port's placement: on the card a batch is
copied into a pinned host buffer, then to the device with
``non_blocking=True`` on a side stream, and an event marks the copy's end.
The consumer's stream waits on that event (``StagedBatch.tensors``), so
the copy overlaps the step before it; a pinned buffer is written again
only after its last copy's event has completed. On the CPU a batch is
handed on as it is.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Sequence

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "DeviceStager", "StagedBatch"]

_POLL_S = 0.05  # producer/consumer wake-up period for stop/error checks
# Pinned buffers a DeviceStager keeps per name: the batch being filled,
# the prefetch queue's two and the one the card is copying.
RING = 4


class DevicePrefetcher:
    """Bounded background producer of device-staged batches.

    Args:
      stage: ``stage(k) -> staged_batch`` — prepares ``k`` source steps'
        worth of host data and starts its device placement. Runs on the
        producer thread (or inline when ``depth == 0``); it must not wait
        on the device's compute (no fetches, no collectives).
      sizes: the exact sequence of per-dispatch sizes this prefetcher will
        serve, in order (``[1, 1, ...]`` for the plain loop, ``[K, ...,
        tail]`` under ``steps_per_execution=K``).
      depth: how many staged dispatches may be ready ahead of the consumer
        (2 double-buffers). ``0`` runs no thread: ``get()`` stages inline,
        the synchronous path.
    """

    def __init__(self, stage: Callable, sizes: Sequence[int], depth: int = 2):
        self._stage = stage
        self._sizes = [int(k) for k in sizes]
        self._depth = max(0, int(depth))
        self._served = 0  # dispatches handed to the consumer
        self._produced_steps = 0  # source steps pulled by the producer
        self._served_steps = 0
        self._error = None
        self._stop = threading.Event()
        self._q = None
        self._thread = None
        if self._depth > 0 and len(self._sizes) > 1:
            self._q = queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._run, name="dtpu-prefetch", daemon=True)
            self._thread.start()

    def _run(self):
        try:
            for k in self._sizes:
                if self._stop.is_set():
                    return
                item = self._stage(k)
                # Counted at stage time, queued or not: these source steps
                # are gone from the stream either way.
                self._produced_steps += k
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as e:  # surfaced to the consumer in get()
            self._error = e

    def get(self):
        """The next staged dispatch as ``(k, staged_batch)``. Blocks until
        the producer has it ready; re-raises any producer-side exception
        with its original type."""
        if self._served >= len(self._sizes):
            raise IndexError("prefetcher exhausted: all dispatches served")
        k = self._sizes[self._served]
        if self._thread is None:  # depth 0 / single dispatch: synchronous
            if self._error is None:
                try:
                    item = self._stage(k)
                    self._produced_steps += k
                except BaseException as e:
                    self._error = e
            if self._error is not None:
                raise self._error
        else:
            while True:
                try:
                    item = self._q.get(timeout=_POLL_S)
                    break
                except queue.Empty:
                    if self._error is not None:
                        raise self._error
                    if not self._thread.is_alive() and self._q.empty():
                        raise RuntimeError(
                            "prefetch producer exited without staging the "
                            "requested dispatch")
        self._served += 1
        self._served_steps += k
        return k, item

    @property
    def unconsumed_steps(self) -> int:
        """Source steps staged (or in staging) but never served: nonzero
        only after an early ``close()``."""
        return self._produced_steps - self._served_steps

    def close(self, join_timeout: float = 10.0):
        """Idempotent shutdown: stop the producer, drain staged items, and
        join the thread. Never raises."""
        self._stop.set()
        if self._thread is not None:
            while True:  # unblock a producer stuck in q.put
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=join_timeout)
        if self._q is not None:
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StagedBatch:
    """A batch on its way to the device: ``tensors`` makes the caller's
    current stream wait for the copy (once) and returns ``{name:
    tensor}``."""

    __slots__ = ("_tensors", "_event", "_device")

    def __init__(self, tensors: Dict[str, torch.Tensor], event=None,
                 device=None):
        self._tensors = tensors
        self._event = event
        self._device = device

    @property
    def tensors(self) -> Dict[str, torch.Tensor]:
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            for t in self._tensors.values():
                # The side stream allocated them: their memory must not go
                # back to it while the consumer's stream still reads them.
                t.record_stream(stream)
            self._event = None
        return self._tensors


class DeviceStager:
    """Places host batches on ``device``.

    ``host(name, shape, dtype)`` hands out the buffer to fill with the next
    batch's ``name``: on a CUDA device the next of a ring of ``RING`` pinned
    buffers of that shape and dtype (the host first waits for the copy
    that last read it), on the CPU a new tensor. ``stage({name: filled
    buffer, or a view of it})`` then copies them to the card with
    ``non_blocking=True`` on a side stream and records the batch's event
    after the copies (on the CPU it hands them on). A numpy array given to
    ``stage`` is first written into ``host``'s buffer."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned = {}  # name -> ([buffers], [their last copy's event])
        self._slot = {}  # name -> the slot host() handed out last
        self._stream = None

    def host(self, name: str, shape, dtype) -> torch.Tensor:
        shape = tuple(shape)
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype)
        entry = self._pinned.get(name)
        if entry is None or entry[0][0].shape != shape or (
                entry[0][0].dtype != dtype):
            entry = self._pinned[name] = (
                [torch.empty(shape, dtype=dtype).pin_memory()
                 for _ in range(RING)], [None] * RING)
            self._slot[name] = -1
        slot = self._slot[name] = (self._slot[name] + 1) % RING
        last = entry[1][slot]
        if last is not None:
            last.synchronize()  # its previous copy has read it
        return entry[0][slot]

    def stage(self, batch: Dict[str, object]) -> StagedBatch:
        hosts = {}
        for name, t in batch.items():
            if isinstance(t, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(t))
                buf = self.host(name, t.shape, t.dtype)
                buf.copy_(t)
                t = buf
            hosts[name] = t
        if self.device.type != "cuda":
            return StagedBatch(hosts)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        event = torch.cuda.Event()
        out = {}
        with torch.cuda.stream(self._stream):
            for name, t in hosts.items():
                out[name] = torch.empty(t.shape, dtype=t.dtype,
                                        device=self.device)
                out[name].copy_(t, non_blocking=True)
            event.record(self._stream)
        for name in hosts:
            self._pinned[name][1][self._slot[name]] = event
        return StagedBatch(out, event, self.device)
