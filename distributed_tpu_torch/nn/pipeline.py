"""Pipeline parallelism: ``PipelinedBlocks``, as the JAX package's ``nn/pipeline.py``.

S structurally identical, shape-preserving, stateless blocks with their
leaves stacked (S, ...) under ``pipelined_blocks/blocks/...``, as
``ScannedBlocks`` stacks them (this class is one, with the role hint
``{"blocks": "pipe"}``). Off a live pipe line the stack runs as
``ScannedBlocks``' sequential scan (the same numerics, and its stacked
``decode``/paged hooks, so the Engine serves it).

Under a strategy with a pipe line of n > 1 ranks (``DataPipelineParallel``
or ``CompositeParallel``), the strategy stores each rank's S/n
consecutive blocks (dim 0 of every stacked leaf) and the forward runs the
JAX schedule as one process per rank:

- **GPipe**: this rank's rows split into M microbatches; M + n - 1 ticks;
  at tick t rank 0 takes microbatch ``min(t, M-1)``, every other rank
  what arrived from its left neighbour, runs its blocks and passes the
  result on (``collectives.ppermute`` along ``[(j, j+1)]``). The last
  rank's ticks n-1 .. M+n-2 hold the M outputs, which ``reduce_from_group``
  publishes to every pipe rank (the head and the loss run on each). The
  input goes in through ``copy_to_group``, so the embedding's gradient
  (only rank 0's is non-zero) is summed onto every pipe rank, as the JAX
  ``shard_map`` transpose sums it.
- **Interleaved** (``interleave=v``): rank r holds the v chunks ``j*n + r``
  of ``S/(n*v)`` blocks (the JAX block permutation, applied by one
  exchange of the stage chunks a step, ``collectives.move_chunks``, whose
  backward sends their gradients home); every microbatch circulates v
  laps over the ring ``[(j, (j+1) % n)]`` and rank 0 banks the
  wrap-around arrivals for their next lap; v*M + n - 1 ticks.

Each tick's hop is the carried ``recv`` of the next: the selection between
the injected microbatch and ``recv`` keeps ``recv`` in every rank's graph,
so the backward's hops form one chain, issued in the same order on every
rank. A rank runs its blocks only on the ticks of its active window: the
JAX schedule's bubble ticks compute on values that no output reads, and
their gradients are zero, so skipping them changes no number. Dropout's
stage keys are ``split(rng, S)`` (permuted under interleave), each folded
with the tick (``fold_in(key, t)``), as in JAX; each tick's masks are
drawn at the microbatch's local shape (``nn.core.local_draw_scope``), as
in the JAX schedule's ``shard_map`` body.

``decode`` on a stack split over a pipe line runs the JAX ring decode:
each rank keeps its S/n blocks' caches, the token's activation visits the
ranks in order (rank i runs its blocks at hop i) and the result is
published from rank 0. The paged hooks raise there (the pool's allocator
assumes one address space), and a cacheless stack raises, as in JAX.
``last_pipeline_trace()`` records the schedule of the last live forward.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from .core import Layer, current_rng, local_draw_scope, rng_scope
from .scan import ScannedBlocks, _tree_leaves, _tree_map
from ..obs import spans as obs_spans
from ..parallel import collectives
from ..parallel.collectives import layout_of
from ..utils import threefry

_pipeline_trace = threading.local()


def last_pipeline_trace() -> Optional[dict]:
    """``{"schedule", "interleave", "num_stages", "num_microbatches",
    "ticks", "bubble_fraction"}`` of the most recent live pipelined
    forward on this thread, or None before any (the sequential path has
    no schedule)."""
    return getattr(_pipeline_trace, "record", None)


def clear_pipeline_trace() -> None:
    _pipeline_trace.record = None


def _live_pipe_line(strategy):
    """``(n, rank, group, axis)`` of the strategy's pipe line when it has
    more than one rank, else None (the JAX ``_live_pipe_mesh``)."""
    axis = getattr(strategy, "pipe_axis", None)
    sizes = getattr(strategy, "axis_sizes", {})
    if axis is None or sizes.get(axis, 1) <= 1:
        return None
    n, rank, group = strategy._axis_line(axis)
    return n, rank, group, axis


class PipelinedBlocks(ScannedBlocks):
    """S stacked blocks pipelined over the pipe line (module docstring).
    ``block_fn()`` returns a fresh, shape-preserving, stateless ``Layer``
    of the same structure at each call; ``schedule`` "gpipe" or
    "interleaved" (with ``interleave`` >= 2 virtual chunks a rank)."""

    _stack_options = {"require_stateless": True,
                      "container": "PipelinedBlocks"}

    def __init__(self, block_fn: Callable[[], Layer], num_blocks: int, *,
                 schedule: str = "gpipe", interleave: int = 1,
                 name: Optional[str] = None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if schedule not in ("gpipe", "interleaved"):
            raise ValueError(
                f"schedule must be 'gpipe' or 'interleaved', got {schedule!r}")
        v = int(interleave)
        if schedule == "gpipe" and v != 1:
            raise ValueError(
                "interleave only applies to schedule='interleaved' "
                f"(got interleave={v} with schedule='gpipe')")
        if schedule == "interleaved" and v < 2:
            raise ValueError(
                "schedule='interleaved' needs interleave >= 2 "
                f"(interleave=1 IS the GPipe schedule), got {v}")
        super().__init__(block_fn, num_blocks, overlap="off", name=name)
        self.schedule = schedule
        self.interleave = v

    def default_name(self) -> str:
        return "pipelined_blocks"

    def sharding_hints(self):
        # A role at container level: the whole stacked subtree splits its
        # stage axis over the pipe line.
        return {"blocks": "pipe"}

    @staticmethod
    def _resident(stacked) -> bool:
        # A one-rank pipe line holds the whole stack.
        return all(layout_of(t) is None or layout_of(t).n == 1
                   for t in stacked)

    def _split_line(self):
        """``(n, rank, group, axis)`` when the stacked leaves are stored
        split over a pipe line of n > 1 ranks, else None."""
        lay = layout_of(self._stacked()[0])
        if lay is None or lay.dim != 0 or lay.n == 1:
            return None
        return lay.n, lay.rank, lay.group, lay.axis

    # ------------------------------------------------------------- forward
    def forward(self, x):
        from ..parallel.strategy import current_strategy

        strategy = current_strategy()
        line = _live_pipe_line(strategy)
        if line is None or self._split_line() is None:
            return super().forward(x)
        with obs_spans.span("pipeline_schedule"):
            return self._schedule(x, strategy, line)

    def _run(self, h, blocks, keys):
        """``h`` through ``blocks`` (each a list of its leaves), block i
        under ``keys[i]``; the carry cast back to ``h``'s dtype."""
        for i, leaves in enumerate(blocks):
            with rng_scope(None if keys is None else keys[i]), \
                    self._swapped(leaves):
                y = self.block(h)
            h = y.to(h.dtype)
        return h

    def _chunks(self, leaves, n, rank, v, group):
        """This rank's v laps' chunks of every stacked leaf (lap j: the
        original chunk ``j*n + rank``), moved from the ranks that store
        them: one exchange per dtype."""
        routes = [((j * n + r) // v, (j * n + r) % v, r, j)
                  for r in range(n) for j in range(v)]
        out = [None] * len(leaves)
        by_dtype = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[i].reshape(v, -1) for i in idx], 1)
            moved = collectives.move_chunks(flat, routes, group)
            sizes = [leaves[i][0].numel() * leaves[i].shape[0] // v
                     for i in idx]
            for i, part in zip(idx, moved.split(sizes, 1)):
                out[i] = part.reshape(leaves[i].shape)
        return out

    def _schedule(self, x, strategy, line):
        n, rank, group, axis = line
        v, s = self.interleave, self.num_blocks
        if s % (n * v):
            raise ValueError(
                f"{s} blocks not divisible by {axis}={n} stages"
                + (f" x interleave={v} virtual chunks" if v > 1 else ""))
        n_data = int(strategy.num_replicas_in_sync)
        m = int(getattr(strategy, "num_microbatches", n))
        b_local = x.shape[0]
        b_global = b_local * n_data
        if b_global % (n_data * m):
            raise ValueError(
                f"batch {b_global} not divisible by data shards ({n_data}) "
                f"x microbatches ({m})")
        if v > 1 and m < n:
            raise ValueError(
                f"interleaved schedule needs num_microbatches >= stages "
                f"(got M={m} < n={n}): a microbatch re-enters rank 0 for "
                f"its next lap M-n ticks after it left, which must not be "
                f"in the past")
        mb = b_local // m
        ticks = v * m + n - 1
        _pipeline_trace.record = {
            "schedule": self.schedule, "interleave": v, "num_stages": n,
            "num_microbatches": m, "ticks": ticks,
            "bubble_fraction": round((n - 1) / ticks, 6),
        }
        per = s // n  # blocks a rank holds
        cs = per // v  # blocks a chunk
        leaves = self._stacked()
        order = np.arange(s)
        if v > 1:
            leaves = self._chunks(leaves, n, rank, v, group)
            order = np.concatenate([
                np.arange((j * n + r) * cs, (j * n + r + 1) * cs)
                for r in range(n) for j in range(v)])
        cols = [torch.unbind(t, 0) for t in leaves]
        blocks = [[c[i] for c in cols] for i in range(per)]
        rng = current_rng()
        keys = None
        if rng is not None:
            every = threefry.split(rng, s)
            keys = [every[int(i)] for i in order[rank * per:(rank + 1) * per]]

        dev = x.device
        first = torch.tensor(rank == 0, device=dev)
        last = torch.tensor(rank == n - 1, device=dev)
        x = collectives.copy_to_group(x, group)
        mbs = x.reshape((m, mb) + tuple(x.shape[1:]))
        recv = torch.zeros_like(mbs[0])
        ring = ([(j, j + 1) for j in range(n - 1)] if v == 1
                else [(j, (j + 1) % n) for j in range(n)])
        bank = [torch.zeros_like(mbs[0]) for _ in range(m)]
        # Every rank's hops join its backward (``ppermute``'s anchor).
        anchor = (leaves[0].reshape(-1)[:0] if torch.is_grad_enabled()
                  else None)
        ys = []
        for t in range(ticks):
            u = t - rank
            if v == 1:
                inj, lap = mbs[min(t, m - 1)], 0
            else:
                # Arrivals at rank 0 are banked for their next lap.
                bank[(t - n) % m] = recv
                lap, mbi = min(max(u // m, 0), v - 1), u % m
                inj = mbs[mbi] if lap == 0 else bank[mbi]
            h = torch.where(first, inj, recv)
            if 0 <= u < v * m:
                part = blocks[lap * cs:(lap + 1) * cs]
                kt = (None if keys is None else
                      [threefry.fold_in(k, t)
                       for k in keys[lap * cs:(lap + 1) * cs]])
                with local_draw_scope():  # a shard_map body in JAX
                    y = self._run(h, part, kt)
            else:
                y = h  # a bubble tick: no output reads it
            ys.append(y)
            if t + 1 < ticks:
                recv = collectives.ppermute(y, ring, group, anchor)
        outs = torch.cat(ys[(v - 1) * m + n - 1:], 0)
        return collectives.reduce_from_group(
            torch.where(last, outs, torch.zeros_like(outs)), group)

    # ------------------------------------------------------ incremental decode
    def _no_paged_on_pipe_mesh(self):
        from ..parallel.strategy import current_strategy

        line = _live_pipe_line(current_strategy()) or self._split_line()
        if line is not None:
            raise NotImplementedError(
                "PipelinedBlocks paged serving is single-device only: the "
                "paged pool's allocator/prefix/copy-on-write state is "
                "host-side and assumes one pool address space, which a "
                f"{line[3]}-sharded stack would split across ranks — "
                "serve this model OFF the pipe mesh (the sequential path "
                "supports the full paged engine)")

    def init_cache(self, batch, max_len, dtype, device):
        line = self._split_line()
        if line is None:
            return super().init_cache(batch, max_len, dtype, device)
        per = self.num_blocks // line[0]
        with torch.no_grad(), self._swapped(self._slices()[0]):
            c0 = self.block.init_cache(batch, max_len, dtype, device)
        if not list(_tree_leaves(c0)):
            return {}
        return {"blocks": _tree_map(
            lambda l: l.expand((per,) + tuple(l.shape)).clone(), c0)}

    def decode(self, cache, x, *, pos):
        line = self._split_line()
        if line is None:
            return super().decode(cache, x, pos=pos)
        n, rank, group, axis = line
        if self.num_blocks % n:
            raise ValueError(
                f"{self.num_blocks} blocks not divisible by {axis}={n} "
                "stages")
        if not list(_tree_leaves(cache)):
            raise ValueError(
                "PipelinedBlocks.decode on a live pipe mesh needs a "
                "per-block cache (the template block's init_cache "
                "returned nothing) — a cacheless stack would scan the "
                "pipe-sharded params and all-gather the full stack on "
                "every rank; decode off the pipe mesh instead")
        stacked = cache["blocks"]
        ring = [(j, (j + 1) % n) for j in range(n)]
        h = x
        for i in range(n):
            if i == rank:  # rank i holds the true activation at hop i
                for b, leaves in enumerate(self._slices()):
                    with self._swapped(leaves):
                        y, _ = self.block.decode(
                            _tree_map(lambda l: l[b], stacked), h, pos=pos)
                    h = y.to(h.dtype)
            h = collectives.ppermute(h, ring, group)
        out = torch.where(torch.tensor(rank == 0, device=h.device), h,
                          torch.zeros_like(h))
        return collectives.reduce_from_group(out, group), cache

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        self._no_paged_on_pipe_mesh()
        return super().init_paged_cache(num_blocks, block_size, dtype,
                                        device)

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        self._no_paged_on_pipe_mesh()
        return super().paged_decode(
            cache, x, block_tables=block_tables, positions=positions,
            decode_kernel=decode_kernel)

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        self._no_paged_on_pipe_mesh()
        return super().paged_verify(
            cache, x, block_tables=block_tables, positions=positions,
            decode_kernel=decode_kernel)

    def paged_prefill(self, cache, x, *, block_table, start):
        self._no_paged_on_pipe_mesh()
        return super().paged_prefill(cache, x, block_table=block_table,
                                     start=start)

    def extra_repr(self) -> str:
        return (f"num_blocks={self.num_blocks}, schedule={self.schedule!r}, "
                f"interleave={self.interleave}")


__all__ = ["PipelinedBlocks", "clear_pipeline_trace", "last_pipeline_trace"]
