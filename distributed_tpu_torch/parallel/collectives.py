"""The collectives of a sharded leaf, owned by the port.

The JAX package shards a leaf with a ``NamedSharding`` and lets GSPMD
insert the all-gathers and reduce-scatters; here they are explicit,
over the default ``torch.distributed`` group (NCCL on the card, gloo on
the CPU), one process per card.

A sharded leaf is described by its :class:`Layout`: the full shape, the
dimension it is split on and this rank's block, the contiguous index
range ``[r*b, (r+1)*b)`` of that dimension (the block JAX's
``NamedSharding`` puts on device r). A parameter stored sharded carries
its layout as an attribute (:func:`mark`, read by :func:`layout_of`), so
a layer that reads it (``nn.core.Layer._compute_leaf``) knows to gather
it.

- :func:`gather` is the gather along the shard dimension as an
  ``autograd.Function``: the forward all-gathers the blocks into an
  ``(N, ...)`` buffer and moves that axis to the shard dimension; the
  backward reduce-scatters the cotangent's blocks, a sum, so each rank
  gets the gradient of its own block summed over the ranks.
- :func:`start_gather` is its asynchronous form, for the scanned stack's
  one-layer-ahead gather (``Strategy.overlap_spec``): the collective is
  issued with ``async_op=True`` and :meth:`Pending.wait` waits for it
  before the result is used. On the card NCCL runs it on its own stream
  and records the buffer there, so the caching allocator cannot hand the
  buffer out while the gather still writes it; ``wait`` makes the compute
  stream wait for the gather's end.
- A slice of a stacked leaf that is sharded on its stacked axis lives on
  one rank whole: its "gather" is a broadcast from that rank, whose
  backward sums the cotangents onto it (:func:`start_owner_copy`).
- :func:`gather_full` and :func:`all_gather_blocks` gather without
  autograd (exports, checkpoints, ZeRO-1's updated blocks).

Every buffer is flat: gloo takes the concatenated form of
``all_gather_into_tensor``/``reduce_scatter_tensor`` only. A collective
that fails raises; nothing here falls back to a full leaf.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_ATTR = "_dtt_layout"

# The flat-buffer collectives under their current names where the torch
# build has them (older builds name them ``*_into_tensor``/``*_tensor``).
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class Layout(NamedTuple):
    """One rank's block of a sharded leaf: ``shape`` the full shape,
    ``dim`` the shard dimension, ``n`` the number of ranks and ``rank``
    this one."""

    shape: Tuple[int, ...]
    dim: int
    n: int
    rank: int

    @property
    def size(self) -> int:
        """The block's length on the shard dimension."""
        return self.shape[self.dim] // self.n

    @property
    def block_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        s[self.dim] = self.size
        return tuple(s)

    @property
    def starts(self) -> Tuple[int, ...]:
        """The block's offset in the full leaf, per dimension."""
        s = [0] * len(self.shape)
        s[self.dim] = self.rank * self.size
        return tuple(s)

    def index(self, rank: Optional[int] = None) -> tuple:
        """Slices of rank ``rank``'s block (this rank's by default), for a
        full tensor or numpy array."""
        r = self.rank if rank is None else rank
        sl = [slice(None)] * len(self.shape)
        sl[self.dim] = slice(r * self.size, (r + 1) * self.size)
        return tuple(sl)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, as a contiguous tensor of its
        own."""
        return full[self.index()].contiguous().clone()


def mark(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """Record ``layout`` on the stored leaf ``t`` (None: replicated)."""
    setattr(t, _ATTR, layout)
    return t


def layout_of(t) -> Optional[Layout]:
    """The layout a stored leaf was marked with, or None (replicated)."""
    return getattr(t, _ATTR, None)


def _merge(buf: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The full leaf from a flat buffer holding the N blocks in rank
    order: ``(N, ...)``, the N axis moved to the shard dimension."""
    d = layout.dim
    stacked = buf.view((layout.n,) + layout.block_shape)
    if d == 0:
        return stacked.reshape(layout.shape)
    return stacked.movedim(0, d).reshape(layout.shape)


def _split(full: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The N blocks of ``full``, contiguous in rank order, flat."""
    d, n, b = layout.dim, layout.n, layout.size
    s = layout.shape
    blocks = full.reshape(s[:d] + (n, b) + s[d + 1:])
    return blocks.movedim(d, 0).contiguous().reshape(-1)


def _gather_into(x: torch.Tensor, layout: Layout, async_op: bool = False):
    buf = x.new_empty((layout.n * x.numel(),))
    work = _all_gather(buf, x.contiguous().reshape(-1), async_op=async_op)
    return buf, work


def _reduce_scatter(g: torch.Tensor, layout: Layout) -> torch.Tensor:
    out = g.new_empty(layout.block_shape)
    _reduce_scatter_flat(out.view(-1), _split(g, layout),
                         op=dist.ReduceOp.SUM)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        buf, _ = _gather_into(x, layout)
        return _merge(buf, layout)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.layout), None


def gather(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The full leaf from this rank's block ``x`` (differentiable: the
    gradient of ``x`` is its block of the cotangent, summed over the
    ranks)."""
    return _Gather.apply(x, layout)


def gather_leaf(x, layout: Optional[Layout]):
    """:func:`gather` for a sharded leaf; a replicated one as it is."""
    return x if layout is None else gather(x, layout)


class Pending:
    """A gather in flight: :meth:`wait` returns the full leaf."""

    def __init__(self, value, work=None, finish=None):
        self._value, self._work, self._finish = value, work, finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._finish is not None:
            self._value, self._finish = self._finish(self._value), None
        return self._value


class _GatherStart(torch.autograd.Function):
    """Issue the all-gather; the output is the flat buffer the collective
    fills (read only after ``Pending.wait``)."""

    @staticmethod
    def forward(ctx, x, layout, holder):
        ctx.layout = layout
        buf, holder.work = _gather_into(x, layout, async_op=True)
        return buf

    @staticmethod
    def backward(ctx, g):
        lay = ctx.layout
        out = g.new_empty(lay.block_shape)
        _reduce_scatter_flat(out.view(-1), g.contiguous(),
                             op=dist.ReduceOp.SUM)
        return out, None, None


class _Holder:
    work = None


def start_gather(x: torch.Tensor, layout: Optional[Layout]) -> Pending:
    """:func:`gather`, issued now and waited for at ``Pending.wait()``;
    a replicated leaf (``layout`` None) is returned as it is."""
    if layout is None:
        return Pending(x)
    holder = _Holder()
    buf = _GatherStart.apply(x, layout, holder)
    return Pending(buf, holder.work, lambda b: _merge(b, layout))


class _OwnerCopy(torch.autograd.Function):
    """Rank ``owner``'s tensor on every rank (a broadcast); the backward
    sums the cotangents onto the owner. Other ranks pass any tensor of
    theirs as ``x`` (its gradient is zero), so that every rank's backward
    takes part in the reduce."""

    @staticmethod
    def forward(ctx, x, owner, shape, holder):
        ctx.owner = owner
        if dist.get_rank() == owner:
            buf = x.detach().contiguous().clone()
        else:
            buf = x.new_empty(shape)
        holder.work = dist.broadcast(buf, src=owner, async_op=True)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.reduce(g, dst=ctx.owner, op=dist.ReduceOp.SUM)
        return (g if dist.get_rank() == ctx.owner else None), None, None, None


def start_owner_copy(x: torch.Tensor, owner: int,
                     shape: Sequence[int]) -> Pending:
    """Rank ``owner``'s ``x`` (of ``shape``) on every rank, issued now and
    waited for at ``Pending.wait()``."""
    holder = _Holder()
    buf = _OwnerCopy.apply(x, int(owner), tuple(shape), holder)
    return Pending(buf, holder.work)


@torch.no_grad()
def gather_full(block: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The full leaf from this rank's block, without autograd (a
    replicated leaf as it is)."""
    if layout is None:
        return block
    buf, _ = _gather_into(block.detach(), layout)
    return _merge(buf, layout)


@torch.no_grad()
def all_gather_blocks(fulls: Sequence[torch.Tensor],
                      blocks: Sequence[torch.Tensor],
                      layouts: Sequence[Layout]) -> None:
    """Write every rank's block into each full tensor in place: the
    blocks are concatenated into one flat bucket per dtype and
    all-gathered once (ZeRO-1's updated parameters)."""
    groups: dict = {}
    for i, b in enumerate(blocks):
        groups.setdefault(b.dtype, []).append(i)
    for idxs in groups.values():
        flat = torch.cat([blocks[i].reshape(-1) for i in idxs])
        n = layouts[idxs[0]].n
        out = flat.new_empty((n * flat.numel(),))
        _all_gather(out, flat)
        per_rank = out.view(n, flat.numel())
        off = 0
        for i in idxs:
            k = blocks[i].numel()
            lay = layouts[i]
            piece = per_rank[:, off:off + k].reshape(
                (n,) + lay.block_shape)
            d = lay.dim
            merged = (piece.reshape(lay.shape) if d == 0
                      else piece.movedim(0, d).reshape(lay.shape))
            fulls[i].copy_(merged)
            off += k


def leaf_sums(values: List[torch.Tensor],
              replicated: Sequence[bool]) -> List[torch.Tensor]:
    """Per-leaf partial sums (0-d tensors, one per leaf of an update's
    list) summed over the ranks, a replicated leaf's counted once (rank
    0's): one all-reduce of the stacked values."""
    t = torch.stack(values)
    if dist.get_rank() != 0 and any(replicated):
        mask = torch.tensor(list(replicated), device=t.device)
        t = torch.where(mask, torch.zeros_like(t), t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return list(t.unbind())


__all__ = [
    "Layout", "Pending", "all_gather_blocks", "gather", "gather_full",
    "gather_leaf", "layout_of", "leaf_sums", "mark", "start_gather",
    "start_owner_copy",
]
