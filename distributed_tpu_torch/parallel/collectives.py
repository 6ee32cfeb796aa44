"""The collectives of a sharded leaf, owned by the port.

The JAX package shards a leaf with a ``NamedSharding`` and lets GSPMD
insert the all-gathers and reduce-scatters; here they are explicit,
over a ``torch.distributed`` group (NCCL on the card, gloo on the CPU),
one process per card: the default group, or the group of a mesh axis
(``Layout.group``, e.g. the ``"model"`` line of a data x model mesh).

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

Tensor and sequence parallelism add the differentiable collectives the
JAX package gets from GSPMD and ``shard_map``:

- Megatron's pair over the model group (Shoeybi et al., 2019):
  :func:`copy_to_group` (identity forward, all-reduce backward: the input
  of a column-parallel product) and :func:`reduce_from_group` (all-reduce
  forward, identity backward: the output of a row-parallel product);
  :func:`gather_last`/:func:`split_last` move an activation between its
  feature block and the whole (a column output no row product takes, a
  whole input to a row product).
- :func:`ppermute`, ``lax.ppermute``: each rank sends to its
  permutation partner and receives from its own (zeros where no one
  sends), the backward sending the cotangent along the inverse.
- :func:`ulysses_to_heads`/:func:`ulysses_to_seq`: the all-to-all that
  trades a sequence block with all heads for the whole sequence with a
  block of heads, (B, T/s, H, D) <-> (B, T, H/s, D), each the other's
  backward.

Every buffer is flat: gloo takes the concatenated form of
``all_gather_into_tensor``/``reduce_scatter_tensor`` only. A collective
that fails raises; nothing here falls back to a full leaf.

A :class:`Layout` and a strategy hold their process groups weakly
(:class:`WeakGroup`): torch's registry holds every group until
``destroy_process_group``, so ``cluster.shutdown()`` destroys each one,
and a gloo group's destructor joins its worker threads while the
interpreter is whole. A group kept alive past that keeps its workers;
the worker that releases a finished collective takes the GIL to drop
its tensors, and one that does so after the interpreter began to
finalize is ended inside a C++ destructor (``std::terminate``: the rank
aborts at exit).
"""

from __future__ import annotations

import weakref
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


def _held(group):
    """A weak reference to ``group`` (None: the default group; a weak
    reference, as a copied Layout passes it, as it is)."""
    if group is None or isinstance(group, weakref.ref):
        return group
    return weakref.ref(group)


def _live(ref, what="a process group"):
    """The group ``ref`` refers to; raises once it was destroyed."""
    if ref is None:
        return None
    group = ref()
    if group is None:
        raise RuntimeError(
            f"{what} was destroyed (cluster.shutdown()); build the model "
            "and its strategy again in the new group")
    return group


class WeakGroup:
    """A class attribute holding an instance's process group weakly
    (module docstring); it reads None (the default group) until set."""

    def __set_name__(self, owner, name):
        self._key = "_weak_" + name
        self._name = name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return _live(obj.__dict__.get(self._key), f"group {self._name}")

    def __set__(self, obj, group):
        obj.__dict__[self._key] = _held(group)


class _LayoutFields(NamedTuple):
    shape: Tuple[int, ...]
    dim: int
    n: int
    rank: int
    group_ref: object = None
    axis: Optional[str] = None
    sub: Optional["Layout"] = None


class Layout(_LayoutFields):
    """One rank's block of a sharded leaf: ``shape`` the full shape,
    ``dim`` the shard dimension, ``n`` the number of ranks and ``rank``
    this one's index among them; ``group`` the process group they form
    (None: the default group) and ``axis`` the mesh axis it lines
    (None: the strategy's one axis).

    ``sub``: a second split of this block (a Layout whose ``shape`` is
    :attr:`block_shape`, on another dimension and another line), for a
    leaf split over two mesh axes at once (``CompositeParallel``'s ZeRO-3
    overlay on a Megatron block): the rank then stores ``sub``'s block,
    :attr:`local_shape`. :meth:`levels` lists the single splits, the
    stored one first; the gathers take them in that order.

    The group is held weakly (``group_ref``, module docstring)."""

    __slots__ = ()

    def __new__(cls, shape, dim, n, rank, group=None, axis=None, sub=None):
        return super().__new__(cls, shape, dim, n, rank, _held(group), axis,
                               sub)

    @property
    def group(self):
        return _live(self.group_ref)

    @property
    def size(self) -> int:
        """The block's length on the shard dimension."""
        return self.shape[self.dim] // self.n

    @property
    def block_shape(self) -> Tuple[int, ...]:
        """The shape of this split's block (before ``sub``)."""
        s = list(self.shape)
        s[self.dim] = self.size
        return tuple(s)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape of the block this rank stores."""
        return self.block_shape if self.sub is None else self.sub.local_shape

    def single(self) -> "Layout":
        """This split alone (``sub`` dropped)."""
        return self if self.sub is None else self._replace(sub=None)

    def levels(self) -> List["Layout"]:
        """The single splits, innermost (the stored block's) first."""
        inner = [] if self.sub is None else self.sub.levels()
        return inner + [self.single()]

    @property
    def starts(self) -> Tuple[int, ...]:
        """The stored block's offset in the full leaf, per dimension."""
        s = [0] * len(self.shape)
        s[self.dim] = self.rank * self.size
        if self.sub is not None:
            s = [a + b for a, b in zip(s, self.sub.starts)]
        return tuple(s)

    def index(self, rank: Optional[int] = None) -> tuple:
        """Slices of rank ``rank``'s block (this rank's by default; with a
        ``sub``, this rank's stored block), for a full tensor or numpy
        array."""
        r = self.rank if rank is None else rank
        sl = [slice(None)] * len(self.shape)
        sl[self.dim] = slice(r * self.size, (r + 1) * self.size)
        if self.sub is not None and rank is None:
            st, ln = self.starts, self.local_shape
            sl = [slice(a, a + b) for a, b in zip(st, ln)]
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
    work = _all_gather(buf, x.contiguous().reshape(-1), group=layout.group,
                       async_op=async_op)
    return buf, work


def _reduce_scatter(g: torch.Tensor, layout: Layout) -> torch.Tensor:
    out = g.new_empty(layout.block_shape)
    _reduce_scatter_flat(out.view(-1), _split(g, layout),
                         op=dist.ReduceOp.SUM, group=layout.group)
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
    """:func:`gather` for a sharded leaf (each split of a two-axis one in
    turn); a replicated one as it is."""
    if layout is None:
        return x
    for lay in layout.levels():
        x = gather(x, lay)
    return x


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
                             op=dist.ReduceOp.SUM, group=lay.group)
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
    def forward(ctx, x, owner, shape, holder, group):
        ctx.owner, ctx.group = owner, group
        if dist.get_rank(group) == owner:
            buf = x.detach().contiguous().clone()
        else:
            buf = x.new_empty(shape)
        holder.work = dist.broadcast(buf, src=_global(group, owner),
                                     group=group, async_op=True)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.reduce(g, dst=_global(ctx.group, ctx.owner),
                    op=dist.ReduceOp.SUM, group=ctx.group)
        mine = dist.get_rank(ctx.group) == ctx.owner
        return (g if mine else None), None, None, None, None


def start_owner_copy(x: torch.Tensor, owner: int,
                     shape: Sequence[int], group=None) -> Pending:
    """Rank ``owner``'s ``x`` (of ``shape``) on every rank of ``group``
    (None: the default group; ``owner`` a rank of it), issued now and
    waited for at ``Pending.wait()``."""
    holder = _Holder()
    buf = _OwnerCopy.apply(x, int(owner), tuple(shape), holder, group)
    return Pending(buf, holder.work)


@torch.no_grad()
def gather_full(block: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The full leaf from this rank's block, without autograd (a
    replicated leaf as it is)."""
    if layout is None:
        return block
    out = block.detach()
    for lay in layout.levels():
        buf, _ = _gather_into(out, lay)
        out = _merge(buf, lay)
    return out


@torch.no_grad()
def all_gather_blocks(fulls: Sequence[torch.Tensor],
                      blocks: Sequence[torch.Tensor],
                      layouts: Sequence[Layout]) -> None:
    """Write every rank's block into each full tensor in place: the
    blocks are concatenated into one flat bucket per dtype and
    all-gathered once (ZeRO-1's updated parameters)."""
    groups: dict = {}
    for i, b in enumerate(blocks):
        groups.setdefault((b.dtype, layouts[i].group), []).append(i)
    for idxs in groups.values():
        flat = torch.cat([blocks[i].reshape(-1) for i in idxs])
        n = layouts[idxs[0]].n
        out = flat.new_empty((n * flat.numel(),))
        _all_gather(out, flat, group=layouts[idxs[0]].group)
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


def leaf_sums(values: List[torch.Tensor], replicated: Sequence[bool],
              group=None) -> List[torch.Tensor]:
    """Per-leaf partial sums (0-d tensors, one per leaf of an update's
    list) summed over the ranks of ``group`` (None: the default group),
    a replicated leaf's counted once (the group's rank 0's): one
    all-reduce of the stacked values."""
    t = torch.stack(values)
    if dist.get_rank(group) != 0 and any(replicated):
        mask = torch.tensor(list(replicated), device=t.device)
        t = torch.where(mask, torch.zeros_like(t), t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return list(t.unbind())


# --------------------------------------------- tensor and sequence parallel
def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (Megatron's
    f: the replicated input of a column-parallel product, whose ranks
    each hold part of its gradient). Without gradients (serving under
    ``inference_mode``) it is ``x`` itself, with no autograd node."""
    if not torch.is_grad_enabled():
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passed as it is
    (Megatron's g: the partial products of a row-parallel product)."""
    if not torch.is_grad_enabled():
        return _all_reduce(x, group)
    return _ReduceFromGroup.apply(x, group)


def _last_layout(x: torch.Tensor, n: int, rank: int, group) -> Layout:
    """The layout of ``x``'s feature block (its last dimension) among
    ``n`` ranks: the full activation's shape, split on the last dim."""
    full = tuple(x.shape[:-1]) + (x.shape[-1] * n,)
    return Layout(full, len(full) - 1, n, rank, group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, rank, group):
        lay = _last_layout(x, n, rank, group)
        ctx.layout = lay
        buf, _ = _gather_into(x, lay)
        return _merge(buf, lay)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.layout.index()].contiguous(), None, None, None


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, rank, group):
        k = x.shape[-1] // n
        ctx.args = (n, rank, group)
        return x[..., rank * k:(rank + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, g):
        n, rank, group = ctx.args
        lay = _last_layout(g, n, rank, group)
        buf, _ = _gather_into(g, lay)
        return _merge(buf, lay), None, None, None


def gather_last(x: torch.Tensor, n: int, rank: int, group) -> torch.Tensor:
    """The whole activation from this rank's block of its last dimension
    (rank ``rank`` of ``n`` in ``group``); the gradient's own block comes
    back (the cotangent is the same on every rank of the group)."""
    return _GatherLast.apply(x, n, rank, group)


def split_last(x: torch.Tensor, n: int, rank: int, group) -> torch.Tensor:
    """This rank's block of ``x``'s last dimension; the gradient is
    all-gathered back to the whole (every rank's block of it)."""
    return _SplitLast.apply(x, n, rank, group)


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _permute(x: torch.Tensor, perm, group) -> torch.Tensor:
    """One ``lax.ppermute``: send ``x`` to this rank's destination in
    ``perm`` (``(source, dest)`` group ranks), receive from its source;
    zeros where no pair names this rank as a destination."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if src and src[0] == me:
        out.copy_(x)
    elif src:
        ops.append(dist.P2POp(dist.irecv, out, _global(group, src[0]),
                              group=group))
    if dst and dst[0] != me:
        ops.append(dist.P2POp(dist.isend, x, _global(group, dst[0]),
                              group=group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group, anchor):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, inverse, ctx.group), None, None, None


def ppermute(x: torch.Tensor, perm, group=None,
             anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)`` over ``group``: ``perm`` lists
    ``(source, dest)`` pairs of group ranks; a rank no pair sends to gets
    zeros. Differentiable: the cotangent travels the inverse pairs.

    ``anchor``: a tensor every rank's backward reaches (e.g. an empty
    view of a parameter) that puts this hop in every rank's backward even
    where ``x`` needs no gradient on some rank (a pipeline's bubble tick
    on an input without one), so that its partner's backward hop is
    matched."""
    return _PPermute.apply(x, tuple(tuple(p) for p in perm), group, anchor)


def _move_chunks(x: torch.Tensor, routes, group) -> torch.Tensor:
    """``out[j] = chunk i of rank s`` for each ``(s, i, d, j)`` in
    ``routes`` whose ``d`` is this rank (``x``: this rank's chunks,
    ``(c, ...)``): the chunks one rank sends another go in one message,
    in increasing ``i``."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    sends: dict = {}
    recvs: dict = {}
    for s, i, d, j in routes:
        if s == me and d == me:
            out[j] = x[i]
        elif s == me:
            sends.setdefault(d, []).append(i)
        elif d == me:
            recvs.setdefault(s, []).append(j)
    ops, landing = [], []
    for peer in sorted(set(sends) | set(recvs)):
        if peer in recvs:
            buf = x.new_empty((len(recvs[peer]),) + tuple(x.shape[1:]))
            ops.append(dist.P2POp(dist.irecv, buf, _global(group, peer),
                                  group=group))
            landing.append((buf, recvs[peer]))
        if peer in sends:
            payload = x[sends[peer]].contiguous()
            ops.append(dist.P2POp(dist.isend, payload, _global(group, peer),
                                  group=group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, js in landing:
        out[js] = buf
    return out


class _MoveChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, routes, group):
        ctx.routes, ctx.group = routes, group
        return _move_chunks(x, routes, group)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, j, s, i) for s, i, d, j in ctx.routes)
        return _move_chunks(g, back, ctx.group), None, None


def move_chunks(x: torch.Tensor, routes, group=None) -> torch.Tensor:
    """Chunks of dimension 0 moved between the ranks of ``group``:
    ``routes`` lists ``(source rank, its chunk, dest rank, the chunk's
    place there)`` (every rank passes the same list, which covers every
    place of every rank once). Differentiable: the cotangent's chunks
    travel the routes back (the interleaved pipeline's stage chunks)."""
    return _MoveChunks.apply(x, tuple(tuple(r) for r in routes), group)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` (s, ...) over ``group``: chunk j to
    rank j, chunk j of the result from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _to_heads(x: torch.Tensor, group) -> torch.Tensor:
    s = dist.get_world_size(group)
    b, tl, h, d = x.shape
    chunks = x.reshape(b, tl, s, h // s, d).permute(2, 0, 1, 3, 4)
    got = _exchange(chunks, group)  # (s, B, T/s, H/s, D), j: T block j
    return got.permute(1, 0, 2, 3, 4).reshape(b, s * tl, h // s, d)


def _to_seq(x: torch.Tensor, group) -> torch.Tensor:
    s = dist.get_world_size(group)
    b, t, hs, d = x.shape
    chunks = x.reshape(b, s, t // s, hs, d).permute(1, 0, 2, 3, 4)
    got = _exchange(chunks, group)  # (s, B, T/s, H/s, D), j: heads block j
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // s, s * hs, d)


class _ToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g, ctx.group), None


class _ToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g, ctx.group), None


def ulysses_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T/s, H, D) sequence blocks -> (B, T, H/s, D) head blocks over
    the ``s`` ranks of ``group`` (DeepSpeed-Ulysses' first all-to-all):
    rank j ends with heads ``[j*H/s, (j+1)*H/s)`` of every position."""
    return _ToHeads.apply(x, group)


def ulysses_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse exchange, (B, T, H/s, D) -> (B, T/s, H, D)."""
    return _ToSeq.apply(x, group)


__all__ = [
    "Layout", "Pending", "all_gather_blocks", "copy_to_group", "gather",
    "gather_full", "gather_last", "gather_leaf", "layout_of", "leaf_sums",
    "mark", "move_chunks", "ppermute", "reduce_from_group", "split_last",
    "start_gather",
    "start_owner_copy", "ulysses_to_heads", "ulysses_to_seq",
]
