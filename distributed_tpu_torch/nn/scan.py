"""Weight-stacked blocks: ``ScannedBlocks``, as the JAX package's ``nn/scan.py``.

S structurally identical, shape-preserving blocks keep their leaves
STACKED: each parameter and buffer of the block is one tensor with a
leading (S, ...) axis, registered under the JAX tree's path
``scanned_blocks/blocks/<the block's own path>`` (an LM's template
``Sequential`` adds no segment: ``scanned_blocks/blocks/residual/main/
dense/kernel``). The optimizer, ``interop``, the checkpoints and the
paged KV pools all see those (S, ...) leaves, as in JAX, so a stacked
model hands the optimizer one tensor per leaf instead of one per layer's
leaf.

The forward runs one TEMPLATE block S times, block i over slice i of
every leaf. The slices are swapped into the template's parameter and
buffer slots for the call and the template's own are put back after it
(the template is not a registered child: its leaves are placeholders on
the ``meta`` device). Each parameter is split once a forward with
``torch.unbind``, whose backward is one ``stack``: indexing ``p[i]`` per
block would build a full (S, ...) zero gradient per slice. Buffers are
indexed views, so BatchNorm's in-place running-statistics update lands in
slice i of the stacked (S, C) buffer. The carry is cast back to the
input's dtype after each block, as the JAX scan's carry is. A ``Remat``
around the template, or around a part of it, passes the slices its
slots hold at the call to its checkpoint as inputs and rebinds them
around the recompute (``nn.remat``), so the backward reads block i's
weights, not the template's placeholders.

Randomness: the ambient key is split into S streams, block i's the i-th
(``jax.random.split(rng, S)``), so Dropout's masks are the JAX stack's.
Deterministic computation equals the unrolled ``Sequential([block_fn()
for _ in range(S)])`` given the same per-block parameters; the rng
routing differs from the unrolled form's, as in JAX.

Decode: the dense caches (``Model.generate``) stack as ``{"blocks": (S,
...)}`` and the paged pools (``serving.Engine``) as ``{"stacked": (S,
...)}`` (:data:`STACKED_POOL_KEY`, the pool-block axis then 1); each
block's hook reads and writes its own slice in place.

Under FSDP the stacked leaves are stored sharded (``parallel.
collectives``): a leaf split on a block axis (dim > 0) gives each slice
split on the dimension before it, gathered by an all-gather; a leaf split
on the stacked axis itself leaves each slice whole on one rank, and its
"gather" is a broadcast from that rank (the JAX rule places it the same
way). Each slice is cast to the policy's compute dtype before it is
gathered, so bf16 goes over the wire. ``overlap`` is the JAX option: with
``"auto"`` or ``"require"`` under a strategy whose ``overlap_spec``
gives a gather, slice i+1's gather is issued before slice i's compute
(the JAX double-buffered body), asynchronously, and waited for before
its use; with ``"off"`` each gather is issued just before its slice is
used. The values are the same either way. ``"require"`` raises the JAX
package's ``ValueError`` under a strategy without a gather, and
``last_overlap_trace()`` records whether the overlap was active.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

import torch

from .core import Layer, Shape, current_rng, rng_scope
from ..parallel import collectives
from ..parallel.collectives import layout_of
from ..quant import QuantizedWeight
from ..utils import threefry

#: The reserved key the stacked PAGED pools live under (the JAX
#: ``STACKED_POOL_KEY``): leaves below it carry a leading (S, ...) stack
#: axis, so the pool-block axis is 1 (``serving.kv_cache``).
STACKED_POOL_KEY = "stacked"

_overlap_trace = threading.local()


def last_overlap_trace() -> Optional[dict]:
    """``{"layers": S, "active": bool}`` from the most recent
    ``ScannedBlocks`` forward on this thread, or None before any
    (``Model.fit``'s overlap report reads it, as JAX's does)."""
    return getattr(_overlap_trace, "record", None)


def clear_overlap_trace() -> None:
    """Forget this thread's record (``Model.fit`` clears it as it starts,
    so a fit of a model without a stack reports none)."""
    _overlap_trace.record = None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _owner(root: torch.nn.Module, dotted: str, create: bool):
    """(module holding leaf ``dotted``, the leaf's attribute name), walking
    (and with ``create`` making) plain modules along the path."""
    *path, attr = dotted.split(".")
    mod = root
    for part in path:
        sub = mod._modules.get(part)
        if sub is None:
            if not create:
                raise KeyError(dotted)
            sub = torch.nn.Module()
            mod.add_module(part, sub)
        mod = sub
    return mod, attr


def init_stacked_blocks(block_fn, template, num_blocks, input_shape,
                        generator, *, require_stateless=False,
                        container="ScannedBlocks"):
    """Build ``num_blocks`` fresh blocks (the template first) and stack
    their parameters and buffers with a leading (S, ...) axis, as the JAX
    ``init_stacked_blocks`` (``require_stateless``: a block with buffers
    raises its error, as ``PipelinedBlocks`` requires). Returns the
    stacked leaves as a tree of plain modules under the template's paths,
    and the leaf names (parameters, then buffers), for
    :class:`ScannedBlocks` to bind."""
    shape = tuple(input_shape)
    blocks = []
    for i in range(num_blocks):
        # Fresh instance per block: container naming is stateful and the
        # template must not accumulate names.
        block = template if i == 0 else block_fn()
        out = block.build(shape, generator)
        state = [n for n, _ in block.named_buffers()]
        if require_stateless and state:
            raise ValueError(
                f"{container} requires stateless blocks (got state keys "
                f"{state}); running stats can't ride a microbatch "
                "schedule")
        if tuple(out) != shape:
            raise ValueError(
                f"{container} blocks must preserve shape: {shape} -> "
                f"{tuple(out)}")
        blocks.append(block)
    params = [n for n, _ in template.named_parameters()]
    if not params:
        raise ValueError(
            f"{container} requires parameterized blocks (the template "
            "block has no params); wrap param-free layers directly in "
            "a Sequential instead")
    buffers = [n for n, _ in template.named_buffers()]
    stack = torch.nn.Module()
    with torch.no_grad():
        for name in params:
            mod, attr = _owner(stack, name, create=True)
            mod.register_parameter(attr, torch.nn.Parameter(torch.stack(
                [b.get_parameter(name).detach() for b in blocks])))
        for name in buffers:
            mod, attr = _owner(stack, name, create=True)
            mod.register_buffer(attr, torch.stack(
                [b.get_buffer(name) for b in blocks]))
    return stack, params, buffers


class ScannedBlocks(Layer):
    """S structurally identical, shape-preserving blocks with stacked
    leaves (module docstring). ``block_fn()`` returns a fresh ``Layer`` of
    the same structure at each call. ``overlap``: ``"auto"`` (default),
    ``"off"`` or ``"require"`` (the JAX option; see the module
    docstring)."""

    decode_safe = False  # decode is overridden: the template's, per block
    _stack_options: Dict = {}

    def __init__(self, block_fn: Callable[[], Layer], num_blocks: int, *,
                 overlap: str = "auto", name: Optional[str] = None):
        super().__init__(name)
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if overlap not in ("auto", "off", "require"):
            raise ValueError(
                "overlap must be 'auto', 'off' or 'require', got "
                f"{overlap!r}")
        self.num_blocks = int(num_blocks)
        self.overlap = overlap
        self.block_fn = block_fn
        # The template defines structure and names; not a registered child,
        # so its placeholder leaves never reach the parameter tree.
        object.__setattr__(self, "block", block_fn())
        self._bindings: List = []

    def default_name(self) -> str:
        return "scanned_blocks"

    @property
    def needs_rng(self) -> bool:
        return bool(getattr(self.block, "needs_rng", False))

    def dtype_hints(self):
        # The stacked leaves mirror the template's tree one level down,
        # so its per-layer dtype overrides pass straight through.
        h = self.block.dtype_hints()
        return {"blocks": h} if h is not None and h != {} else {}

    def sharding_hints(self):
        # The template's roles behind the stack axis: "col" still names
        # the last dimension, "row" (dim 0 of a block's leaf) becomes
        # "row1"; roles that would split the stack axis itself raise.
        def shift(h):
            if isinstance(h, dict):
                return {k: shift(v) for k, v in h.items()}
            if h in ("expert", "pipe"):
                raise ValueError(
                    f"ScannedBlocks cannot stack blocks with {h!r}-role "
                    "params (MoE expert stacks / nested pipeline stages)")
            return "row1" if h == "row" else h

        inner = shift(self.block.sharding_hints())
        return {"blocks": inner} if inner else {}

    def train(self, mode: bool = True):
        self.block.train(mode)
        return super().train(mode)

    def build(self, input_shape: Shape, generator):
        shape = tuple(input_shape)
        stack, params, buffers = init_stacked_blocks(
            self.block_fn, self.block, self.num_blocks, shape, generator,
            **self._stack_options)
        self.blocks = stack
        # The template's slots, swapped per block; its own leaves become
        # shape-only placeholders.
        self._bindings = []
        for kind, names in (("param", params), ("buffer", buffers)):
            for name in names:
                mod, attr = _owner(self.block, name, create=False)
                slots = mod._parameters if kind == "param" else mod._buffers
                slots[attr] = (torch.nn.Parameter(
                    torch.empty_like(slots[attr], device="meta"),
                    requires_grad=False) if kind == "param"
                    else torch.empty_like(slots[attr], device="meta"))
                self._bindings.append((name, kind, slots, attr, mod))
        return shape

    # ------------------------------------------------------------ slices
    def _stacked(self) -> List[torch.Tensor]:
        """The stacked leaves in binding order; raises when their leading
        axes differ (a quantized stack's shared scales, as JAX's scan)."""
        leaves, sizes, quantized = [], [], False
        for name, kind, _, _, _ in self._bindings:
            mod, attr = _owner(self.blocks, name, create=False)
            sub = mod._modules.get(attr)
            if isinstance(sub, QuantizedWeight):
                quantized = True
                sizes += [sub.q.shape[0], sub.scale.shape[0]]
                leaves.append(sub)
                continue
            t = (mod._parameters if kind == "param" else mod._buffers)[attr]
            lay = layout_of(t)  # a block's leaf: its full stack's size
            sizes.append((lay.shape if lay is not None else t.shape)[0])
            leaves.append(t)
        if any(s != self.num_blocks for s in sizes):
            raise ValueError(
                "ScannedBlocks: the stacked leaves have different leading "
                f"axis sizes ({', '.join(map(str, sizes))}); a quantized "
                "stacked weight keeps one scale per output channel shared "
                "by all blocks (quant.quantize_leaf reduces over every axis "
                "but the last), and the JAX package's lax.scan refuses the "
                "same tree ('scan got values with different leading axis "
                "sizes')")
        if quantized:
            raise NotImplementedError(
                "ScannedBlocks over int8-quantized stacked weights whose "
                "scales happen to have S entries: not yet ported "
                "(ROADMAP 1.7b)")
        return leaves

    def _slices(self) -> List[List[torch.Tensor]]:
        """Per block, its slice of every stacked leaf: parameters through
        one ``unbind`` each, buffers as indexed views."""
        cols = [torch.unbind(t, 0) if kind == "param"
                else [t[i] for i in range(t.shape[0])]
                for (_, kind, _, _, _), t in zip(self._bindings,
                                                 self._stacked())]
        return [[c[i] for c in cols] for i in range(len(cols[0]))]

    def _fetcher(self, stacked, start, strategy=None):
        """``fetch(i)``: block i's leaves as ``collectives.Pending``s, for
        stacked leaves of which some are stored sharded. Each parameter's
        local part is unbound once; slice i is cast to the compute dtype
        by its layer (``Layer.compute_cast``) and then gathered: by
        ``start`` (the strategy's gather) when the leaf is split on a
        block axis, by a broadcast from its rank when it is split on the
        stacked axis. A leaf the ``strategy`` computes with as its block
        (tensor parallelism) is not gathered: slice i is block i's block,
        marked with its layout one dimension down, which its layer reads.
        Buffers (replicated) are indexed views."""
        cols = []
        for (_, kind, _, _, mod), t in zip(self._bindings, stacked):
            lay = layout_of(t)
            local = torch.unbind(t, 0) if kind == "param" else None
            cols.append((kind, mod, t, lay, local))

        def fetch(i):
            out = []
            for kind, mod, t, lay, local in cols:
                if kind != "param":
                    out.append(collectives.Pending(t[i]))
                elif lay is None:
                    out.append(start(mod.compute_cast(local[i]), None))
                elif lay.dim > 0 and strategy is not None and \
                        strategy.computes_block(lay):
                    out.append(collectives.Pending(collectives.mark(
                        local[i], lay._replace(shape=lay.shape[1:],
                                               dim=lay.dim - 1))))
                elif lay.dim > 0:
                    sub = lay._replace(shape=lay.shape[1:], dim=lay.dim - 1)
                    out.append(start(mod.compute_cast(local[i]), sub))
                else:
                    per = lay.size
                    owner = i // per
                    mine = local[i % per] if lay.rank == owner else local[0]
                    out.append(collectives.start_owner_copy(
                        mod.compute_cast(mine), owner, lay.shape[1:],
                        lay.group))
            return out

        return fetch

    @staticmethod
    def _resident(stacked) -> bool:
        """True when every block's slices are in this rank's leaves."""
        return not any(layout_of(t) is not None for t in stacked)

    def _iter_slices(self):
        """Block by block, its leaves (gathered where they are stored
        sharded), for the decode paths."""
        stacked = self._stacked()
        if self._resident(stacked):
            yield from self._slices()
            return
        fetch = self._fetcher(stacked, collectives.start_gather)
        for i in range(self.num_blocks):
            yield [p.wait() for p in fetch(i)]

    @contextlib.contextmanager
    def _swapped(self, leaves):
        saved = []
        try:
            for (_, _, slots, attr, _), t in zip(self._bindings, leaves):
                saved.append((slots, attr, slots[attr]))
                slots[attr] = t
            yield
        finally:
            for slots, attr, old in saved:
                slots[attr] = old

    # ----------------------------------------------------------- forward
    def forward(self, x):
        from ..parallel.strategy import current_strategy

        strat = current_strategy()
        gather = None if strat is None else strat.overlap_spec()
        if self.overlap == "require" and gather is None:
            raise ValueError(
                "ScannedBlocks(overlap='require') needs an ambient "
                "strategy with an overlap_spec gather (the FSDP family); "
                f"got {type(strat).__name__ if strat else None}")
        active = gather is not None and self.overlap != "off"
        _overlap_trace.record = {"layers": self.num_blocks, "active": active}
        rng = current_rng()
        keys = (threefry.split(rng, self.num_blocks)
                if rng is not None else None)
        stacked = self._stacked()
        fetch = None
        if active or not self._resident(stacked):
            fetch = self._fetcher(stacked, gather or collectives.start_gather,
                                  strat)
            pending = fetch(0)
        else:
            slices = self._slices()
        for i in range(self.num_blocks):
            if fetch is None:
                leaves = slices[i]
            else:
                leaves = [p.wait() for p in pending]
                if i + 1 < self.num_blocks and active:
                    # Slice i+1's gather goes out before slice i's compute.
                    pending = fetch(i + 1)
            with rng_scope(None if keys is None else keys[i]), \
                    self._swapped(leaves):
                y = self.block(x)
            x = y.to(x.dtype)
            if fetch is not None and not active and i + 1 < self.num_blocks:
                pending = fetch(i + 1)
        return x

    # ------------------------------------------------- incremental decode
    def _stack_cache(self, make, key):
        """A template cache (made under block 0's slices) broadcast to S
        blocks, under ``key``; {} for a block that caches nothing."""
        with torch.no_grad(), self._swapped(next(self._iter_slices())):
            c0 = make()
        if not list(_tree_leaves(c0)):
            return {}
        return {key: _tree_map(
            lambda l: l.expand((self.num_blocks,) + tuple(l.shape)).clone(),
            c0)}

    def _cached_step(self, step_name, key, cache, x, **kw):
        """Run the template's cached hook ``step_name`` block by block over
        slice i of the stacked caches: the port's hooks write their caches
        in place (``nn.core``), so block i's rows land in its slice."""
        stacked = cache.get(key, {})
        step = getattr(self.block, step_name)
        for i, leaves in enumerate(self._iter_slices()):
            with self._swapped(leaves):
                y, _ = step(_tree_map(lambda l: l[i], stacked), x, **kw)
            x = y.to(x.dtype)
        return x, cache

    def init_cache(self, batch, max_len, dtype, device):
        return self._stack_cache(
            lambda: self.block.init_cache(batch, max_len, dtype, device),
            "blocks")

    def decode(self, cache, x, *, pos):
        return self._cached_step("decode", "blocks", cache, x, pos=pos)

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        return self._stack_cache(
            lambda: self.block.init_paged_cache(num_blocks, block_size,
                                                dtype, device),
            STACKED_POOL_KEY)

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        return self._cached_step(
            "paged_decode", STACKED_POOL_KEY, cache, x,
            block_tables=block_tables, positions=positions,
            decode_kernel=decode_kernel)

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        return self._cached_step(
            "paged_verify", STACKED_POOL_KEY, cache, x,
            block_tables=block_tables, positions=positions,
            decode_kernel=decode_kernel)

    def paged_prefill(self, cache, x, *, block_table, start):
        return self._cached_step(
            "paged_prefill", STACKED_POOL_KEY, cache, x,
            block_table=block_table, start=start)

    def extra_repr(self) -> str:
        return f"num_blocks={self.num_blocks}, overlap={self.overlap!r}"


__all__ = ["STACKED_POOL_KEY", "ScannedBlocks", "clear_overlap_trace",
           "init_stacked_blocks", "last_overlap_trace"]
