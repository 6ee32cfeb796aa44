"""Gradient checkpointing (rematerialization) as a transparent Layer wrapper.

``Remat(layer)`` computes what ``layer`` computes, but its forward runs
under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
backward recomputes the activations the wrapper dropped instead of keeping
them in device memory, as ``jax.checkpoint`` does in the JAX package's
``nn/remat.py``. Per-block remat takes a transformer's activation memory
from O(layers) to O(1) blocks plus the recompute.

Transparency: the wrapper takes the inner layer's name and shares its
parameters, buffers and children (it registers no module of its own in
between), so the parameter and state paths, the dtype hints and every
decode path are the inner layer's; decoding runs no remat.

``policy`` names a ``jax.checkpoint_policies`` entry (a string, or any
object whose ``__name__`` is one). The port maps each to PyTorch's
selective checkpointing (``create_selective_checkpoint_contexts``), which
saves the outputs of the listed ATen operators and recomputes the rest:

==========================================  ==============================
policy                                      saved in the forward
==========================================  ==============================
``None``, ``nothing_saveable``              nothing (the whole block
                                            recomputes)
``dots_with_no_batch_dims_saveable``        ``aten.mm`` and ``aten.addmm``
(``checkpoint_dots_with_no_batch_dims``)    outputs: the 2-D products
``dots_saveable`` (``checkpoint_dots``)     those and ``aten.bmm``/
                                            ``aten.baddbmm`` (batched)
``everything_saveable``                     everything (no checkpoint)
==========================================  ==============================

The flash-attention kernels are not ATen products (their batched products
are not "dots with no batch dims" in JAX either), so they recompute under
every policy but ``everything_saveable``. Any other name raises
``ValueError``.

The recompute runs in the backward, where the ambient precision policy,
strategy and rng key of the forward are not set (the autograd engine may
run it on another thread), so :func:`checkpoint` re-enters all three
around the function (and ``nn.core.local_draw_scope``, which says how
Dropout draws). Dropout's mask is a function of that key
(``utils.threefry``), so the recompute draws the forward's mask. No
generator state is kept: reading the card's generator is not allowed
inside a CUDA graph capture (``compile(steps_per_execution=K)``).

The wrapper passes the parameters and buffers of its subtree, as its
slots hold them at the call, to :func:`checkpoint` as inputs, and
rebinds them into those slots around the recompute. Inside
``nn.ScannedBlocks`` (and ``nn.PipelinedBlocks``) the template's slots
hold block i's slices for its call and block i+1's after it, so a
recompute that read the slots as it finds them would take another
block's weights, or the template's ``meta`` placeholders. This holds for
a ``Remat`` around the whole template, around one residual inside it,
or both.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.utils.checkpoint as torch_ckpt

from .. import precision
from ..parallel.strategy import current_strategy
from .core import (Layer, current_rng, local_draw_scope, local_draws,
                   needs_rng, rng_scope)

_MM = ("mm", "addmm")
_BMM = ("bmm", "baddbmm")
#: policy name -> the ATen operators whose outputs are saved; "all" saves
#: everything (no checkpoint), () nothing.
POLICIES = {
    "nothing_saveable": (),
    "dots_with_no_batch_dims_saveable": _MM,
    "checkpoint_dots_with_no_batch_dims": _MM,
    "dots_saveable": _MM + _BMM,
    "checkpoint_dots": _MM + _BMM,
    "everything_saveable": "all",
}


def resolve_policy(policy):
    """The saved-operator entry of ``policy`` (None, a name, or an object
    whose ``__name__`` is a name): a tuple of ATen operator names, or
    ``"all"``. Anything else raises ValueError."""
    if policy is None:
        return ()
    name = policy if isinstance(policy, str) else getattr(
        policy, "__name__", None)
    if name not in POLICIES:
        raise ValueError(
            f"remat policy {policy!r} is not one the port maps; choose from "
            f"{sorted(POLICIES)} (jax.checkpoint_policies names)")
    return POLICIES[name]


def _saving(ops):
    """Selective-checkpoint contexts saving the outputs of ``ops`` (ATen
    operator names, or operator overloads)."""
    aten = torch.ops.aten
    return torch_ckpt.create_selective_checkpoint_contexts(
        [getattr(aten, op).default if isinstance(op, str) else op
         for op in ops])


def checkpoint(fn, *args, policy=None, save=()):
    """``fn(*args)`` with its activations rematerialized in the backward
    under ``policy`` (:func:`resolve_policy`), re-entering the ambient
    precision policy and strategy of this call in the recompute. ``save``:
    more operators (overloads) whose outputs are kept, e.g. the fused
    cross-entropy's (``ops.pallas_kernels.XENT_FWD_OP``), whose losses
    no backward reads again."""
    saved = resolve_policy(policy)
    if saved == "all":
        return fn(*args)
    saved = tuple(saved) + tuple(save)
    pol, strategy = precision.current_policy(), current_strategy()
    rng, local = current_rng(), local_draws()

    def run(*a):
        with contextlib.ExitStack() as stack:
            if pol is not None:
                stack.enter_context(pol.scope())
            if strategy is not None:
                stack.enter_context(strategy.scope())
            stack.enter_context(rng_scope(rng))
            stack.enter_context(local_draw_scope(local))
            return fn(*a)

    kw = {"context_fn": functools.partial(_saving, saved)} if saved else {}
    return torch_ckpt.checkpoint(run, *args, use_reentrant=False,
                                 preserve_rng_state=False, **kw)


class Remat(Layer):
    """Wrap a layer so its forward rematerializes in the backward (module
    docstring). ``policy``: a ``jax.checkpoint_policies`` name or an object
    named like one; None saves nothing."""

    def __init__(self, inner: Layer, *, policy=None,
                 name: Optional[str] = None):
        torch.nn.Module.__init__(self)
        object.__setattr__(self, "inner", inner)
        # Share the inner layer's leaves and children: the tree paths
        # through the wrapper are the inner layer's own.
        self._parameters = inner._parameters
        self._buffers = inner._buffers
        self._modules = inner._modules
        resolve_policy(policy)  # fail fast
        self.policy = policy
        if name is not None:
            inner.name = name
            inner._name_explicit = True

    @property
    def name(self):
        return self.inner.name

    @name.setter
    def name(self, value):
        self.inner.name = value

    @property
    def _name_explicit(self):
        return self.inner._name_explicit

    @property
    def decode_safe(self):
        return self.inner.decode_safe

    @property
    def needs_rng(self):
        return needs_rng(self.inner)

    def default_name(self) -> str:
        return self.inner.default_name()

    def dtype_hints(self):
        return self.inner.dtype_hints()

    def sharding_hints(self):
        return self.inner.sharding_hints()

    def train(self, mode: bool = True):
        self.inner.training = mode
        return super().train(mode)

    def build(self, input_shape, generator):
        return self.inner.build(input_shape, generator)

    def _slots(self):
        """``(slot dict, name)`` of every parameter and buffer of the
        wrapped subtree, each slot once."""
        seen, out = set(), []
        for mod in self.inner.modules():
            for slots in (mod._parameters, mod._buffers):
                if id(slots) in seen:
                    continue
                seen.add(id(slots))
                out += [(slots, k) for k, t in slots.items()
                        if t is not None]
        return out

    def forward(self, x):
        if not torch.is_grad_enabled():
            return self.inner(x)
        slots = self._slots()

        def bound(h, *leaves):
            saved = [(d, k, d[k]) for d, k in slots]
            for (d, k), t in zip(slots, leaves):
                d[k] = t
            try:
                return self.inner(h)
            finally:
                for d, k, t in saved:
                    d[k] = t

        return checkpoint(bound, x, *[d[k] for d, k in slots],
                          policy=self.policy)

    # No remat at decode: one-token steps have nothing worth dropping.
    def init_cache(self, batch, max_len, dtype, device):
        return self.inner.init_cache(batch, max_len, dtype, device)

    def decode(self, cache, x, *, pos):
        return self.inner.decode(cache, x, pos=pos)

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        return self.inner.init_paged_cache(num_blocks, block_size, dtype,
                                           device)

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        return self.inner.paged_decode(
            cache, x, block_tables=block_tables, positions=positions,
            decode_kernel=decode_kernel)

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        return self.inner.paged_verify(
            cache, x, block_tables=block_tables, positions=positions,
            decode_kernel=decode_kernel)

    def paged_prefill(self, cache, x, *, block_table, start):
        return self.inner.paged_prefill(cache, x, block_table=block_table,
                                        start=start)

    def extra_repr(self) -> str:
        return f"policy={self.policy!r}"


__all__ = ["POLICIES", "Remat", "checkpoint", "resolve_policy"]
