"""Layer system: ``torch.nn.Module``s that keep the JAX package's names.

The JAX package describes a layer by its hyperparameters and threads a
parameter tree through pure ``init``/``apply`` functions. Here a layer is
an ``nn.Module`` that owns its parameters, but construction still stores
hyperparameters only: ``build(input_shape, generator)`` infers shapes once
and creates the parameters, as ``init`` does there. Containers name their
children with the same keras-style scheme (``dense``, ``dense_1``, ...)
and register them under those names, so ``named_parameters()`` yields the
JAX tree paths (``residual_1.main.dense_1.kernel`` is
``residual_1/main/dense_1/kernel``).

The paged-KV plumbing (``init_paged_cache``/``paged_prefill``/
``paged_decode``) mirrors the JAX package's: caches are plain dicts of
pool tensors keyed like the parameter tree. Unlike JAX, the pools are
updated IN PLACE (each call returns the same dict), which keeps one copy
of the KV pool in device memory.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import activations

Shape = Tuple[int, ...]


def _camel_to_snake(name: str) -> str:
    # Conv2D -> conv2d, MaxPool2D -> max_pool2d (split only at lower->Upper).
    return re.sub(r"(?<=[a-z])(?=[A-Z])", "_", name).lower()


class Layer(torch.nn.Module):
    """Base class: hyperparameters in, ``build`` then ``forward`` out.

    The default paged paths apply ``forward`` to the new positions, which
    is exact for layers that treat every position independently; layers
    that mix positions (attention, positional embeddings) override them."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name  # finalized by the enclosing container
        self._name_explicit = name is not None

    def build(self, input_shape: Shape, generator: torch.Generator) -> Shape:
        """Create this layer's parameters for an unbatched input shape
        (drawn from ``generator``); return the unbatched output shape."""
        raise NotImplementedError

    def default_name(self) -> str:
        return _camel_to_snake(type(self).__name__)

    # -- paged decode (block KV cache, serving.Engine) ----------------------
    def init_paged_cache(self, num_blocks: int, block_size: int, dtype,
                         device):
        """Create this layer's share of the paged KV pool (empty for
        layers that cache nothing)."""
        return {}

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        """One decode step for a batch of SLOTS: x is (S, 1, ...),
        ``block_tables`` (S, max_blocks) int32 pool indices,
        ``positions`` (S,) int32 per-slot write/attend positions,
        ``decode_kernel`` the attention read path ("reference" or
        "fused", see ``ops.paged_attention``). Returns (output, cache)."""
        return self(x), cache

    def paged_prefill(self, cache, x, *, block_table, start: int):
        """Prompt-chunk prefill for ONE sequence: x is (1, C, ...) covering
        absolute positions [start, start+C); writes this chunk's KV into
        the blocks named by ``block_table`` (max_blocks,) and returns
        (output, cache)."""
        return self(x), cache


class NameScope:
    """Assigns unique keras-style names ('dense', 'dense_1', ...) within a container."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        self._used = set()

    def assign(self, layer: Layer) -> str:
        if layer._name_explicit and layer.name:
            if layer.name in self._used:
                raise ValueError(f"Duplicate layer name {layer.name!r}")
            self._used.add(layer.name)
            return layer.name
        base = layer.default_name()
        n = self._counts.get(base, 0)
        self._counts[base] = n + 1
        name = base if n == 0 else f"{base}_{n}"
        self._used.add(name)
        return name


class Sequential(Layer):
    """Linear stack of layers; itself a Layer, so stacks compose."""

    def __init__(self, layers: Sequence[Layer], name: Optional[str] = None):
        super().__init__(name)
        self.layers = list(layers)
        scope = NameScope()
        for layer in self.layers:
            layer.name = scope.assign(layer)
            self.add_module(layer.name, layer)

    def build(self, input_shape, generator):
        shape = tuple(input_shape)
        for layer in self.layers:
            shape = layer.build(shape, generator)
        return shape

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        caches = {}
        for layer in self.layers:
            c = layer.init_paged_cache(num_blocks, block_size, dtype, device)
            if c:
                caches[layer.name] = c
        return caches

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        for layer in self.layers:
            x, c = layer.paged_decode(
                cache.get(layer.name, {}), x,
                block_tables=block_tables, positions=positions,
                decode_kernel=decode_kernel,
            )
            if c:
                cache[layer.name] = c
        return x, cache

    def paged_prefill(self, cache, x, *, block_table, start):
        for layer in self.layers:
            x, c = layer.paged_prefill(
                cache.get(layer.name, {}), x,
                block_table=block_table, start=start,
            )
            if c:
                cache[layer.name] = c
        return x, cache


class Residual(Layer):
    """Skip connection: ``y = activation(main(x) + shortcut(x))``, the
    shortcut the identity by default, as the JAX package's Residual. The
    branches register as ``main`` and ``shortcut`` (the JAX tree's keys).
    The paged paths serve the identity shortcut only (the LM's blocks)."""

    def __init__(self, main: Layer, shortcut: Optional[Layer] = None,
                 activation=None, name: Optional[str] = None):
        super().__init__(name)
        self.main = main
        self.shortcut = shortcut
        self.activation = activations.get(activation)

    def build(self, input_shape, generator):
        out = self.main.build(tuple(input_shape), generator)
        sc = (tuple(input_shape) if self.shortcut is None
              else self.shortcut.build(tuple(input_shape), generator))
        if out != sc:
            raise ValueError(
                f"Residual branch shapes differ: main {out} vs shortcut "
                f"{sc} (add a projection shortcut)"
            )
        return out

    def forward(self, x):
        sc = x if self.shortcut is None else self.shortcut(x)
        return self.activation(self.main(x) + sc)

    def _identity_only(self):
        if self.shortcut is not None:
            raise NotImplementedError(
                "Residual with a shortcut branch: paged decode not ported")

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        c = self.main.init_paged_cache(num_blocks, block_size, dtype, device)
        return {"main": c} if c else {}

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        self._identity_only()
        y, c = self.main.paged_decode(
            cache.get("main", {}), x, block_tables=block_tables,
            positions=positions, decode_kernel=decode_kernel)
        if c:
            cache["main"] = c
        return self.activation(y + x), cache

    def paged_prefill(self, cache, x, *, block_table, start):
        self._identity_only()
        y, c = self.main.paged_prefill(
            cache.get("main", {}), x, block_table=block_table, start=start)
        if c:
            cache["main"] = c
        return self.activation(y + x), cache


__all__ = ["Layer", "NameScope", "Residual", "Sequential", "Shape"]
