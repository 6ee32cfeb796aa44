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

The dense-cache decode protocol (``init_cache``/``decode``, which
``Model.generate`` drives) is the JAX package's: x is ``(B, 1, ...)``,
``pos`` the step's position, ``(output, new_cache)`` comes back;
position-independent layers apply token-wise, attention and positional
embeddings override, and layers that mix positions set ``decode_safe =
False`` and raise. The attention cache is written in place.

Randomness (Dropout) follows the JAX package's rng routing. The JAX
``apply`` takes an ``rng`` argument; here the key is ambient, a
thread-local set by :func:`rng_scope` (``Model.fit`` sets the step's key
around the train step) and read by :func:`current_rng`. A container
hands its children keys as the JAX containers do: ``Sequential`` (and
:func:`apply_layers`) splits its key once across the layers that need an
rng (``needs_rng``), in order, ``Residual`` splits it in two (main, then
shortcut), and ``ScannedBlocks`` into one stream per block; a layer that
needs no rng sees none. So a mask drawn by the port equals the JAX
layer's bit for bit (``utils.threefry``).

The paged-KV plumbing (``init_paged_cache``/``paged_prefill``/
``paged_decode``/``paged_verify``) mirrors the JAX package's: caches are plain dicts of
pool tensors keyed like the parameter tree. Unlike JAX, the pools are
updated IN PLACE (each call returns the same dict), which keeps one copy
of the KV pool in device memory.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import activations
from .. import precision
from ..parallel.collectives import gather, layout_of
from ..quant import QKEY, SKEY, QuantizedWeight, maybe_dequantize
from ..utils import threefry

Shape = Tuple[int, ...]
SEP = "/"

_RNG = threading.local()


def current_rng():
    """The ambient rng key (numpy key data or a ``(2,)`` int64 device
    tensor, ``utils.threefry``) set by :func:`rng_scope`; None outside
    one."""
    return getattr(_RNG, "key", None)


@contextlib.contextmanager
def rng_scope(key):
    """Make ``key`` the ambient rng of the layers called inside (None: no
    rng, as a JAX ``apply(..., rng=None)``)."""
    prev = current_rng()
    _RNG.key = key
    try:
        yield key
    finally:
        _RNG.key = prev


def local_draws() -> bool:
    """True inside :func:`local_draw_scope`: a layer draws its random
    numbers at the shape of the tensor it holds, not as its slice of a
    global array (``nn.Dropout``)."""
    return bool(getattr(_RNG, "local", False))


@contextlib.contextmanager
def local_draw_scope(local: bool = True):
    """Draw at local shapes inside (``local``), as a JAX ``shard_map``
    body does: the pipeline schedule's ticks, and their recompute."""
    prev = local_draws()
    _RNG.local = bool(local)
    try:
        yield
    finally:
        _RNG.local = prev


def needs_rng(layer) -> bool:
    return bool(getattr(layer, "needs_rng", False))


def _call_with_rng(layer, x, key):
    """``layer(x)`` with ``key`` as the ambient rng."""
    with rng_scope(key):
        return layer(x)


def _gathered(w, layout):
    """A sharded leaf gathered (by the ambient strategy's
    ``constrain_compute_params`` inside a scope; the layout names the
    group's blocks either way); any other leaf as it is."""
    if layout is None:
        return w
    from ..parallel.strategy import current_strategy

    strategy = current_strategy()
    if strategy is None:
        return gather(w, layout)
    return strategy.constrain_compute_params(w, layout)


def tp_layout(layer, name: str):
    """The layout of leaf ``name`` of ``layer`` when the layer computes
    with its block of it (Megatron tensor parallelism: the ambient
    strategy's ``computes_block``), else None (the leaf is whole, or is
    gathered where it is read)."""
    w = getattr(layer, name)
    if isinstance(w, QuantizedWeight):
        w = w.q
    lay = layout_of(w)
    if lay is None:
        return None
    from ..parallel.strategy import current_strategy

    strategy = current_strategy()
    if strategy is None or not strategy.computes_block(lay):
        return None
    return lay


def draw_block(shape, device=None, *, seq_dim: Optional[int] = 1,
               col: Optional["Layer"] = None):
    """``(global shape, index)``: which block of the array that JAX draws
    at once over the global batch a rank's draw of local ``shape`` is,
    under the ambient strategy. ``index`` holds, per dimension, a 1-D
    tensor on ``device`` of the global indices held (None: all of them),
    as ``utils.threefry``'s block draws take it: the rank's rows of
    dimension 0 where the strategy splits rows, its contiguous positions
    of dimension ``seq_dim`` under a sequence split (both from
    ``Strategy.token_layout``; ``seq_dim`` None: the draw has no sequence
    dimension), and its feature columns of the last dimension where
    ``col``, a column-parallel layer, made them. Inside
    :func:`local_draw_scope` rows and positions are the local ones. Every
    layer that draws per element or per row reads its block here
    (``Dropout``, ``RandomFlip``, ``RandomCrop``)."""
    from ..parallel.strategy import current_strategy

    shape, index = list(shape), [None] * len(shape)

    def span(lo, n):
        return torch.arange(lo, lo + n, device=device)

    strategy = current_strategy()
    if strategy is not None and shape and not local_draws():
        b = shape[0]
        has_seq = seq_dim is not None and len(shape) > seq_dim
        t = shape[seq_dim] if has_seq else 1
        lay = strategy.token_layout(b, t)
        if lay.rows > b:
            shape[0], index[0] = lay.rows, span(lay.row_start, b)
        if has_seq and lay.seq > t:
            shape[seq_dim], index[seq_dim] = lay.seq, span(lay.seq_offset, t)
    lay = None if col is None else tp_layout(col, "kernel")
    if lay is not None and lay.n > 1:
        w = shape[-1]
        shape[-1] = w * lay.n
        index[-1] = span(lay.rank * w, w)
    return tuple(shape), index


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

    def dtype_hints(self):
        """The layer's explicit compute dtype (``dtype=``), nested as the
        parameter tree by the containers; None/{} for no override. The
        JAX ``Policy.cast_to_compute`` skips the marked subtrees."""
        return getattr(self, "dtype", None)

    def sharding_hints(self) -> Dict[str, str]:
        """Tensor-parallel roles of this layer's parameters, as the JAX
        layer's: parameter name -> "col" (split the output dimension over
        the model axis) or "row" (split the input dimension); containers
        nest them as the parameter tree. Empty: replicated."""
        return {}

    def _compute_leaf(self, name: str):
        """Leaf ``name`` as the JAX step's ``Policy.cast_to_compute`` hands
        it to this layer: under an ambient policy that casts, and with no
        ``dtype=`` of the layer's own, a floating leaf in the compute dtype
        (a quantized weight, as a ``{"q", "scale"}`` dict: its scale cast,
        its int8 payload as it is); else the stored leaf. The cast is made
        here, inside the step, from the f32 master, so gradients come back
        f32 through it. A leaf stored sharded (FSDP) is then gathered by
        the ambient strategy (``constrain_compute_params``), after the
        cast, so a bf16 policy moves bf16; a quantized weight gathers both
        parts."""
        w = getattr(self, name)
        if isinstance(w, QuantizedWeight):
            layouts = {QKEY: layout_of(w.q), SKEY: layout_of(w.scale)}
            w = self.compute_cast({QKEY: w.q, SKEY: w.scale})
            return {k: _gathered(v, layouts[k]) for k, v in w.items()}
        return _gathered(self.compute_cast(w), layout_of(w))

    def compute_cast(self, w):
        """``w`` (a stored leaf, or a quantized weight's ``{"q",
        "scale"}``) cast as :meth:`_compute_leaf` casts it: to the ambient
        policy's compute dtype unless the layer has a ``dtype=`` of its
        own."""
        pol = precision.current_policy()
        if (pol is None or not pol.needs_compute_cast
                or getattr(self, "dtype", None) is not None):
            return w
        cd = pol.compute_dtype
        if isinstance(w, dict):
            return {QKEY: w[QKEY], SKEY: w[SKEY].to(cd)}
        return precision.cast_floating(w, cd)

    def _weight(self, name: str):
        """:meth:`_compute_leaf`, dequantized when it is int8 (the multiply
        in f32, as the JAX layers' ``maybe_dequantize``)."""
        return maybe_dequantize(self._compute_leaf(name))

    #: True for a layer that draws random numbers in training (Dropout);
    #: containers report whether any child does.
    needs_rng = False

    # -- incremental decode (dense KV cache, Model.generate) ----------------
    #: True: ``forward`` treats every position independently, so the
    #: default one-token decode below is exact. Layers that mix positions
    #: override ``decode`` or set this False to fail loudly.
    decode_safe = True

    def init_cache(self, batch: int, max_len: int, dtype, device):
        """Create this layer's decode cache (empty for stateless layers)."""
        return {}

    def decode(self, cache, x, *, pos: int):
        """One autoregressive step: x is (B, 1, ...) at position ``pos``.
        Returns (output, new_cache)."""
        if not self.decode_safe:
            raise NotImplementedError(
                f"{type(self).__name__} does not support incremental "
                "decode (generation)")
        return self(x), cache

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

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        """Speculative verification for a batch of SLOTS: x is (S, K, ...),
        K draft-proposed candidate tokens per slot at consecutive absolute
        positions [positions[s], positions[s] + K), scored in one pass
        (K=1 is exactly ``paged_decode``). Position-independent layers
        apply token-wise; attention and positional embeddings override."""
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


def _pair_tp(layers: Sequence[Layer]) -> None:
    """Megatron's pairing, decided by the Sequential for its layers: a
    column-parallel product whose next layer is a row-parallel one hands
    it its feature block without a gather (``feeds_row``), and that layer
    takes the block as it is (``takes_block``) instead of splitting a
    whole input. Layers between them that act element by element
    (``tp_elementwise``: Dropout) take the block too, each told which
    product made it (``col_source``, not a registered child)."""
    for i, a in enumerate(layers):
        if getattr(a, "shard", None) != "col":
            continue
        j = i + 1
        while j < len(layers) and getattr(layers[j], "tp_elementwise",
                                          False):
            j += 1
        if j < len(layers) and getattr(layers[j], "shard", None) == "row":
            a.feeds_row = True
            layers[j].takes_block = True
            for mid in layers[i + 1:j]:
                object.__setattr__(mid, "col_source", a)


class Sequential(Layer):
    """Linear stack of layers; itself a Layer, so stacks compose."""

    def __init__(self, layers: Sequence[Layer], name: Optional[str] = None):
        super().__init__(name)
        self.layers = list(layers)
        scope = NameScope()
        for layer in self.layers:
            layer.name = scope.assign(layer)
            self.add_module(layer.name, layer)
        _pair_tp(self.layers)

    def add(self, layer: Layer):
        """Append ``layer``, named after the names already taken, as the
        JAX ``Sequential.add`` names it ('dense_2' after 'dense_1')."""
        scope = NameScope()
        for existing in self.layers:
            scope._used.add(existing.name)
            m = re.fullmatch(r"(.+?)(?:_(\d+))?", existing.name)
            base = m.group(1) if m else existing.name
            idx = int(m.group(2)) + 1 if m and m.group(2) else 1
            scope._counts[base] = max(scope._counts.get(base, 0), idx)
        layer.name = scope.assign(layer)
        self.layers.append(layer)
        self.add_module(layer.name, layer)
        _pair_tp(self.layers)

    def summary_lines(self, input_shape: Shape):
        """Keras-style summary rows ``(name, output_shape, param_count)``,
        as the JAX ``Sequential.summary_lines``: each layer built afresh
        from the shape, on fake tensors (shapes only: nothing is drawn or
        stored, and this module's own leaves are left as they are)."""
        from ..parallel.auto_shard import _abstract_copy, _fake_mode

        mode = _fake_mode()
        abstract = _abstract_copy(self, input_shape, 0, mode)
        rows = []
        shape = tuple(input_shape)
        with mode:
            generator = torch.Generator().manual_seed(0)
            for layer in abstract.layers:
                shape = tuple(int(d) for d in layer.build(shape, generator))
                count = sum(t.numel() for t in param_tree(layer).values())
                rows.append((layer.name, (None,) + shape, count))
        return rows

    def build(self, input_shape, generator):
        shape = tuple(input_shape)
        for layer in self.layers:
            shape = layer.build(shape, generator)
        return shape

    def forward(self, x):
        return apply_layers(self.layers, x)

    @property
    def needs_rng(self) -> bool:
        return any(needs_rng(layer) for layer in self.layers)

    def dtype_hints(self):
        hints = {}
        for layer in self.layers:
            h = layer.dtype_hints()
            if h is not None and h != {}:
                hints[layer.name] = h
        return hints

    def sharding_hints(self):
        hints = {}
        for layer in self.layers:
            h = layer.sharding_hints()
            if h:
                hints[layer.name] = h
        return hints

    def init_cache(self, batch, max_len, dtype, device):
        caches = {}
        for layer in self.layers:
            c = layer.init_cache(batch, max_len, dtype, device)
            if c:
                caches[layer.name] = c
        return caches

    def decode(self, cache, x, *, pos):
        new_cache = dict(cache)
        for layer in self.layers:
            x, c = layer.decode(cache.get(layer.name, {}), x, pos=pos)
            if c:
                new_cache[layer.name] = c
        return x, new_cache

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

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        for layer in self.layers:
            x, c = layer.paged_verify(
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


def apply_layers(layers, x):
    """Apply ``layers`` in order: the one implementation Sequential's
    forward and the chunked-head train and eval paths (``compile(
    head_chunks=)``, which apply a Sequential's body without its head)
    share, as the JAX package's ``apply_layers``. The ambient rng is split
    once across the layers that need one, in order (JAX's routing); the
    others are called with no rng scope of their own."""
    rng = current_rng()
    users = [layer for layer in layers if needs_rng(layer)]
    keys = (threefry.split(rng, len(users))
            if rng is not None and users else None)
    j = 0
    for layer in layers:
        if needs_rng(layer):
            x = _call_with_rng(layer, x, None if keys is None else keys[j])
            j += 1
        else:
            x = layer(x)
    return x


def param_tree(module) -> Dict[str, torch.Tensor]:
    """``{tree path: tensor}`` of a module's parameters, and of the
    ``q``/``scale`` buffers of its quantized weights (``quant``), paths as
    in the JAX tree (``residual_1/main/dense/kernel/q``)."""
    tree = {n.replace(".", SEP): p for n, p in module.named_parameters()}
    for name, sub in module.named_modules():
        if isinstance(sub, QuantizedWeight):
            for leaf in (QKEY, SKEY):
                tree[f"{name.replace('.', SEP)}{SEP}{leaf}"] = getattr(
                    sub, leaf)
    return tree


def state_tree(module) -> Dict[str, torch.Tensor]:
    """``{tree path: buffer}`` of a module's state (BatchNorm's running
    statistics): every buffer but the quantized weights' payloads."""
    quant = {name for name, sub in module.named_modules()
             if isinstance(sub, QuantizedWeight)}
    return {n.replace(".", SEP): b for n, b in module.named_buffers()
            if n.rpartition(".")[0] not in quant}


class Residual(Layer):
    """Skip connection: ``y = activation(main(x) + shortcut(x))``, the
    shortcut the identity by default, as the JAX package's Residual. The
    branches register as ``main`` and ``shortcut`` (the JAX tree's keys),
    and so do their caches: every decode path runs both branches, each on
    its own cache or paged pool."""

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

    @property
    def needs_rng(self) -> bool:
        return needs_rng(self.main) or (self.shortcut is not None
                                        and needs_rng(self.shortcut))

    def forward(self, x):
        if not self.needs_rng:
            sc = x if self.shortcut is None else self.shortcut(x)
            return self.activation(self.main(x) + sc)
        # JAX's Residual: split(rng, 2), main takes the first key and the
        # shortcut the second, each only when it needs one.
        rng = current_rng()
        keys = None if rng is None else threefry.split(rng, 2)
        y = _call_with_rng(self.main, x, None if keys is None
                           or not needs_rng(self.main) else keys[0])
        if self.shortcut is None:
            sc = x
        else:
            sc = _call_with_rng(self.shortcut, x, None if keys is None
                                or not needs_rng(self.shortcut) else keys[1])
        return self.activation(y + sc)

    def dtype_hints(self):
        hints = {}
        for key, branch in (("main", self.main), ("shortcut", self.shortcut)):
            h = None if branch is None else branch.dtype_hints()
            if h is not None and h != {}:
                hints[key] = h
        return hints

    def sharding_hints(self):
        hints = {}
        for key, branch in (("main", self.main), ("shortcut", self.shortcut)):
            h = None if branch is None else branch.sharding_hints()
            if h:
                hints[key] = h
        return hints

    def init_cache(self, batch, max_len, dtype, device):
        caches = {}
        c = self.main.init_cache(batch, max_len, dtype, device)
        if c:
            caches["main"] = c
        if self.shortcut is not None:
            c = self.shortcut.init_cache(batch, max_len, dtype, device)
            if c:
                caches["shortcut"] = c
        return caches

    def decode(self, cache, x, *, pos):
        y, cm = self.main.decode(cache.get("main", {}), x, pos=pos)
        new_cache = dict(cache)
        if cm:
            new_cache["main"] = cm
        if self.shortcut is not None:
            sc, cs = self.shortcut.decode(cache.get("shortcut", {}), x,
                                          pos=pos)
            if cs:
                new_cache["shortcut"] = cs
        else:
            sc = x
        return self.activation(y + sc), new_cache

    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        caches = {}
        for key, branch in (("main", self.main), ("shortcut", self.shortcut)):
            c = None if branch is None else branch.init_paged_cache(
                num_blocks, block_size, dtype, device)
            if c:
                caches[key] = c
        return caches

    def _paged(self, hook, cache, x, **kw):
        """``hook`` (a paged path's name) through both branches over the
        same block tables and positions, each on its own pool
        (``cache["main"]``, ``cache["shortcut"]``), the shortcut's output
        added before the activation; the identity shortcut adds ``x``."""
        y, c = getattr(self.main, hook)(cache.get("main", {}), x, **kw)
        if c:
            cache["main"] = c
        sc = x
        if self.shortcut is not None:
            sc, c = getattr(self.shortcut, hook)(
                cache.get("shortcut", {}), x, **kw)
            if c:
                cache["shortcut"] = c
        return self.activation(y + sc), cache

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        return self._paged("paged_decode", cache, x,
                           block_tables=block_tables, positions=positions,
                           decode_kernel=decode_kernel)

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        return self._paged("paged_verify", cache, x,
                           block_tables=block_tables, positions=positions,
                           decode_kernel=decode_kernel)

    def paged_prefill(self, cache, x, *, block_table, start):
        return self._paged("paged_prefill", cache, x,
                           block_table=block_table, start=start)


class Lambda(Layer):
    """Wrap a stateless function ``fn(x) -> y`` of torch tensors. The
    output shape is ``output_shape`` when given, else inferred at
    ``build`` by running ``fn`` on a ``meta`` tensor of the input shape
    (no data, no device work), as the JAX layer's ``eval_shape``."""

    # The function is opaque: it may mix positions (a mean over time), so
    # one-token decode cannot be assumed exact.
    decode_safe = False

    def __init__(self, fn, output_shape=None, name: Optional[str] = None):
        super().__init__(name)
        self.fn = fn
        self._output_shape = output_shape

    def build(self, input_shape, generator):
        if self._output_shape is not None:
            return tuple(self._output_shape)
        probe = torch.empty((1,) + tuple(input_shape), device="meta")
        return tuple(self.fn(probe).shape[1:])

    def forward(self, x):
        return self.fn(x)


__all__ = ["Lambda", "Layer", "NameScope", "Residual", "Sequential", "Shape",
           "apply_layers", "current_rng", "draw_block", "local_draw_scope",
           "local_draws",
           "needs_rng", "param_tree", "rng_scope", "state_tree",
           "tp_layout"]
