"""Multi-head attention and learned positional embeddings.

Scores and softmax compute in f32 whatever the activation dtype, and
probabilities are cast to the value dtype before the product with V — the
JAX package's arithmetic. The full-sequence pass takes one of two paths,
chosen by ``flash`` as in the JAX layer: dense attention (scores divided
by ``sqrt(head_dim)``, the (T, T) scores formed) or flash attention
(``ops.flash_attention``: scores multiplied by ``1/sqrt(head_dim)``, the
CUDA kernels on a card, their plain versions on the CPU).
Under a sequence-parallel strategy (a seq mesh axis larger than 1) the
full-sequence pass runs across the ranks instead, as the JAX layer's
dispatch: ring attention (``ops.ring_attention``) or Ulysses (two
all-to-alls around flash attention over the whole sequence for a block
of heads). Under ``DataTensorParallel`` the layer projects this rank's
heads from its column blocks of ``wq``/``wk``/``wv`` (heads ``[r*H/tp,
(r+1)*H/tp)``: the inner width is head-major), attends over them, and
all-reduces ``wo``'s row-block product before ``bo``.
Projections are 2-D ``(d, heads*head_dim)`` kernels named ``wq, wk, wv,
wo`` with biases ``bq, bk, bv, bo``, as in the JAX parameter tree. Every
path that reads a weight (forward, decode, paged decode, verify and
prefill) takes it through ``Layer._weight``: cast to the ambient policy's
compute dtype, and dequantized first when it is int8 (``quant``).

Paged KV (``serving.Engine``): one pool of fixed-size blocks per layer,
shared by every slot and addressed through per-slot block tables. New
K/V rows are scattered into the pools IN PLACE. Under tensor
parallelism (the engine dispatches inside the model's strategy scope) a
rank's pools hold its heads only, ``(NB, bs, H/m, hd)``, and the paged
paths project, cache and attend over them as ``forward`` does. Decode
and speculative verification (K candidate rows a slot) read either
through the gathered view (``decode_kernel="reference"``) or through the
fused kernel (``ops.paged_attention``, ``"fused"``); prefill always
reads through the view.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import initializers
from .core import Layer, Shape, tp_layout
from ..ops import paged_attention as paged_ops
from ..ops._common import NEG
from ..ops.flash_attention import dense_attention, flash_attention
from ..parallel import collectives
from ..parallel.collectives import layout_of
from ..parallel.strategy import current_strategy
from ..precision import resolve_dtype
from ..quant import _QMAX, QKEY, SKEY, QuantizedWeight


def _kv_block_size(pool) -> int:
    """Block size of one paged layer pool — plain tensor or an int8
    ``{"q","scale"}`` pair."""
    return (pool[QKEY] if isinstance(pool, dict) else pool).shape[1]


def _kv_scatter(pool, blk, off, rows):
    """Write K/V ``rows`` (..., H, hd) into ``pool[blk, off]`` in place
    (index tensors share the rows' leading shape) and return the pool.

    Plain pools take the rows cast to the pool dtype. int8 pools quantize
    on scatter, row-wise: each (position, head) row gets its own scale
    ``amax(|row|)/127`` (1 for an all-zero row, so the dequantize stays
    finite and the never-written trash block reads as exact zeros)."""
    if not isinstance(pool, dict):
        pool[blk, off] = rows.to(pool.dtype)
        return pool
    r = rows.to(torch.float32)
    amax = r.abs().amax(dim=-1, keepdim=True)  # (..., H, 1)
    scale = torch.where(amax > 0, amax / _QMAX, 1.0)
    q = torch.clamp(torch.round(r / scale), -_QMAX, _QMAX).to(torch.int8)
    pool[QKEY][blk, off] = q
    pool[SKEY][blk, off] = scale
    return pool


def _require_causal(layer):
    if not layer.causal:
        raise NotImplementedError(
            "incremental decode requires causal attention "
            "(MultiHeadAttention(causal=True)); bidirectional models "
            "have no autoregressive decode"
        )


class MultiHeadAttention(Layer):
    """Multi-head self-attention over (B, T, D) inputs. ``head_dim``
    (default ``d // num_heads``) sets the projections' inner width
    ``num_heads * head_dim``; ``use_bias=False`` registers no biases (the
    JAX layer's tree paths). ``ring_axis`` names the mesh axis the layer
    runs ring or Ulysses attention over when the ambient strategy's mesh
    has it larger than 1 (``DataSeqParallel``); None keeps the
    one-rank paths even then."""

    def __init__(
        self,
        num_heads: int,
        head_dim: Optional[int] = None,
        *,
        causal: bool = False,
        use_bias: bool = True,
        dtype=None,
        ring_axis: Optional[str] = "seq",
        flash="auto",
        name: Optional[str] = None,
    ):
        super().__init__(name)
        if flash not in (True, False, "auto"):
            raise ValueError(f"flash must be True, False or 'auto', got "
                             f"{flash!r}")
        self.num_heads = int(num_heads)
        self.head_dim = head_dim
        self.causal = bool(causal)
        self.use_bias = use_bias
        self.flash = flash
        self.dtype = dtype
        self.ring_axis = ring_axis

    def build(self, input_shape: Shape, generator):
        d = input_shape[-1]
        if self.head_dim is None and d % self.num_heads:
            raise ValueError(
                f"d_model {d} not divisible by num_heads {self.num_heads}"
            )
        inner = self.num_heads * (self.head_dim or d // self.num_heads)
        init = initializers.glorot_uniform()
        for w in ("wq", "wk", "wv"):
            setattr(self, w, torch.nn.Parameter(init(generator, (d, inner))))
        self.wo = torch.nn.Parameter(init(generator, (inner, d)))
        if self.use_bias:
            for b in ("bq", "bk", "bv"):
                setattr(self, b, torch.nn.Parameter(torch.zeros(inner)))
            self.bo = torch.nn.Parameter(torch.zeros(d))
        return tuple(input_shape)

    @property
    def _hd(self) -> int:
        # The full projection's width: a stored leaf may be a block of it
        # (FSDP), or an int8 payload.
        w = self.wq
        t = w.q if isinstance(w, QuantizedWeight) else w
        lay = layout_of(t)
        return (lay.shape if lay is not None else tuple(t.shape))[1] \
            // self.num_heads

    def _proj(self, x, w, b):
        # int8 weights dequantize here (f32), then the compute-dtype cast.
        kernel = self._weight(w)
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            kernel = kernel.to(dt)
        y = x @ kernel
        return y + self._weight(b).to(y.dtype) if self.use_bias else y

    def _out(self, ctx, tp=None):
        y = ctx @ self._weight("wo").to(ctx.dtype)
        if tp is not None:  # wo's row blocks: partial sums, then bo once
            y = collectives.reduce_from_group(y, tp.group)
        return y + self._weight("bo").to(y.dtype) if self.use_bias else y

    def _cache_dtype(self, dtype):
        """The KV cache's dtype: the layer's own ``dtype=``, else the
        engine's or ``generate``'s (the model's decode dtype)."""
        return dtype if self.dtype is None else resolve_dtype(self.dtype)

    def _qkv(self, x, lead_q, lead_kv):
        """Cast ``x`` to the layer dtype and project it; q reshaped to
        ``lead_q + (H, hd)``, k and v to ``lead_kv + (H, hd)``."""
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            x = x.to(dt)
        # -1 heads: a tensor-parallel rank projects its block of them.
        hd = (-1, self._hd)
        return (
            self._proj(x, "wq", "bq").reshape(*lead_q, *hd),
            self._proj(x, "wk", "bk").reshape(*lead_kv, *hd),
            self._proj(x, "wv", "bv").reshape(*lead_kv, *hd),
        )

    def _use_flash(self, x) -> bool:
        """``flash=True``: always (the plain versions on a CPU tensor);
        ``"auto"``: from 512 positions on, on the card (the JAX layer's
        rule, with "TPU backend" read as "CUDA tensor"); ``False``: never."""
        if self.flash == "auto":
            return x.shape[1] >= 512 and x.is_cuda
        return bool(self.flash)

    def sharding_hints(self):
        hints = {"wq": "col", "wk": "col", "wv": "col", "wo": "row"}
        if self.use_bias:
            hints.update(bq="col", bk="col", bv="col")
        return hints

    def _ring_config(self):
        """``(strategy, mode)`` when the ambient strategy splits the
        sequence over ``ring_axis`` (size > 1), mode "ring" or "ulysses";
        else None."""
        if self.ring_axis is None:
            return None
        strategy = current_strategy()
        sizes = getattr(strategy, "axis_sizes", {})
        if sizes.get(self.ring_axis, 1) <= 1:
            return None
        return strategy, getattr(strategy, "seq_attention", "ring")

    def _ulysses_attention(self, q, k, v, strategy):
        """All-to-all sequence parallelism (DeepSpeed-Ulysses): (B, T/s,
        H, D) blocks -> (B, T, H/s, D), attention over the whole sequence
        for this rank's heads (flash where ``_use_flash`` takes it, so
        memory stays O(T*D)), and back."""
        group = strategy.mesh.get_group(self.ring_axis)
        n = strategy.axis_sizes[self.ring_axis]
        heads = q.shape[2]  # this rank's: H/m under a model split
        if heads % n:
            raise ValueError(
                f"Ulysses attention shards heads over the {self.ring_axis!r}"
                f" axis: num_heads {self.num_heads}"
                + (f" ({heads} a rank of the model line)"
                   if heads != self.num_heads else "")
                + f" not divisible by its size {n}")
        q, k, v = (collectives.ulysses_to_heads(a, group) for a in (q, k, v))
        if self._use_flash(q):
            ctx = flash_attention(q, k, v, causal=self.causal)
        else:
            ctx = dense_attention(q, k, v, self.causal)
        return collectives.ulysses_to_seq(ctx, group)

    def _tp(self):
        """The layout of this rank's column block of ``wq`` under tensor
        parallelism (heads ``[r*H/m, (r+1)*H/m)``), else None; heads
        that the model line does not divide raise."""
        tp = tp_layout(self, "wq")
        if tp is not None and self.num_heads % tp.n:
            raise ValueError(
                f"num_heads {self.num_heads} not divisible by the "
                f"model axis size {tp.n}")
        return tp

    def _tp_input(self, x):
        """``(x, tp)``: under tensor parallelism ``x``, cast to the layer
        dtype, enters the model line through ``copy_to_group``. Every
        path that projects (forward, paged decode, verify and prefill)
        starts here."""
        tp = self._tp()
        if tp is None:
            return x, None
        dt = resolve_dtype(self.dtype)
        return collectives.copy_to_group(x if dt is None else x.to(dt),
                                         tp.group), tp

    def forward(self, x):
        b, t, _ = x.shape
        x, tp = self._tp_input(x)
        q, k, v = self._qkv(x, (b, t), (b, t))
        ring = self._ring_config()
        if ring is not None:
            strategy, mode = ring
            if mode == "ulysses":
                ctx = self._ulysses_attention(q, k, v, strategy)
            else:
                from ..ops.ring_attention import ring_attention

                ctx = ring_attention(q, k, v, mesh=strategy.mesh,
                                     seq_axis=self.ring_axis,
                                     batch_axis=strategy.axis,
                                     causal=self.causal)
        elif self._use_flash(x):
            ctx = flash_attention(q, k, v, causal=self.causal)
        else:
            ctx = dense_attention(q, k, v, self.causal)
        return self._out(ctx.reshape(b, t, -1), tp)

    # ------------------------------------------------- incremental decode --
    def init_cache(self, batch, max_len, dtype, device):
        """Dense ``(B, max_len, H, hd)`` K and V caches in the layer's
        dtype, else the decode dtype."""
        shape = (batch, max_len, self.num_heads, self._hd)
        cdtype = self._cache_dtype(dtype)
        return {name: torch.zeros(shape, dtype=cdtype, device=device)
                for name in ("k", "v")}

    def decode(self, cache, x, *, pos):
        """One-token attention over the dense cache, as the JAX layer's:
        x (B, 1, D); the new K/V row is written at ``pos`` (in place),
        f32 scores scaled by ``1/sqrt(hd)`` are masked beyond ``pos``, and
        the softmax is cast to q's dtype before the product with V."""
        _require_causal(self)
        b = x.shape[0]
        q, k, v = self._qkv(x, (b, 1), (b, 1))
        ck, cv = cache["k"], cache["v"]
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        scores = torch.einsum(
            "bqhd,bkhd->bhqk", q.to(torch.float32), ck.to(torch.float32)
        ) / math.sqrt(q.shape[-1])  # (B, H, 1, Tmax)
        visible = torch.arange(ck.shape[1], device=x.device) <= pos
        scores = torch.where(visible, scores, NEG)
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, cv.to(q.dtype))
        return self._out(ctx.reshape(b, 1, -1)), {"k": ck, "v": cv}

    # ------------------------------------------- paged (block) KV cache --
    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        # Under tensor parallelism a rank pools its own heads [r*H/m,
        # (r+1)*H/m), the block its column blocks project.
        tp = self._tp()
        heads = self.num_heads if tp is None else self.num_heads // tp.n
        shape = (num_blocks, block_size, heads, self._hd)
        if dtype == torch.int8:
            # int8 KV: per-(position, head) dynamic scales beside the
            # payload (_kv_scatter); the same {"q","scale"} idiom as quant.
            return {
                name: {
                    QKEY: torch.zeros(shape, dtype=torch.int8, device=device),
                    SKEY: torch.ones(shape[:-1] + (1,), device=device),
                }
                for name in ("k", "v")
            }
        cdtype = self._cache_dtype(dtype)
        return {
            name: torch.zeros(shape, dtype=cdtype, device=device)
            for name in ("k", "v")
        }

    def _view_attention(self, q, ck, cv, block_tables, visible):
        """Dense masked attention of q (S, K, H, hd) over the gathered
        views; ``visible`` (S, K, L) is each query row's causal mask."""
        view_vis = visible.any(dim=1)  # (S, L): what any row can expose
        view_k = paged_ops.paged_view(ck, block_tables, q.dtype,
                                      visible=view_vis)
        view_v = paged_ops.paged_view(cv, block_tables, q.dtype,
                                      visible=view_vis)
        scores = torch.einsum(
            "bqhd,bkhd->bhqk", q.to(torch.float32), view_k.to(torch.float32)
        ) / math.sqrt(q.shape[-1])  # (S, H, K, L)
        scores = torch.where(visible[:, None], scores, NEG)
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, view_v)

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel=paged_ops.REFERENCE):
        """One-token attention for S slots at per-slot positions: x
        (S, 1, D); each slot's new K/V row is scattered into the pool block
        its position maps to, scores masked to positions <= positions[s].
        Inactive slots point their whole table at the trash block, so
        their writes land outside every live sequence. ``decode_kernel``
        picks the read: "reference" gathers the view and runs dense
        attention, "fused" calls ``ops.paged_attention``."""
        _require_causal(self)
        s = x.shape[0]
        bs = _kv_block_size(cache["k"])
        x, tp = self._tp_input(x)
        q, k, v = self._qkv(x, (s, 1), (s,))
        pos = positions.long()
        slots = torch.arange(s, device=x.device)
        blk = block_tables[slots, pos // bs].long()  # (S,) write blocks
        off = pos % bs
        ck = _kv_scatter(cache["k"], blk, off, k)
        cv = _kv_scatter(cache["v"], blk, off, v)
        if decode_kernel == paged_ops.FUSED:
            ctx = paged_ops.paged_attention(q, ck, cv, block_tables, positions)
        else:
            ll = block_tables.shape[1] * bs
            visible = (
                torch.arange(ll, device=x.device)[None] <= pos[:, None]
            )[:, None, :]  # (S, 1, L)
            ctx = self._view_attention(q, ck, cv, block_tables, visible)
        return self._out(ctx.reshape(s, 1, -1), tp), {"k": ck, "v": cv}

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel=paged_ops.REFERENCE):
        """Speculative-verification attention: x (S, K, D) holds, per slot,
        K candidate tokens at consecutive absolute positions
        [positions[s], positions[s] + K), scored in one pass (K=1 is
        ``paged_decode``). Each candidate's K/V row is scattered at its own
        position and its scores are masked to positions <= its own, so
        column j's output equals what decode would give after accepting
        candidates 0..j-1. Rejected candidates leave stale rows that no
        later read can see before they are overwritten."""
        _require_causal(self)
        s, kw, _ = x.shape
        bs = _kv_block_size(cache["k"])
        x, tp = self._tp_input(x)
        q, k, v = self._qkv(x, (s, kw), (s, kw))
        abs_pos = positions.long()[:, None] + torch.arange(
            kw, device=x.device)[None]  # (S, K)
        blk = torch.gather(block_tables.long(), 1, abs_pos // bs)
        off = abs_pos % bs
        ck = _kv_scatter(cache["k"], blk, off, k)
        cv = _kv_scatter(cache["v"], blk, off, v)
        if decode_kernel == paged_ops.FUSED:
            # Candidate row k of slot s masks itself to positions <=
            # positions[s] + k inside the kernel.
            ctx = paged_ops.paged_attention(q, ck, cv, block_tables, positions)
        else:
            ll = block_tables.shape[1] * bs
            visible = (
                torch.arange(ll, device=x.device)[None, None, :]
                <= abs_pos[:, :, None]
            )  # (S, K, L): candidate j attends through its own position
            # The view-level mask is the K rows' union, positions <=
            # positions + K - 1 (_view_attention: visible.any over rows).
            ctx = self._view_attention(q, ck, cv, block_tables, visible)
        return self._out(ctx.reshape(s, kw, -1), tp), {"k": ck, "v": cv}

    def paged_prefill(self, cache, x, *, block_table, start):
        """Prompt-chunk prefill for one sequence: x (1, C, D) covers
        absolute positions [start, start+C). The chunk's K/V is computed
        in one parallel pass, scattered into the sequence's blocks, and
        attention runs against the cached prefix + chunk, so chunk i
        attends to chunks < i through the pool."""
        _require_causal(self)
        c = x.shape[1]
        bs = _kv_block_size(cache["k"])
        x, tp = self._tp_input(x)
        q, k, v = self._qkv(x, (1, c), (c,))
        abs_pos = start + torch.arange(c, device=x.device)  # (C,)
        blk = block_table.long()[abs_pos // bs]
        off = abs_pos % bs
        ck = _kv_scatter(cache["k"], blk, off, k)
        cv = _kv_scatter(cache["v"], blk, off, v)
        ll = block_table.shape[0] * bs
        visible = (
            torch.arange(ll, device=x.device)[None, :] <= abs_pos[:, None]
        )[None]  # (1, C, L): causal against each query's position
        ctx = self._view_attention(q, ck, cv, block_table[None], visible)
        return self._out(ctx.reshape(1, c, -1), tp), {"k": ck, "v": cv}


class PositionalEmbedding(Layer):
    """Learned absolute positions, added to (B, T, D) activations."""

    def __init__(self, max_len: int, name: Optional[str] = None):
        super().__init__(name)
        self.max_len = int(max_len)

    def build(self, input_shape: Shape, generator):
        t, d = input_shape
        if t > self.max_len:
            raise ValueError(
                f"sequence length {t} exceeds max_len {self.max_len}"
            )
        self.table = torch.nn.Parameter(
            initializers.normal(0.02)(generator, (self.max_len, d)))
        return tuple(input_shape)

    def forward(self, x):
        # Under sequence parallelism a rank holds positions [off, off+t).
        t = x.shape[1]
        strategy = current_strategy()
        off = 0 if strategy is None else strategy.seq_offset(t)
        if off + t > self.max_len:
            raise ValueError(
                f"positions [{off}, {off + t}) exceed max_len {self.max_len}")
        return x + self._weight("table")[off:off + t][None].to(x.dtype)

    def init_cache(self, batch, max_len, dtype, device):
        if max_len > self.max_len:
            raise ValueError(
                f"generation length {max_len} exceeds positional table "
                f"max_len {self.max_len}"
            )
        return {}

    def decode(self, cache, x, *, pos):
        return x + self._weight("table")[pos][None, None].to(x.dtype), cache

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        # Per-SLOT positions: slot s reads table row positions[s].
        rows = self._weight("table")[positions.long()]  # (S, D)
        return x + rows[:, None].to(x.dtype), cache

    def paged_verify(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        # Slot s's K candidates sit at positions[s] + 0..K-1.
        abs_pos = positions.long()[:, None] + torch.arange(
            x.shape[1], device=x.device)[None]
        return x + self._weight("table")[abs_pos].to(x.dtype), cache

    def paged_prefill(self, cache, x, *, block_table, start):
        c = x.shape[1]
        if start + c > self.max_len:
            raise ValueError(
                f"positions [{start}, {start + c}) exceed max_len "
                f"{self.max_len}"
            )
        return (x + self._weight("table")[start:start + c][None].to(x.dtype),
                cache)


__all__ = ["MultiHeadAttention", "PositionalEmbedding"]
