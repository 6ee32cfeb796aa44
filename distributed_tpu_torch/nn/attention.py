"""Multi-head attention and learned positional embeddings.

Scores and softmax compute in f32 whatever the activation dtype, and
probabilities are cast to the value dtype before the product with V — the
JAX package's arithmetic. The full-sequence pass takes one of two paths,
chosen by ``flash`` as in the JAX layer: dense attention (scores divided
by ``sqrt(head_dim)``, the (T, T) scores formed) or flash attention
(``ops.flash_attention``: scores multiplied by ``1/sqrt(head_dim)``, the
CUDA kernels on a card, their plain versions on the CPU).
Projections are 2-D ``(d, heads*head_dim)`` kernels named ``wq, wk, wv,
wo`` with biases ``bq, bk, bv, bo``, as in the JAX parameter tree.

Paged KV (``serving.Engine``): one pool of fixed-size blocks per layer,
shared by every slot and addressed through per-slot block tables. New
K/V rows are scattered into the pools IN PLACE. Decode reads either
through the gathered view (``decode_kernel="reference"``) or through the
fused kernel (``ops.paged_attention``, ``"fused"``); prefill always reads
through the view.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import initializers
from .core import Layer, Shape
from ..ops import paged_attention as paged_ops
from ..ops._common import NEG
from ..ops.flash_attention import dense_attention, flash_attention
from ..precision import resolve_dtype
from ..quant import _QMAX, QKEY, SKEY


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
    """Multi-head self-attention over (B, T, D) inputs."""

    def __init__(
        self,
        num_heads: int,
        *,
        causal: bool = False,
        flash="auto",
        dtype=None,
        name: Optional[str] = None,
    ):
        super().__init__(name)
        if flash not in (True, False, "auto"):
            raise ValueError(f"flash must be True, False or 'auto', got "
                             f"{flash!r}")
        self.num_heads = int(num_heads)
        self.causal = bool(causal)
        self.flash = flash
        self.dtype = dtype

    def build(self, input_shape: Shape, generator):
        d = input_shape[-1]
        if d % self.num_heads:
            raise ValueError(
                f"d_model {d} not divisible by num_heads {self.num_heads}"
            )
        init = initializers.glorot_uniform()
        for w in ("wq", "wk", "wv", "wo"):
            setattr(self, w, torch.nn.Parameter(init(generator, (d, d))))
        for b in ("bq", "bk", "bv", "bo"):
            setattr(self, b, torch.nn.Parameter(torch.zeros(d)))
        return tuple(input_shape)

    @property
    def _hd(self) -> int:
        return self.wq.shape[1] // self.num_heads

    def _proj(self, x, w, b):
        kernel = getattr(self, w)
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            kernel = kernel.to(dt)
        return x @ kernel + getattr(self, b).to(x.dtype)

    def _out(self, ctx):
        return ctx @ self.wo.to(ctx.dtype) + self.bo.to(ctx.dtype)

    def _qkv(self, x, lead_q, lead_kv):
        """Cast ``x`` to the layer dtype and project it; q reshaped to
        ``lead_q + (H, hd)``, k and v to ``lead_kv + (H, hd)``."""
        dt = resolve_dtype(self.dtype)
        if dt is not None:
            x = x.to(dt)
        hd = (self.num_heads, self._hd)
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

    def forward(self, x):
        b, t, _ = x.shape
        q, k, v = self._qkv(x, (b, t), (b, t))
        if self._use_flash(x):
            ctx = flash_attention(q, k, v, causal=self.causal)
        else:
            ctx = dense_attention(q, k, v, self.causal)
        return self._out(ctx.reshape(b, t, -1))

    # ------------------------------------------- paged (block) KV cache --
    def init_paged_cache(self, num_blocks, block_size, dtype, device):
        shape = (num_blocks, block_size, self.num_heads, self._hd)
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
        cdtype = resolve_dtype(self.dtype) or dtype
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
        return self._out(ctx.reshape(s, 1, -1)), {"k": ck, "v": cv}

    def paged_prefill(self, cache, x, *, block_table, start):
        """Prompt-chunk prefill for one sequence: x (1, C, D) covers
        absolute positions [start, start+C). The chunk's K/V is computed
        in one parallel pass, scattered into the sequence's blocks, and
        attention runs against the cached prefix + chunk, so chunk i
        attends to chunks < i through the pool."""
        _require_causal(self)
        c = x.shape[1]
        bs = _kv_block_size(cache["k"])
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
        return self._out(ctx.reshape(1, c, -1)), {"k": ck, "v": cv}


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
        t = x.shape[1]
        return x + self.table[:t][None].to(x.dtype)

    def paged_decode(self, cache, x, *, block_tables, positions,
                     decode_kernel="reference"):
        # Per-SLOT positions: slot s reads table row positions[s].
        rows = self.table[positions.long()]  # (S, D)
        return x + rows[:, None].to(x.dtype), cache

    def paged_prefill(self, cache, x, *, block_table, start):
        c = x.shape[1]
        if start + c > self.max_len:
            raise ValueError(
                f"positions [{start}, {start + c}) exceed max_len "
                f"{self.max_len}"
            )
        return x + self.table[start:start + c][None].to(x.dtype), cache


__all__ = ["MultiHeadAttention", "PositionalEmbedding"]
