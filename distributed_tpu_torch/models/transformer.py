"""Decoder-only Transformer language model.

Pre-LN blocks built from the same Residual/Sequential primitives as the
JAX package, so the parameter tree paths (``residual_N/main/...``) are
identical and weights carry across. Only dense blocks are ported; the
MoE, pipelined, scanned and rematerialized variants raise.
"""

from __future__ import annotations

from typing import Optional

from .. import nn


def transformer_block(
    d_model: int,
    num_heads: int,
    d_ff: int,
    *,
    flash="auto",
    dtype=None,
) -> list:
    """Pre-LN block as two Residuals: [LN -> MHA] + [LN -> MLP].
    ``flash`` passes through to MultiHeadAttention (True/False/'auto')."""
    attn = nn.Residual(
        nn.Sequential(
            [
                nn.LayerNorm(),
                nn.MultiHeadAttention(num_heads, causal=True, flash=flash,
                                      dtype=dtype),
            ],
            name="main",
        )
    )
    # Flat layer list (not nested in a named container): the param tree
    # paths residual_N/main/{dense,dense_1} are a checkpoint format.
    mlp = nn.Residual(nn.Sequential(
        [
            nn.LayerNorm(),
            nn.Dense(d_ff, activation="gelu", dtype=dtype),
            nn.Dense(d_model, dtype=dtype),
        ],
        name="main",
    ))
    return [attn, mlp]


def transformer_lm(
    vocab_size: int,
    *,
    num_layers: int = 2,
    d_model: int = 128,
    num_heads: int = 4,
    d_ff: Optional[int] = None,
    max_len: int = 512,
    moe_experts: int = 0,
    pipeline: bool = False,
    scan: bool = False,
    remat: bool = False,
    flash="auto",
    dtype=None,
) -> nn.Sequential:
    """Token-in, logits-out LM: (B, T) int tokens -> (B, T, vocab).

    ``flash`` picks each attention layer's full-sequence path (see
    ``nn.MultiHeadAttention``). ``moe_experts``, ``pipeline``, ``scan``
    and ``remat`` select variants that are not ported yet and raise
    ``NotImplementedError``."""
    for flag, value in (("moe_experts", moe_experts), ("pipeline", pipeline),
                        ("scan", scan), ("remat", remat)):
        if value:
            raise NotImplementedError(f"transformer_lm({flag}=...): not yet ported")
    d_ff = d_ff or 4 * d_model
    layers = [
        nn.Embedding(vocab_size, d_model, dtype=dtype),
        nn.PositionalEmbedding(max_len),
    ]
    for _ in range(num_layers):
        layers += transformer_block(d_model, num_heads, d_ff, flash=flash,
                                    dtype=dtype)
    layers += [nn.LayerNorm(), nn.Dense(vocab_size, dtype=dtype)]
    return nn.Sequential(layers, name="transformer_lm")


__all__ = ["transformer_block", "transformer_lm"]
