"""Decoder-only Transformer language model.

Pre-LN blocks built from the same Residual/Sequential primitives as the
JAX package, so the parameter tree paths (``residual_N/main/...``,
``scanned_blocks/blocks/residual/main/...`` stacked and
``pipelined_blocks/blocks/...`` pipelined) are identical and weights
carry across. Dense or MoE blocks (every ``moe_every``-th FFN an
``nn.MoE``), unrolled, weight-stacked (``scan=True``) or pipelined
(``pipeline=True``), with or without remat.
"""

from __future__ import annotations

from typing import Optional

from .. import nn


def transformer_block(
    d_model: int,
    num_heads: int,
    d_ff: int,
    *,
    causal: bool = True,
    moe_experts: int = 0,
    flash="auto",
    dtype=None,
) -> list:
    """Pre-LN block as two Residuals: [LN -> MHA] + [LN -> MLP-or-MoE].
    ``causal`` and ``flash`` pass through to MultiHeadAttention;
    ``moe_experts > 0`` swaps the dense MLP for an ``nn.MoE`` with that
    many experts (expert-parallel under ``DataExpertParallel``)."""
    attn = nn.Residual(
        nn.Sequential(
            [
                nn.LayerNorm(),
                nn.MultiHeadAttention(num_heads, causal=causal, flash=flash,
                                      dtype=dtype),
            ],
            name="main",
        )
    )
    if moe_experts:
        ffn = [nn.LayerNorm(), nn.MoE(moe_experts, d_ff, dtype=dtype)]
    else:
        # Flat layer list (not nested in a named container): the param
        # tree paths residual_N/main/{dense,dense_1} are a checkpoint
        # format.
        ffn = [
            nn.LayerNorm(),
            nn.Dense(d_ff, activation="gelu", shard="col", dtype=dtype),
            nn.Dense(d_model, shard="row", dtype=dtype),
        ]
    return [attn, nn.Residual(nn.Sequential(ffn, name="main"))]


def transformer_lm(
    vocab_size: int,
    *,
    num_layers: int = 2,
    d_model: int = 128,
    num_heads: int = 4,
    d_ff: Optional[int] = None,
    max_len: int = 512,
    causal: bool = True,
    moe_experts: int = 0,
    moe_every: int = 2,
    pipeline: bool = False,
    pipeline_schedule: str = "gpipe",
    pipeline_interleave: int = 1,
    scan: bool = False,
    scan_overlap: str = "auto",
    remat: bool = False,
    remat_policy=None,
    flash="auto",
    dtype=None,
) -> nn.Sequential:
    """Token-in, logits-out LM: (B, T) int tokens -> (B, T, vocab).

    ``causal=False`` builds a bidirectional LM (no generation then), and
    ``flash`` picks each attention layer's full-sequence path (see
    ``nn.MultiHeadAttention``). ``remat=True`` wraps every attention and
    MLP residual in ``nn.Remat`` with ``remat_policy`` (a
    ``jax.checkpoint_policies`` name, e.g.
    ``"dots_with_no_batch_dims_saveable"``): the same numerics and tree
    paths, the block activations recomputed in the backward.
    ``scan=True`` stacks the blocks in one ``nn.ScannedBlocks`` (each
    block a ``Sequential`` of the two residuals, wrapped whole in
    ``nn.Remat`` under ``remat``): one (L, ...) tensor per leaf, served
    and generated through stacked caches. ``scan_overlap`` is its
    ``overlap``. ``pipeline=True`` stacks them in an
    ``nn.PipelinedBlocks`` (``pipeline_schedule``/``pipeline_interleave``
    its ``schedule``/``interleave``), pipelined over the pipe line under
    ``DataPipelineParallel`` and a sequential scan otherwise.
    ``moe_experts > 0`` makes every ``moe_every``-th block's FFN an
    ``nn.MoE``. MoE with ``scan`` or ``pipeline``, and ``scan`` with
    ``pipeline``, raise JAX's ``ValueError``."""
    if pipeline or scan:
        if moe_experts:
            raise ValueError(
                "pipeline/scan block stacking does not support MoE blocks")
        if pipeline and scan:
            raise ValueError("pipeline and scan are mutually exclusive")
    if remat:
        nn.remat.resolve_policy(remat_policy)  # fail fast on a bad name
    d_ff = d_ff or 4 * d_model
    layers = [
        nn.Embedding(vocab_size, d_model, dtype=dtype),
        nn.PositionalEmbedding(max_len),
    ]
    if scan or pipeline:
        def make_block():
            block = nn.Sequential(transformer_block(
                d_model, num_heads, d_ff, causal=causal, flash=flash,
                dtype=dtype))
            return nn.Remat(block, policy=remat_policy) if remat else block

        layers.append(
            nn.PipelinedBlocks(make_block, num_layers,
                               schedule=pipeline_schedule,
                               interleave=pipeline_interleave)
            if pipeline else
            nn.ScannedBlocks(make_block, num_layers, overlap=scan_overlap))
    for i in range(0 if scan or pipeline else num_layers):
        moe = (moe_experts if moe_experts and i % moe_every == moe_every - 1
               else 0)
        block = transformer_block(d_model, num_heads, d_ff, causal=causal,
                                  moe_experts=moe, flash=flash, dtype=dtype)
        if remat:
            block = [nn.Remat(residual, policy=remat_policy)
                     for residual in block]
        layers += block
    layers += [nn.LayerNorm(), nn.Dense(vocab_size, dtype=dtype)]
    return nn.Sequential(layers, name="transformer_lm")


__all__ = ["transformer_block", "transformer_lm"]
