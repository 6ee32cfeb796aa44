"""Decoder-only Transformer language model.

Pre-LN blocks built from the same Residual/Sequential primitives as the
JAX package, so the parameter tree paths (``residual_N/main/...``, and
``scanned_blocks/blocks/residual/main/...`` stacked) are identical and
weights carry across. Dense blocks, unrolled or weight-stacked
(``scan=True``), with or without remat, are ported; the MoE and
pipelined variants, and their options, raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

from .. import nn


def _unported(where: str, item: str, **options) -> None:
    """Raise for each option that is not at the JAX default given as
    ``name=(value, default)``: those variants are not ported yet."""
    for name, (value, default) in options.items():
        if value != default:
            raise NotImplementedError(
                f"{where}({name}=...): not yet ported (ROADMAP {item})")


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
    """Pre-LN block as two Residuals: [LN -> MHA] + [LN -> MLP].
    ``causal`` and ``flash`` pass through to MultiHeadAttention;
    ``moe_experts`` (an nn.MoE FFN) raises."""
    _unported("transformer_block", "1.7", moe_experts=(moe_experts, 0))
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
    # Flat layer list (not nested in a named container): the param tree
    # paths residual_N/main/{dense,dense_1} are a checkpoint format.
    mlp = nn.Residual(nn.Sequential(
        [
            nn.LayerNorm(),
            nn.Dense(d_ff, activation="gelu", shard="col", dtype=dtype),
            nn.Dense(d_model, shard="row", dtype=dtype),
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
    ``overlap`` (``"require"`` raises: the port has no FSDP gather,
    ROADMAP 1.7). The MoE options (``moe_experts``, ``moe_every``) and
    ``pipeline`` with its schedule options raise naming ROADMAP 1.7, only
    when set away from the JAX default; MoE or ``pipeline`` with ``scan``
    raise JAX's ``ValueError`` first."""
    if pipeline or scan:
        if moe_experts:
            raise ValueError(
                "pipeline/scan block stacking does not support MoE blocks")
        if pipeline and scan:
            raise ValueError("pipeline and scan are mutually exclusive")
    _unported("transformer_lm", "1.7", moe_experts=(moe_experts, 0),
              moe_every=(moe_every, 2), pipeline=(pipeline, False),
              pipeline_schedule=(pipeline_schedule, "gpipe"),
              pipeline_interleave=(pipeline_interleave, 1))
    if remat:
        nn.remat.resolve_policy(remat_policy)  # fail fast on a bad name
    d_ff = d_ff or 4 * d_model
    layers = [
        nn.Embedding(vocab_size, d_model, dtype=dtype),
        nn.PositionalEmbedding(max_len),
    ]
    if scan:
        def make_block():
            block = nn.Sequential(transformer_block(
                d_model, num_heads, d_ff, causal=causal, flash=flash,
                dtype=dtype))
            return nn.Remat(block, policy=remat_policy) if remat else block

        layers.append(nn.ScannedBlocks(make_block, num_layers,
                                       overlap=scan_overlap))
    for _ in range(0 if scan else num_layers):
        block = transformer_block(d_model, num_heads, d_ff, causal=causal,
                                  flash=flash, dtype=dtype)
        if remat:
            block = [nn.Remat(residual, policy=remat_policy)
                     for residual in block]
        layers += block
    layers += [nn.LayerNorm(), nn.Dense(vocab_size, dtype=dtype)]
    return nn.Sequential(layers, name="transformer_lm")


__all__ = ["transformer_block", "transformer_lm"]
