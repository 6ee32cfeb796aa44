"""Vision Transformer (ViT) family, NHWC, as the JAX package's ``models/vit.py``.

(B, H, W, C) images -> (B, num_classes) logits: a patch-embedding
``Conv2D(d_model, patch, strides=patch)`` named ``patch_embed``, a
``Lambda`` (``patches_to_tokens``) flattening the patch grid into tokens,
learned positions, non-causal ``transformer_block``s (unrolled, or one
weight-stacked ``nn.ScannedBlocks`` with ``scan=True``; ``remat=True``
wraps each residual, or each stacked block, in ``nn.Remat``), a final
LayerNorm, the global-average-pool ``Lambda`` (``gap``) and the Dense
head. The layer names, and so the parameter paths, are the JAX package's.
At ViT-B/16's 196 tokens ``flash="auto"`` takes dense attention (flash
from 512 positions on), as in JAX.
"""

from __future__ import annotations

from typing import Optional

from .. import nn
from .transformer import transformer_block

_CONFIGS = {
    # name: (num_layers, d_model, num_heads)
    "tiny": (12, 192, 3),
    "small": (12, 384, 6),
    "base": (12, 768, 12),
    "large": (24, 1024, 16),
}


def _tokens(x):
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _gap(x):
    return x.mean(dim=1)


def vit(
    num_classes: int = 1000,
    *,
    image_size: int = 224,
    patch_size: int = 16,
    num_layers: int = 12,
    d_model: int = 768,
    num_heads: int = 12,
    d_ff: Optional[int] = None,
    remat: bool = False,
    scan: bool = False,
    dtype=None,
) -> nn.Sequential:
    """(B, H, W, C) images -> (B, num_classes) logits."""
    if image_size % patch_size:
        raise ValueError(
            f"image_size {image_size} not divisible by patch_size "
            f"{patch_size}")
    side = image_size // patch_size
    n_tokens = side * side
    d_ff = d_ff or 4 * d_model
    layers = [
        nn.Conv2D(d_model, patch_size, strides=patch_size, padding="valid",
                  dtype=dtype, name="patch_embed"),
        # The token count comes from the real input shape (no
        # output_shape), so images that do not match image_size fail in
        # PositionalEmbedding, as in JAX.
        nn.Lambda(_tokens, name="patches_to_tokens"),
        nn.PositionalEmbedding(n_tokens),
    ]
    if scan:
        def make_block():
            block = nn.Sequential(transformer_block(
                d_model, num_heads, d_ff, causal=False, dtype=dtype))
            return nn.Remat(block) if remat else block

        layers.append(nn.ScannedBlocks(make_block, num_layers))
    else:
        for _ in range(num_layers):
            block = transformer_block(d_model, num_heads, d_ff,
                                      causal=False, dtype=dtype)
            if remat:
                block = [nn.Remat(residual) for residual in block]
            layers += block
    layers += [
        nn.LayerNorm(),
        nn.Lambda(_gap, output_shape=(d_model,), name="gap"),
        nn.Dense(num_classes, dtype=dtype),
    ]
    return nn.Sequential(layers, name="vit")


def _named(size: str):
    def make(num_classes: int = 1000, **kw) -> nn.Sequential:
        num_layers, d_model, num_heads = _CONFIGS[size]
        kw.setdefault("num_layers", num_layers)
        kw.setdefault("d_model", d_model)
        kw.setdefault("num_heads", num_heads)
        return vit(num_classes, **kw)

    make.__name__ = f"vit_{size}"
    make.__doc__ = f"ViT-{size.capitalize()} ({_CONFIGS[size]})."
    return make


vit_tiny = _named("tiny")
vit_small = _named("small")
vit_base = _named("base")
vit_large = _named("large")

__all__ = ["vit", "vit_base", "vit_large", "vit_small", "vit_tiny"]
