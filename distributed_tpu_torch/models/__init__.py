"""Model zoo of the port (the decoder-only LM so far)."""

from .transformer import transformer_block, transformer_lm

__all__ = ["transformer_block", "transformer_lm"]
