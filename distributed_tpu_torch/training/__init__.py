"""Model container (the fit loop is not ported yet)."""

from .model import Model

__all__ = ["Model"]
