"""Model container and its Keras-shaped trainer (compile/fit/evaluate)."""

from .history import History
from .model import Model

__all__ = ["History", "Model"]
