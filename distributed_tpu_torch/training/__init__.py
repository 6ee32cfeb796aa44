"""Model container, its Keras-shaped trainer (compile/fit/evaluate/predict)
and the fit loop's callbacks."""

from . import callbacks
from .history import History
from .model import Model

__all__ = ["History", "Model", "callbacks"]
