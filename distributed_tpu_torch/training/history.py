"""Training history object (a copy of the JAX package's
``training/history.py``, which imports no JAX).

The Keras ``History``: ``history.history[name]`` holds one value per
epoch; ``history.metrics`` is an alias of it, so R code reading
``result$metrics$accuracy`` through reticulate keeps working.
"""

from __future__ import annotations

from typing import Dict, List


class History:
    def __init__(self):
        self.history: Dict[str, List[float]] = {}
        self.epoch: List[int] = []

    def record(self, epoch: int, logs: Dict[str, float]):
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(float(v))

    @property
    def metrics(self) -> Dict[str, List[float]]:
        return self.history

    def __repr__(self):
        keys = ", ".join(self.history)
        return f"History(epochs={len(self.epoch)}, metrics=[{keys}])"
