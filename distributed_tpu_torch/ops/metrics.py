"""Metrics, as the JAX package's ``ops/metrics.py`` defines them.

Protocol: a metric maps (logits, labels) -> (sum, count). ``fit``
accumulates the pairs over an epoch and divides once at its end; known
metrics also expose a per-example score vector (``per_example``) so
evaluation can weight elements exactly.
"""

from __future__ import annotations

import torch


def _accuracy_scores(logits, labels):
    pred = torch.argmax(logits, dim=-1)
    return (pred == labels.to(pred.dtype)).to(torch.float32)


def accuracy(logits, labels):
    scores = _accuracy_scores(logits, labels)
    return scores.sum(), float(scores.numel())


accuracy.per_example = _accuracy_scores

_REGISTRY = {"accuracy": accuracy, "acc": accuracy}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown metric {name_or_fn!r}; known: {sorted(_REGISTRY)}"
        ) from None


def per_example(fn):
    """Per-example score vector fn, or None if the metric has none."""
    return getattr(fn, "per_example", None)


def name_of(name_or_fn) -> str:
    if isinstance(name_or_fn, str):
        return "accuracy" if name_or_fn == "acc" else name_or_fn
    return getattr(name_or_fn, "__name__", "metric")


__all__ = ["accuracy", "get", "name_of", "per_example"]
