"""Loss functions: the stock paths and the fused (pallas-named) loss.

The JAX package's ``ops/losses.py``: ``sparse_categorical_crossentropy``
(whole-batch mean, the LM's loss), ``categorical_crossentropy`` (one-hot
targets), ``mean_squared_error`` (``"mse"``) and
``cross_entropy_with_ignore`` (token CE masking ``ignore_index``), the
per-example forms masked evaluation and the chunked head sum, the loss
object ``SparseCategoricalCrossentropy``, and ``get`` by the JAX names.
Losses compute in f32 whatever the activation dtype. The fused loss registers
under its JAX name, ``"pallas_sparse_categorical_crossentropy"``, lazily
on first ``get``, as there.
"""

from __future__ import annotations

import torch


def _log_probs(logits, from_logits: bool):
    x = logits.to(torch.float32)
    if not from_logits:
        x = torch.log(torch.clamp(x, 1e-9, 1.0))
    return torch.log_softmax(x, dim=-1)


def _picked(logp, labels):
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def sparse_categorical_crossentropy(logits, labels, from_logits: bool = True):
    """Mean cross-entropy for integer labels. logits: (..., C), labels: (...)."""
    return -_picked(_log_probs(logits, from_logits), labels).mean()


def categorical_crossentropy(logits, onehot, from_logits: bool = True):
    """Mean cross-entropy against one-hot (or soft) targets ``(..., C)``;
    ``from_logits=False`` takes the log of the clipped probabilities (no
    renormalization, as the JAX loss)."""
    x = logits.to(torch.float32)
    logp = (torch.log_softmax(x, dim=-1) if from_logits
            else torch.log(torch.clamp(x, 1e-9, 1.0)))
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def mean_squared_error(pred, target):
    """Mean of the squared differences over every element, in f32."""
    return torch.mean(torch.square(pred.to(torch.float32) - target))


def cross_entropy_with_ignore(logits, labels, ignore_index: int = -100):
    """Token cross-entropy that masks out ``ignore_index`` labels: the sum
    over the kept tokens divided by their count (at least 1)."""
    total, count = _ce_ignore_sum_count(logits, labels, ignore_index)
    return total / torch.clamp_min(count, 1.0)


def _ce_ignore_sum_count(logits, labels, ignore_index: int = -100):
    """``cross_entropy_with_ignore`` as ``(sum over the kept tokens,
    their count)``: a ratio whose divisor depends on the data, so a
    data-parallel step divides each rank's sum by the global count."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ignored = labels == ignore_index
    safe = torch.where(ignored, torch.zeros_like(labels), labels)
    mask = (~ignored).to(torch.float32)
    return -torch.sum(_picked(logp, safe) * mask), torch.sum(mask)


def _per_example_sparse_cce(logits, labels):
    return -_picked(_log_probs(logits, True), labels)


def _per_example_cce(logits, onehot):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.sum(onehot * logp, dim=-1)


def _per_example_mse(pred, target):
    d = torch.square(pred.to(torch.float32) - target)
    return torch.mean(d.reshape(d.shape[0], -1), dim=-1)


class SparseCategoricalCrossentropy:
    """The loss object form, ``SparseCategoricalCrossentropy(from_logits=
    True)``: called as the mean loss; ``get_per_example`` gives its
    per-example form (``from_logits=False`` takes the log of the clipped
    probabilities first), which masked evaluation and the chunked head
    (``compile(head_chunks=)``) sum."""

    def __init__(self, from_logits: bool = True):
        self.from_logits = from_logits

    def __call__(self, logits, labels):
        return sparse_categorical_crossentropy(logits, labels,
                                               self.from_logits)


_REGISTRY = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
}

# Per-example forms, used for exact masked evaluation.
_PER_EXAMPLE = {
    sparse_categorical_crossentropy: _per_example_sparse_cce,
    categorical_crossentropy: _per_example_cce,
    mean_squared_error: _per_example_mse,
}

PALLAS_NAME = "pallas_sparse_categorical_crossentropy"


# Ratio losses as (sum, count) pairs (``get_sum_count``).
_SUM_COUNT = {cross_entropy_with_ignore: _ce_ignore_sum_count}


def get_sum_count(loss_fn):
    """The ``(sum, count)`` form of a known ratio loss (its divisor, the
    count, depends on the data), or None. ``Model`` divides each rank's
    sum by the global count; a callable of the user's may return such a
    pair itself (``Model._rank_loss``)."""
    return _SUM_COUNT.get(loss_fn)


def get_per_example(loss_fn):
    """Per-example variant of a known loss, or None for custom callables."""
    if isinstance(loss_fn, SparseCategoricalCrossentropy):
        if loss_fn.from_logits:
            return _per_example_sparse_cce
        return lambda logits, labels: _per_example_sparse_cce(
            torch.log(torch.clamp(logits.to(torch.float32), 1e-9, 1.0)),
            labels)
    return _PER_EXAMPLE.get(loss_fn)


def _register_pallas():
    from . import pallas_kernels as pk

    _REGISTRY[PALLAS_NAME] = pk.pallas_sparse_categorical_crossentropy
    _PER_EXAMPLE[pk.pallas_sparse_categorical_crossentropy] = (
        pk.per_example_pallas_xent
    )


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn == PALLAS_NAME:
        _register_pallas()
    try:
        return _REGISTRY[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown loss {name_or_fn!r}; known: {sorted(_REGISTRY)}"
        ) from None


__all__ = [
    "PALLAS_NAME", "SparseCategoricalCrossentropy", "categorical_crossentropy",
    "cross_entropy_with_ignore", "get", "get_per_example", "get_sum_count",
    "mean_squared_error", "sparse_categorical_crossentropy",
]
