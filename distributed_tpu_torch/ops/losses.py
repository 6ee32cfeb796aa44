"""Loss functions: the stock paths and the fused (pallas-named) loss.

The JAX package's ``ops/losses.py`` for the sparse cross-entropy that the
LM trains with: ``sparse_categorical_crossentropy`` (whole-batch mean),
its per-example form for masked evaluation, and ``get`` by name. Losses
compute in f32 whatever the activation dtype. The fused loss registers
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


def _per_example_sparse_cce(logits, labels):
    return -_picked(_log_probs(logits, True), labels)


_REGISTRY = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
}

# Per-example forms, used for exact masked evaluation.
_PER_EXAMPLE = {
    sparse_categorical_crossentropy: _per_example_sparse_cce,
}

PALLAS_NAME = "pallas_sparse_categorical_crossentropy"


def get_per_example(loss_fn):
    """Per-example variant of a known loss, or None for custom callables."""
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
    "PALLAS_NAME", "get", "get_per_example", "sparse_categorical_crossentropy",
]
