"""distributed_tpu_torch: the PyTorch/CUDA port of ``distributed_tpu``.

A second package beside the JAX one, written for an NVIDIA H100. It keeps
the JAX package's module paths (``nn/core.py``, ``nn/attention.py``,
``ops/paged_attention.py``, ``serving/engine.py``, ...) and its parameter
tree paths, so a parameter tree built by either package loads into the
other with no transposes (``interop.params_from_jax``).

It never imports ``jax`` or ``distributed_tpu``. Entry points take
``device=None``, which means ``"cuda"``; without a card they raise instead
of running on the CPU, and the CPU is used only when asked for
(``device="cpu"``), as the tests do.

Ported so far: the serving slice — ``models.transformer_lm`` served by
``serving.Engine`` through paged KV pools, with the paged-attention decode
kernel written by hand in CUDA (``csrc/paged_attention.cu``).
"""

from . import interop, models, nn, ops, precision, quant, serving
from .device import resolve_device
from .training.model import Model

__all__ = [
    "Model", "interop", "models", "nn", "ops", "precision", "quant",
    "resolve_device", "serving",
]
