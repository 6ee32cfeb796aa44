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

Ported so far:

- serving: ``models.transformer_lm`` served by ``serving.Engine`` through
  paged KV pools, with the paged-attention decode kernel written by hand
  in CUDA (``csrc/paged_attention.cu``);
- training: ``Model.compile/fit/evaluate`` of the same LM with
  ``optim.Adam``/``SGD``, flash attention (``csrc/flash_attention.cu``:
  forward, dQ, dK/dV) and the fused softmax cross-entropy
  (``csrc/xent.cu``: forward, backward), all hand-written in CUDA;
- the reference's data-parallel CNN trainer: ``models.mnist_cnn`` and
  ``cifar_cnn`` on the offline ``data`` sets, under ``SingleDevice`` or
  ``DataParallel`` (one process per card over a ``torch.distributed``
  group that ``cluster.initialize`` forms from ``DTPU_CONFIG``;
  ``python -m distributed_tpu_torch.launch`` starts the workers), with
  the optimizers ``SGD`` (momentum), ``AdamW`` and ``fused_adam``/
  ``fused_adamw``, whose update is the fused Adam kernel
  (``csrc/fused_adam.cu``).
"""

from . import (
    cluster, data, interop, launch, models, nn, ops, optim, parallel,
    precision, quant, serving, utils,
)
from .device import resolve_device
from .parallel import DataParallel, MultiWorkerMirroredStrategy, SingleDevice
from .training.history import History
from .training.model import Model

__all__ = [
    "DataParallel", "History", "Model", "MultiWorkerMirroredStrategy",
    "SingleDevice", "cluster", "data", "interop", "launch", "models", "nn",
    "ops", "optim", "parallel", "precision", "quant", "resolve_device",
    "serving", "utils",
]
