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
  in CUDA (``csrc/paged_attention.cu``), speculative decoding
  (``draft_model``, ``spec_k``), weight hot-swap (``update_weights``) and
  the engine's telemetry (``obs``, ``utils.events``);
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
  (``csrc/fused_adam.cu``);
- ResNet with sync-BN (``csrc/conv1x1.cu``, ``csrc/bn_reduce.cu``);
- the sharded data-parallel strategies: ``ZeroDataParallel`` (ZeRO-1)
  and ``FullyShardedDataParallel``/``FSDP`` (ZeRO-3), with the layers'
  compute-dtype gathers and the scanned stack's one-layer-ahead gather,
  and ``ShardedCheckpointer`` (one file of blocks per rank, the JAX
  package's directory format);
- tensor and sequence parallelism over multi-axis meshes
  (``parallel.make_mesh``): ``DataTensorParallel`` (Megatron column and
  row blocks over the "model" axis, from the layers' ``sharding_hints``)
  and ``DataSeqParallel`` (the sequence split over "seq", attention by
  ring, ``ops.ring_attention``, naive or zigzag, or by Ulysses'
  all-to-alls around flash attention);
- checkpoints and model retrieval: ``Checkpointer``, ``export_hdf5``/
  ``import_hdf5`` and ``checkpoint.artifact_encode``/``artifact_decode``
  (files either package reads), ``Model.save_weights``/``load_weights``/
  ``predict``, and ``fit``'s ``callbacks`` (``ModelCheckpoint`` resumes a
  run that died) and ``validation_data``;
- the auto-shard planner (``compile(strategy="auto")``,
  ``parallel.plan_sharding``) and the gang launcher's restart, liveness,
  ssh and elastic-world seams (``launch.run_with_restart``,
  ``launch.SSHLauncher``, ``launch.heartbeat``);
- resilience: the supervisor with its restart, preemption and elastic
  policies, fault injection and the buddy-redundancy recovery tier
  (``resilience``, ``ModelCheckpoint(buddy=)``, ``python -m
  distributed_tpu_torch.launch --supervise``), and the rest of ``obs``
  (the flight recorder, cross-rank aggregation, the exporters and the
  postmortem CLI);
- the serving fleet (``fleet``: prefill and decode replicas sharing
  ``EnginePrograms``, the KV-block handoff, the router, the autoscaler
  and prefix gossip, on a virtual clock) and the serving service
  (``serve_service``: the same replicas as worker processes behind a
  socket router on wall time, KV payloads over ``/dev/shm`` or inline
  frames, tenant quotas). ``fleet`` and ``serve_service`` load on first
  use (``dtt.fleet``);
- online post-training (``rl``: ``PostTrainer`` over a sampling Engine,
  ``DraftDistiller`` for a speculative engine's draft, the rewards and
  ``optim.AdaptiveKLCoef``) and the data tiers (``data``: ``FileSource``
  and ``RecordSource`` shards, the native C++ ring built with ``g++``
  into ``_build/``, the record decode pool, the remaining loaders) with
  the augmentation layers ``nn.RandomCrop``/``nn.RandomFlip``;
- the port's linter (``analysis``, the ``dtt-lint`` console script) and,
  outside the package, its R binding (``r/distributedtputorch/``).
"""

from . import (
    checkpoint, cluster, data, interop, launch, models, nn, obs, ops, optim,
    parallel, precision, quant, serving, utils,
)
from .checkpoint import (Checkpointer, ShardedCheckpointer, export_hdf5,
                         import_hdf5)
from .device import resolve_device
from .ops import losses, metrics
from .parallel import (FSDP, CompositeParallel, DataExpertParallel,
                       DataParallel, DataPipelineParallel, DataSeqParallel,
                       DataTensorParallel, FullyShardedDataParallel,
                       MultiWorkerMirroredStrategy, SingleDevice, Strategy,
                       ZeroDataParallel, current_strategy, make_mesh)
from .precision import Policy
from .training import callbacks
from . import resilience  # after training and checkpoint: builds on both
from . import rl  # after training and serving: drives both
from .training.history import History
from .training.model import Model
from .version import __version__

__all__ = [
    "Checkpointer", "CompositeParallel", "DataExpertParallel",
    "DataParallel", "DataPipelineParallel", "DataSeqParallel",
    "DataTensorParallel", "FSDP", "FullyShardedDataParallel",
    "History", "Model", "MultiWorkerMirroredStrategy", "Policy",
    "ShardedCheckpointer", "SingleDevice", "Strategy", "ZeroDataParallel",
    "__version__", "callbacks", "checkpoint",
    "cluster", "current_strategy", "data", "export_hdf5", "import_hdf5",
    "interop", "launch", "losses", "make_mesh", "metrics",
    "models", "nn", "obs", "ops", "optim", "parallel", "precision", "quant",
    "resilience",
    "resolve_device", "rl", "serving", "utils",
]


def __getattr__(name):
    # The serving tiers past one engine load on first use, as in the JAX
    # package: processes that only train or only serve never pay for them.
    if name in ("fleet", "serve_service"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
