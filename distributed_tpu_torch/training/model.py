"""``Model``: a layer stack, its parameters, and the Keras-shaped trainer.

The counterpart of the JAX package's ``training/model.py``: ``build``
creates the parameters from a seed, ``params`` exposes them under the JAX
tree paths, ``compile``/``fit``/``evaluate``/``predict`` train and score,
``generate`` samples from a token LM through the dense KV cache, and
``decode_dtype`` names the KV-cache dtype the serving engine uses.

A model captures the strategy of the ``strategy.scope()`` it is built in
(``SingleDevice`` outside one), and ``compile(strategy=...)`` replaces it.
Under ``DataParallel`` each rank takes its rows of every global batch,
computes the loss as the mean over them, and the gradients are averaged
over the ranks (one all-reduce per dtype) before the optimizer; the
epoch's losses and metric sums are reduced across the ranks at its one
host sync. Every rank builds the same parameters from the same seed.

Under ``ZeroDataParallel`` the optimizer state holds each rank's block of
every statistic, and the update runs on the blocks (the strategy's
``apply_update``); under ``FullyShardedDataParallel``/``FSDP`` the
parameters themselves are stored as blocks (``build`` places them, and
``live_params`` gives them), gathered by each layer as it reads them.
``params``, ``save_weights``, the checkpoints and the Engine's snapshot
gather full leaves (every rank calls them: the gather is a collective),
and ``load_params``, ``interop.place`` and the restores place full leaves
into this rank's blocks.

A model with state (BatchNorm's running statistics) keeps it in buffers,
``state`` exposes them under the JAX state paths and ``load_state`` loads
them. ``fit`` runs the module in train mode (the JAX ``apply``'s
``train=True``) inside its strategy's ``scope()``, so a layer that reduces
over the batch finds the replicas; everything else (``evaluate``, a call
of ``model.module``) runs it in eval mode, as ``train=False``.

A train step is forward, loss, ``torch.autograd.grad`` and the optimizer's
in-place update. Master parameters stay f32; layers built with ``dtype=``
cast them per call, and the gradients come back f32 through the casts, as
in JAX. The per-step loss and metric sums stay on the device and are
fetched once per epoch, as the JAX loop does.

The JAX loop's levers are the port's too:

- ``fit(grad_accum=M)``: M microbatches a step, their gradients summed in
  f32 and divided by M, one update; ``compile(grad_clip=,
  gradient_accumulation_steps=)`` wrap the optimizer as optax does
  (``optim.chain``, ``optim.MultiSteps``).
- ``compile(steps_per_execution=K)``: K host batches stacked and copied to
  the device once, then K steps with no host sync between them; loss and
  metric sums accumulate on the device, and callbacks, the progress line
  and ``model.step`` advance every K steps. On the card each step's
  forward and backward replays a CUDA graph (``training.step_graph``) and
  the update runs eagerly after it; on the CPU the steps run eagerly.
- ``fit(x)`` from a batch iterator (``data.Pipeline`` or any iterator of
  ``(x, y)``), and ``fit(prefetch=N)``: a ``data.DevicePrefetcher``
  stages N dispatches ahead on a background thread, through pinned host
  buffers and a side stream on the card, bit-identical at any depth.
- The fit loop's telemetry: ``input_wait``/``dispatch``/
  ``checkpoint_wait`` spans, ``model.last_fit_telemetry`` (the JAX
  report's keys, the scanned stack's ``overlap`` record among them),
  periodic ``metrics_snapshot`` events, and one flight-recorder record a
  dispatch (``obs.flight``), dumped if the step loop dies.
- Randomness: a module that draws random numbers (``nn.Dropout``) gets
  the JAX step key, ``fold_in(PRNGKey(seed + 1), step)`` (``seed`` the
  build's), microbatch i of ``grad_accum`` ``fold_in(key, i)``, and step
  i of a K-step dispatch ``fold_in(PRNGKey(seed + 1), step0 + i)``: the
  masks are JAX's at every K. The key is held in a device tensor copied
  in before each step, so a captured step graph reads the step's key at
  every replay.

``compile(strategy="auto")`` hands the choice of strategy, precision,
``steps_per_execution`` and the default ``fit(grad_accum=)`` to the
auto-shard planner (``parallel.auto_shard``), which runs at ``build``,
before the parameters exist (or at once, on a built model).

The fit, epoch and evaluate loops call ``launch.heartbeat()`` (throttled;
a no-op outside a gang) where the JAX loops do, so a launcher's
``liveness_timeout`` finds a worker that stopped making progress.

The ``compile``/``fit`` options of the JAX package that are not ported
raise ``NotImplementedError`` naming their ROADMAP item.

``fit`` calls its callbacks (``training.callbacks``) at the JAX package's
hook points and honours its crash-restart contract: after a restoring
``ModelCheckpoint``, ``epochs`` is the total, and the epochs and steps
already done are skipped (an iterator source is moved to the restored
step: its checkpointed cursor, else a seek). With no callbacks a step does
what it did without them: no host sync and no device work is added.
``save_weights``/``load_weights`` write and read the JAX package's HDF5
and npz weight files (``checkpoint``).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import interop, optim
from .. import precision as precision_lib
from .. import quant as quant_lib
from ..checkpoint import core as ckpt
from ..data.pipeline import Pipeline
from ..data.prefetch import DevicePrefetcher, DeviceStager
from ..device import resolve_device
from ..launch.core import heartbeat as _gang_heartbeat
from ..nn.core import (apply_layers, needs_rng, param_tree, rng_scope,
                       state_tree)
from ..nn import moe as moe_lib
from ..nn.pipeline import (PipelinedBlocks, clear_pipeline_trace,
                           last_pipeline_trace)
from ..nn.remat import checkpoint as remat_checkpoint
from ..nn.scan import (ScannedBlocks, clear_overlap_trace,
                       last_overlap_trace)
from ..obs import flight as obs_flight
from ..obs import registry as obs_registry
from ..obs import spans as obs_spans
from ..ops import losses as losses_lib
from ..ops import metrics as metrics_lib
from ..ops.pallas_kernels import XENT_FWD_OP
from ..parallel.collectives import gather_full, layout_of, mark
from ..parallel.strategy import (SingleDevice, Strategy, current_strategy,
                                 role_of)
from ..utils import event_schema as evs
from ..utils import events as events_lib
from ..utils import logging as dlog
from ..utils import threefry
from ..utils.profiler import StepTimer, tree_bytes_per_device
from .history import History
from .progress import ProgressLine
from .step_graph import StepGraph


def _index_stream(
    n: int, batch: int, shuffle: bool, seed: Optional[int], start_step: int = 0
):
    """Yield index blocks forever; reshuffles each pass (Keras semantics:
    with steps_per_epoch the cursor carries across epochs). A copy of the
    JAX package's, so shuffled batches come in the same order.

    Each pass's permutation depends only on (seed, pass index), so a
    resumed run (``start_step`` = the restored ``model.step``) continues
    with the batch the interrupted run would have taken next."""
    base = 0 if seed is None else seed
    per_pass = max((n - batch) // batch + 1, 1)
    pass_idx, within = divmod(start_step, per_pass)
    while True:
        rng = np.random.default_rng((base, pass_idx))
        order = rng.permutation(n) if shuffle else np.arange(n)
        starts = range(0, n - batch + 1, batch)
        for start in list(starts)[within:]:
            yield order[start : start + batch]
        within = 0
        pass_idx += 1


def _split_head(module):
    """(body layers, head layer) of a Sequential: the chunked head
    (``compile(head_chunks=C)``) applies the last layer per token chunk."""
    layers = getattr(module, "layers", None)
    if not layers or len(layers) < 2:
        raise ValueError(
            "head_chunks needs a Sequential module with >= 2 layers (body + "
            "a tokenwise head as the LAST layer); got "
            f"{type(module).__name__}")
    return layers[:-1], layers[-1]


def _positive_int(name: str, value) -> int:
    if not isinstance(value, (int, np.integer)) or value < 1:
        raise ValueError(f"{name} must be an integer >= 1, got {value!r}")
    return int(value)


def _per_host_source(source, strategy) -> bool:
    """True when a batch source emits only this process's rows of each
    global batch (a ``(index, count)`` ``shard`` tuple, as
    ``data.Pipeline(shard=...)`` sets); its count must be the number of
    row shards (``num_replicas_in_sync``: the ranks of a model, pipe,
    expert or seq line read the same rows), or the slices could not
    assemble into a whole batch. A source built with ``shard="auto"``
    outside ``strategy``'s scope is resharded to the strategy's row
    line first."""
    if getattr(source, "shard_auto", False) and tuple(
            source.shard or (0, 1)) != strategy.row_shard():
        with strategy.scope():
            source.reshard("auto")
    shard = getattr(source, "shard", None)
    if not isinstance(shard, tuple):
        return False
    if int(shard[1]) != strategy.num_replicas_in_sync:
        raise ValueError(
            f"per-host-sharded data source splits each global batch "
            f"{int(shard[1])} ways but this run has "
            f"{strategy.num_replicas_in_sync} replica(s), so the shards "
            "cannot assemble into a whole batch; rebuild the pipeline or "
            "call pipeline.reshard('auto')")
    return True


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor, sharing its memory when it is
    contiguous (only read: the batches are gathered from it)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _has_batch_norm(module) -> bool:
    """True when a BatchNorm runs in ``module``, in a scanned block's
    template too (it is not a registered child)."""
    from ..nn.layers import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm) or (isinstance(m, ScannedBlocks)
                                        and _has_batch_norm(m.block)):
            return True
    return False


def _full_shape(t) -> tuple:
    """A stored leaf's full shape (a block's leaf's, under FSDP)."""
    lay = layout_of(t)
    return lay.shape if lay is not None else tuple(t.shape)


def _opt_view(t, layout):
    """The tensor the optimizer updates for a parameter ``t`` whose
    statistics take ``layout``: ``t`` itself where it is stored so (or
    whole), else a view of its block (ZeRO-1)."""
    if layout is None or layout_of(t) == layout:
        return t
    return t.detach()[layout.index()]


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_memory(device):
    """The allocator's ``{bytes_in_use, peak_bytes_in_use, bytes_limit}``
    on a card; None on the CPU, as the JAX report has on XLA:CPU."""
    if device.type != "cuda":
        return None
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            device).total_memory),
    }


class _LocalLeaf:
    """One statistic as this rank holds it: its tensor and its layout
    (None: whole), a leaf of ``Model._opt_tree("local")``."""

    __slots__ = ("tensor", "layout")

    def __init__(self, tensor, layout):
        self.tensor, self.layout = tensor, layout


def _host_array(a) -> np.ndarray:
    """A host array as the step takes it: float64 (what R, and Python
    floats, hand over) as float32, the cast JAX's 32-bit default makes at
    the same entry points; every kernel of the port refuses float64."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


class Model:
    """``Model(module, name=None, device=None)``: the model on the device
    of the ambient strategy (``strategy.scope()``), else on ``device``,
    where ``None`` is the card; it raises ``RuntimeError`` when there is
    none (pass ``device="cpu"``). ``name`` as in the JAX package
    (default ``"model"``)."""

    def __init__(self, module, name: Optional[str] = None, *, device=None):
        self.module = module
        self.name = name or "model"
        # Scope-wraps-construction: capture the ambient strategy now.
        strategy = current_strategy()
        if strategy is None:
            strategy = SingleDevice(device)
        elif device is not None:
            want = resolve_device(device)
            if want.type != strategy.device.type or want.index not in (
                    None, strategy.device.index):
                raise ValueError(
                    f"Model(device={device!r}) inside the scope of a "
                    f"strategy on {strategy.device}: the strategy places "
                    "the model")
        self.strategy: Strategy = strategy
        self.device = strategy.device
        self.built = False
        self.compiled = False
        self.input_shape: Optional[tuple] = None
        self.step = 0  # global optimizer step (the batch-order cursor)
        self.tx = None
        self.opt_state = None
        self.steps_per_execution = None  # compile(steps_per_execution=K)
        self.stop_training = False  # callbacks (EarlyStopping) set this
        self.last_fit_telemetry = None  # the stall report of the last fit
        self._stall_timer = None  # live StepTimer of the fit in progress
        self._fit_source = None  # the iterator fit reads (checkpoint meta)
        self._resumed_step = None  # set by a restoring Checkpointer
        self._restored_data_state = None  # its data_state meta, if any
        self._seed = 0
        self._decode_dtype = None
        self._graphs = {}  # captured train steps (steps_per_execution)
        self._stager = None
        self.precision = None  # compile(precision=...): a dtype Policy
        self.head_chunks = None  # compile(head_chunks=C)
        self._dtype_hints = {}  # the layers' own dtype= (set by build)
        self._rng_key = None  # the step's key on the device (Dropout)
        self._overlap_record = None  # this model's last scanned record
        self.last_plan = None  # auto_shard.Plan of compile(strategy="auto")
        self._auto_shard = None  # the planner's options, set by compile()
        self._auto_grad_accum = None  # the plan's fit(grad_accum=) default

    def build(self, input_shape: Sequence[int], seed: int = 0):
        """Create the f32 parameters for an unbatched input shape, drawn
        from a CPU ``torch.Generator`` seeded with ``seed`` (the same
        weights on every device), and move them to ``self.device``."""
        generator = torch.Generator().manual_seed(int(seed))
        self.input_shape = tuple(int(d) for d in input_shape)
        self._seed = int(seed)
        if self._auto_shard is not None and self.compiled:
            # compile(strategy="auto"): choose the strategy, precision and
            # K before the parameters exist; the planner prices the
            # candidates from shapes alone.
            self._commit_auto_plan()
        self.module.build(self.input_shape, generator)
        self.module.to(self.device)
        self.module.eval()
        self._layout_params()
        self._dtype_hints = self.module.dtype_hints()
        self.built = True
        self._decode_dtype = None
        self._graphs = {}
        if self.compiled:
            self._init_opt_state()
        return self

    def _layout_params(self) -> None:
        """Store each parameter as this rank's block where the strategy
        shards parameters (FSDP; tensor parallelism by the layers'
        ``sharding_hints`` roles), marked with its layout."""
        hints = self.module.sharding_hints()
        quant = {name.replace(".", "/") for name, sub in
                 self.module.named_modules()
                 if isinstance(sub, quant_lib.QuantizedWeight)}
        with torch.no_grad():
            for path, t in param_tree(self.module).items():
                if layout_of(t) is None:
                    weight, _, leaf = path.rpartition("/")
                    role = (quant_lib.leaf_role(leaf, role_of(weight, hints))
                            if weight in quant else role_of(path, hints))
                    lay = self.strategy.param_layout(tuple(t.shape), role)
                    if lay is not None:
                        t.data = lay.block(t.data)
                        mark(t, lay)

    def _unlayout_params(self) -> None:
        """Gather every block-stored parameter back to its full leaf (a
        collective: every rank calls it)."""
        with torch.no_grad():
            for t in param_tree(self.module).values():
                lay = layout_of(t)
                if lay is not None:
                    t.data = gather_full(t.data, lay).contiguous()
                    mark(t, None)

    def _init_opt_state(self) -> None:
        self.opt_state = self.strategy.init_opt_state(
            self.tx, [_opt_view(t, lay) for t, lay in zip(
                self._param_list(), self._opt_layout_list())])

    def _require_built(self):
        if not self.built:
            raise RuntimeError("Model not built")

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{tree path: parameter}``, paths as in the JAX package
        (``residual_1/main/dense_1/kernel``); a quantized weight
        (``quant.quantize_model``) as its ``.../kernel/q`` and
        ``.../kernel/scale`` buffers. Under FSDP each leaf is gathered
        whole, a copy (every rank must ask: the gather is a collective);
        :meth:`live_params` gives the stored blocks."""
        tree = self.live_params()
        if not any(layout_of(t) is not None for t in tree.values()):
            return tree
        return {p: gather_full(t, layout_of(t)) for p, t in tree.items()}

    def live_params(self) -> Dict[str, torch.Tensor]:
        """``{tree path: the stored tensor}``: the parameters themselves,
        each rank's block of a leaf the strategy shards (FSDP; its layout
        is ``parallel.collectives.layout_of(t)``)."""
        self._require_built()
        return param_tree(self.module)

    def _param_list(self):
        return list(self.live_params().values())

    def _param_shapes(self) -> Dict[str, tuple]:
        """``{tree path: full shape}`` of the parameters."""
        return {p: _full_shape(t) for p, t in self.live_params().items()}

    def _opt_layout_list(self):
        return [self.strategy.opt_layout(_full_shape(t), layout_of(t))
                for t in self._param_list()]

    @property
    def opt_layouts(self) -> Dict[str, object]:
        """``{parameter path: this rank's block of the parameter's
        optimizer statistics (a collectives.Layout), or None: whole}``."""
        return dict(zip(self.live_params(), self._opt_layout_list()))

    def _opt_tree(self, kind: str = "full"):
        """optax's tree of the optimizer state
        (``interop.opt_state_to_tree``), each statistic as: ``"full"``
        the whole leaf (gathered, a collective, where it is sharded);
        ``"meta"`` a ``meta`` tensor of the whole leaf's shape and dtype;
        ``"local"`` ``(this rank's tensor, its layout or None)``."""
        lays = self._opt_layout_list()
        if kind == "full":
            def fn(i, t):
                return gather_full(t, lays[i])
        elif kind == "meta":
            def fn(i, t):
                shape = lays[i].shape if lays[i] is not None else t.shape
                return torch.empty(shape, dtype=t.dtype, device="meta")
        else:
            def fn(i, t):
                return _LocalLeaf(t, lays[i])
        return interop.opt_state_to_tree(
            self.tx, optim.map_slots(self.opt_state, fn), self.live_params())

    @property
    def num_params(self) -> int:
        if not self.built:
            raise ValueError("Model not built")
        return sum(int(np.prod(s, dtype=np.int64))
                   for s in self._param_shapes().values())

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """``{tree path: buffer}``: the model's state (BatchNorm's
        running ``mean`` and ``var``) under the JAX package's state paths
        (``residual/main/batch_norm/mean``); empty for a stateless model."""
        self._require_built()
        return state_tree(self.module)

    @staticmethod
    def _check_tree(own, new, what):
        """Raise ValueError unless ``new`` has exactly ``own``'s paths, each
        of its shape (``own``: tensors, or full shapes)."""
        if set(own) != set(new):
            raise ValueError(
                f"{what} paths differ: missing {sorted(set(own) - set(new))}, "
                f"unexpected {sorted(set(new) - set(own))}"
            )
        for path, t in own.items():
            shape = tuple(new[path].shape)
            want = tuple(t) if isinstance(t, tuple) else tuple(t.shape)
            if shape != want:
                raise ValueError(f"{path}: shape {shape} != {want}")

    @classmethod
    def _copy_into(cls, own, new, what):
        cls._check_tree(own, new, what)
        with torch.no_grad():
            for path, t in own.items():
                t.copy_(torch.as_tensor(new[path]))

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``{tree path: tensor}`` (e.g. ``interop.params_from_jax``)
        into the parameters, each into this rank's block where it is
        stored sharded. Paths and full shapes must match exactly."""
        own = self.live_params()
        self._check_tree(self._param_shapes(), params, "parameter")
        with torch.no_grad():
            for path, t in own.items():
                new = torch.as_tensor(params[path])
                lay = layout_of(t)
                t.copy_(new if lay is None else new[lay.index()])
        self._decode_dtype = None

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy ``{tree path: tensor}`` (e.g. ``interop.state_from_jax``)
        into the state buffers. Paths and shapes must match exactly."""
        self._copy_into(self.state, state, "state")

    def decode_dtype(self) -> torch.dtype:
        """KV-cache / activation dtype for decode, shared by ``generate``
        and ``serving.Engine``: under a precision policy its compute
        dtype; without one the dtype of the logits, found by one forward
        pass of a single token. Memoized per build/compile/load."""
        self._require_built()
        if self._decode_dtype is None and self.precision is not None:
            self._decode_dtype = self.precision.compute_dtype
        if self._decode_dtype is None:
            with torch.inference_mode():
                x = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
                self._decode_dtype = self.module(x).dtype
        return self._decode_dtype

    # ---------------------------------------------------------------- compile
    def compile(
        self,
        optimizer="sgd",
        loss="sparse_categorical_crossentropy",
        metrics: Iterable = ("accuracy",),
        grad_clip: Optional[float] = None,
        gradient_accumulation_steps: Optional[int] = None,
        head_chunks: Optional[int] = None,
        steps_per_execution: Optional[int] = None,
        precision=None,
        strategy=None,
        hbm_cap_bytes: Optional[int] = None,
        measure: bool = False,
        auto_options: Optional[dict] = None,
        **optimizer_kwargs,
    ):
        """Set the optimizer (a name, with ``optimizer_kwargs`` for its
        constructor, or an ``optim`` instance), the loss (a name, e.g.
        ``"pallas_sparse_categorical_crossentropy"``, or a callable) and the
        metrics. ``strategy`` (a ``parallel.Strategy``) replaces the one
        captured at construction and moves a built model to its device. A
        built model's optimizer state starts afresh, as in JAX.

        ``grad_clip``: clip the gradients' global norm before the update
        (``optim.clip_by_global_norm``, chained before the optimizer).
        ``gradient_accumulation_steps=N``: the mean gradient of N ``fit``
        steps in one update every N-th step (``optim.MultiSteps`` around
        the clip and the optimizer, as in JAX); ``model.step`` advances
        per fit step. ``steps_per_execution=K``: K steps a dispatch (see
        the module docstring).

        ``precision``: a mixed-precision policy (``"float32"``,
        ``"mixed_bfloat16"``, ``"mixed_float16"`` or a
        ``precision.Policy``). Parameters and optimizer state stay f32
        masters; inside each step the layers without a ``dtype=`` of their
        own compute in the policy's dtype from leaves cast there, the
        gradients come back f32 through the casts, and the logits are cast
        to the output dtype for the loss. ``mixed_float16`` wraps the
        optimizer, outermost, in ``optim.dynamic_loss_scaling``: the loss
        is multiplied by the live scale before the backward, and a step
        with a non-finite gradient is skipped. ``generate`` and the Engine
        then keep their KV in the compute dtype.

        ``head_chunks=C``: for a Sequential whose last layer is a tokenwise
        head (the LM's), ``fit`` and ``evaluate`` run the body once and the
        head and the loss over C chunks of the tokens, each under
        ``torch.utils.checkpoint``, so no more than one chunk's logits are
        alive, forward or backward. C must divide each batch's tokens; the
        head must hold no state.

        ``strategy="auto"``: the auto-shard planner
        (``parallel.auto_shard.plan_sharding``) picks the fastest feasible
        strategy, precision, ``steps_per_execution`` and default
        ``fit(grad_accum=)`` for the model on the ranks of the process
        group; it runs at ``build`` (at once on a built model, whose
        parameters then move to the winner's placement). A ``precision``
        or ``steps_per_execution`` given here is pinned: the planner keeps
        it. ``hbm_cap_bytes`` prunes the candidates whose state and
        activations a card would not hold, ``measure=True`` times the
        shortlist with real steps before committing, and ``auto_options``
        passes the planner's other arguments (``batch_size``,
        ``precisions``, ``grad_accums``, ``steps_per_execution``,
        ``include_tp``, ``include_pp``, ``top_k``, ``devices``). The plan
        is ``model.last_plan``, ``last_fit_telemetry["plan"]`` and an
        ``auto_shard_plan`` event. A plain recompile drops a pending plan."""
        if strategy is None:
            # A plain recompile keeps the current strategy but drops any
            # pending plan (and its fit-default grad_accum): the new
            # optimizer or loss invalidates the old decision.
            self._auto_shard = None
            self._auto_grad_accum = None
            self.last_plan = None
        elif isinstance(strategy, str) and strategy == "auto":
            self._auto_shard = {
                "hbm_cap_bytes": hbm_cap_bytes,
                "measure": bool(measure),
                "pinned_precision": precision is not None,
                "pinned_k": steps_per_execution is not None,
                **(dict(auto_options) if auto_options else {}),
            }
            self.last_plan = None
            self._auto_grad_accum = None
        elif isinstance(strategy, Strategy):
            self._auto_shard = None
            self._auto_grad_accum = None
            self.last_plan = None
            self._take_strategy(strategy)
        else:
            raise ValueError(
                "strategy must be None, the string 'auto', or a "
                f"parallel.Strategy instance; got {strategy!r}")
        tx = optim.get(optimizer, **optimizer_kwargs)
        if grad_clip is not None:
            if grad_clip <= 0:
                raise ValueError(f"grad_clip must be > 0, got {grad_clip}")
            tx = optim.chain(optim.clip_by_global_norm(float(grad_clip)), tx)
        if gradient_accumulation_steps is not None:
            n = _positive_int("gradient_accumulation_steps",
                              gradient_accumulation_steps)
            if n > 1:
                tx = optim.MultiSteps(tx, every_k_schedule=n)
        self.precision = precision_lib.get(precision)
        if self.precision is not None and self.precision.loss_scaling:
            # Outermost: the step reads the scale from the state, and the
            # wrapper unscales and checks the gradients before the clip,
            # the accumulation and the optimizer see them.
            tx = optim.dynamic_loss_scaling(
                tx, init_scale=self.precision.initial_loss_scale,
                growth_interval=self.precision.loss_scale_growth_interval,
                factor=self.precision.loss_scale_factor)
        if head_chunks is not None:
            _positive_int("head_chunks", head_chunks)
            _split_head(self.module)  # fail fast on unsuitable modules
        self.head_chunks = int(head_chunks) if head_chunks else None
        self.steps_per_execution = (
            None if steps_per_execution is None
            else _positive_int("steps_per_execution", steps_per_execution))
        self.tx = tx
        self.loss_fn = losses_lib.get(loss)
        self.metric_fns = [(metrics_lib.name_of(m), metrics_lib.get(m))
                           for m in metrics]
        self.compiled = True
        self._graphs = {}
        self._decode_dtype = None
        if self.built:
            if self._auto_shard is not None:
                # Already built: plan now and move the live parameters to
                # the winner's placement.
                self._commit_auto_plan()
            self._init_opt_state()
        return self

    def _take_strategy(self, strategy) -> None:
        """Make ``strategy`` the model's; a built model's parameters leave
        the old strategy's placement (a collective of its group) and take
        the new one's, on its device."""
        if self.built:
            self._unlayout_params()
        self.strategy = strategy
        self.device = strategy.device
        if self.built:
            self.module.to(self.device)
            self._layout_params()

    # -------------------------------------------------------- auto sharding
    def _commit_auto_plan(self):
        """Run the auto-shard planner (``compile(strategy="auto")``) and
        commit its winner: the strategy (built on every rank, in the same
        order), the precision policy, ``steps_per_execution`` and the
        default ``fit(grad_accum=)``. The Plan is kept on
        ``self.last_plan``, summarized into ``last_fit_telemetry["plan"]``
        and emitted as an ``auto_shard_plan`` event. A built model's
        parameters move to the winner's placement."""
        from ..parallel import auto_shard as auto_lib

        cfg = dict(self._auto_shard)
        measure = cfg.pop("measure", False)
        hbm_cap = cfg.pop("hbm_cap_bytes", None)
        pinned_precision = cfg.pop("pinned_precision", False)
        pinned_k = cfg.pop("pinned_k", False)
        if pinned_precision and "precisions" not in cfg:
            cfg["precisions"] = (
                self.precision.name if self.precision is not None else None,)
        if pinned_k and "steps_per_execution" not in cfg:
            cfg["steps_per_execution"] = (self.steps_per_execution or 1,)
        devices = cfg.get("devices")
        device = None if self.device.type == "cuda" else self.device
        plan = auto_lib.plan_sharding(
            self.module, self.input_shape, tx=self.tx, hbm_cap_bytes=hbm_cap,
            measure=measure,
            measure_fn=self._measure_candidate if measure else None,
            seed=self._seed, device=device, **cfg)
        chosen = plan.chosen_candidate()
        self._take_strategy(chosen.build_strategy(devices, device=device))
        if not pinned_k:
            self.steps_per_execution = (
                chosen.steps_per_execution
                if chosen.steps_per_execution > 1 else None)
        current = self.precision.name if self.precision is not None else None
        if chosen.precision != current:
            # Only reachable when the precision was not pinned at compile,
            # so the optimizer carries no loss-scaling wrapper yet.
            self.precision = precision_lib.get(chosen.precision)
            if self.precision is not None and self.precision.loss_scaling:
                self.tx = optim.dynamic_loss_scaling(
                    self.tx, init_scale=self.precision.initial_loss_scale,
                    growth_interval=(
                        self.precision.loss_scale_growth_interval),
                    factor=self.precision.loss_scale_factor)
        self._auto_grad_accum = (
            chosen.grad_accum if chosen.grad_accum > 1 else None)
        self.last_plan = plan
        self._graphs = {}
        self._decode_dtype = None
        summary = plan.summary()
        events_lib.emit(evs.AUTO_SHARD_PLAN, **summary)
        if self.strategy._rank() == 0:
            dlog.info(
                f"auto-shard: chose {plan.chosen['label']} "
                f"(est {plan.chosen['est_step_seconds']:.4f}s/step, "
                f"{plan.chosen['state_bytes_per_device']} state B/dev; "
                f"{len(plan.candidates)} feasible, {len(plan.pruned)} "
                f"pruned, tie_break={plan.tie_break})")
        return plan

    def _measure_candidate(self, cand, ctx, steps: int = 3):
        """Seconds a step of one shortlisted candidate, from real steps:
        a model of a fresh copy of the module under the candidate's
        strategy, precision, ``steps_per_execution`` and ``grad_accum``,
        built from this model's seed, trains on a batch of zeros (the
        planner's probe dtype, int32 labels of the logits' shape): one
        warm-up dispatch (kernel builds, the CUDA graph's capture), then
        ``steps`` steps through ``fit``, ended by a synchronize. Every
        rank runs every candidate in the same order; the seconds are the
        largest over the ranks (one all-reduce), so every rank commits the
        same winner. The candidate's tensors are freed before the next.
        Returns None, with a warning, when the candidate cannot be timed."""
        import copy

        device = None if self.device.type == "cuda" else self.device
        tx = self.tx
        if isinstance(tx, optim.dynamic_loss_scaling):
            tx = tx.inner  # compile re-adds it where the precision needs it
        b, k = ctx["batch_size"], cand.steps_per_execution
        x = np.zeros((b,) + tuple(self.input_shape),
                     torch.empty((), dtype=ctx["x_dtype"]).numpy().dtype)
        y = np.zeros(ctx["logits_shape"][:-1], np.int32)
        secs = float("inf")
        trial = None
        try:
            strat = cand.build_strategy(ctx["devices"], device=device)
            with strat.scope():
                trial = Model(copy.deepcopy(self.module))
            trial.compile(optimizer=tx, loss=self.loss_fn,
                          metrics=[fn for _, fn in self.metric_fns],
                          precision=cand.precision,
                          steps_per_execution=k if k > 1 else None)
            trial.build(self.input_shape, seed=self._seed)
            fit = dict(batch_size=b, epochs=1, shuffle=False, verbose=0,
                       prefetch=0, grad_accum=cand.grad_accum)
            trial.fit(x, y, steps_per_epoch=min(k, steps), **fit)
            _synchronize(trial.device)
            t0 = time.perf_counter()
            trial.fit(x, y, steps_per_epoch=steps, **fit)
            _synchronize(trial.device)
            secs = (time.perf_counter() - t0) / steps
        except Exception as e:  # a candidate that cannot run here
            dlog.warning(f"auto-shard: could not measure {cand.label()}: {e}")
        finally:
            del trial
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend() == "nccl" else torch.device("cpu"))
            t = torch.tensor([secs], dtype=torch.float64, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            secs = float(t.item())
        return None if secs == float("inf") else secs

    def _policy_scope(self):
        """The precision policy's scope (``compile(precision=)``), or
        nothing without one."""
        if self.precision is None:
            return contextlib.nullcontext()
        return self.precision.scope()

    def _logits(self, x):
        """The module's logits, cast to the policy's output dtype."""
        logits = self.module(x)
        if self.precision is not None:
            logits = self.precision.cast_output(logits)
        return logits

    @contextlib.contextmanager
    def _eval_forward(self):
        """``predict``'s forward: yields ``forward(rows)``, the logits of
        the host array ``rows`` on the device, in eval mode, without
        autograd and under the precision policy; the train flag is
        restored after."""
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode(), self._policy_scope():
                yield lambda rows: self._logits(self._to_device(rows))
        finally:
            self.module.train(was_training)

    # -------------------------------------------------------- learning rate
    def set_learning_rate(self, lr: float):
        """Change the learning rate of the current optimizer state (held
        there as an f32 hyperparameter, as optax.inject_hyperparams does;
        found through the clip and accumulation wrappers)."""
        if self.opt_state is None:
            raise RuntimeError("compile() and build() the model first")
        self.opt_state = optim.set_hyperparam(self.opt_state,
                                              "learning_rate", lr)
        return self

    def get_learning_rate(self) -> float:
        if self.opt_state is None:
            raise RuntimeError("compile() and build() the model first")
        return optim.get_hyperparam(self.opt_state, "learning_rate")

    # ------------------------------------------------------------- train step
    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step_key(self, step: int):
        """The step's key, ``fold_in(PRNGKey(seed + 1), step)`` (the JAX
        ``_step_rng``), copied into the model's device key tensor, which
        it returns; None for a module that draws no random numbers."""
        if not needs_rng(self.module):
            return None
        key = threefry.fold_in(threefry.PRNGKey(self._seed + 1), step)
        if self._rng_key is None or self._rng_key.device != self.device:
            self._rng_key = torch.zeros(2, dtype=torch.int64,
                                        device=self.device)
        self._rng_key.copy_(torch.from_numpy(key.astype(np.int64)))
        return self._rng_key

    def _grad_eval(self, x, y, accum_m: int, scale=None, rng=None):
        """Forward, loss and gradients of one optimizer step on a device
        batch: ``(loss, f32 grads, {metric: (sum, count)})``. With
        ``accum_m > 1``, x and y carry a leading microbatch axis: the
        microbatches' gradients are summed in f32 and divided by M, the
        loss is the mean of their means, the metric pairs are summed (the
        JAX ``_accum_train_step_body``). ``scale`` (the live loss scale, a
        device scalar, under ``mixed_float16``): the gradients are those
        of ``loss * scale``; the loss returned is unscaled. ``rng``: the
        step's key (a device tensor) for the layers that draw random
        numbers, microbatch i's ``fold_in(rng, i)``."""
        if accum_m > 1:
            return self._accum_grad_eval(x, y, accum_m, scale, rng)
        params = self._param_list()
        with self.strategy.scope(), self._policy_scope(), rng_scope(rng):
            if self.head_chunks and self.head_chunks > 1:
                loss, mvals = self._chunked_train_loss(x, y)
            else:
                self._clear_aux()
                logits = self._logits(x)
                loss = self._rank_loss(logits, y) + self._aux_sum()
                with torch.no_grad():
                    mvals = {name: fn(logits.detach(), y)
                             for name, fn in self.metric_fns}
            scaled = loss if scale is None else loss * scale
            grads = torch.autograd.grad(scaled, params,
                                        materialize_grads=True)
        return loss.detach(), list(grads), mvals

    def _rank_loss(self, logits, y):
        """This rank's loss as the step differentiates it: the loss
        function's value, except for a loss whose divisor depends on the
        data (``losses.get_sum_count`` knows it, e.g.
        ``cross_entropy_with_ignore``, or a callable that returns a
        ``(sum, count)`` pair): then this rank's sum over the GLOBAL
        count, one all-reduce over the batch group, times the number of
        batch shards N, so the strategy's mean of the ranks' gradients is
        the gradient of the global ratio the JAX step takes (and the
        ranks' losses average to it)."""
        ratio = losses_lib.get_sum_count(self.loss_fn)
        out = (ratio if ratio is not None else self.loss_fn)(logits, y)
        if not isinstance(out, tuple):
            return out
        total, count = out
        n = self.strategy.num_batch_shards
        count = count.detach().to(torch.float32).reshape(1)
        if n > 1:
            count = self.strategy.all_reduce_sum(count.clone())
        return total * n / torch.clamp_min(count[0], 1.0)

    def _clear_aux(self) -> None:
        for m in self.module.modules():
            if isinstance(m, moe_lib.MoE):
                m.aux_term = None

    def _aux_sum(self):
        """The auxiliary objectives the forward left (the MoE layers'
        load-balance terms, the JAX ``_aux_loss_sum``), or 0."""
        terms = moe_lib.aux_terms(self.module)
        return sum(terms) if terms else 0.0

    def _chunked_head(self, h, y, weights):
        """The head, the loss and the metrics over ``head_chunks`` chunks
        of the flattened tokens (the JAX ``_chunked_head_scan``): each
        chunk under ``torch.utils.checkpoint`` when training, so one
        chunk's logits at most are alive, forward or backward; the fused
        loss's per-token values are kept, so its recompute redoes the
        head's product only (K9 once a chunk, K10 once). ``weights``
        (per token, or None: all count). Without gradients (evaluate) the
        chunks run plainly. Returns the weighted loss sum and
        each metric's weighted score sum, device f32 scalars."""
        c = self.head_chunks
        _, head = _split_head(self.module)
        if state_tree(head):
            raise ValueError("head_chunks requires a STATELESS head layer; "
                             f"{head.name!r} carries state")
        if h.dim() < 2:
            raise ValueError("head_chunks expects token activations (..., "
                             f"D); got shape {tuple(h.shape)}")
        d = h.shape[-1]
        n_tok = h.numel() // d
        if n_tok % c:
            raise ValueError(f"head_chunks={c} must divide the token count "
                             f"{n_tok} (= batch x seq)")
        hf = h.reshape(c, n_tok // c, d)
        yf = y.reshape(c, n_tok // c)
        wf = (torch.ones((c, n_tok // c), dtype=torch.float32,
                         device=h.device) if weights is None
              else weights.reshape(c, n_tok // c).to(torch.float32))
        loss_fn, metric_fns = self.loss_fn, tuple(self.metric_fns)
        per_ex = losses_lib.get_per_example(loss_fn)

        def chunk(h_i, y_i, w_i):
            logits = head(h_i)
            if per_ex is not None:
                elems = per_ex(logits, y_i)
                lsum = torch.sum(elems * w_i.to(elems.dtype))
            else:
                # No per-example form: the chunk's mean weighted by its
                # valid count (exact when nothing is padded).
                lsum = loss_fn(logits, y_i) * torch.sum(w_i)
            msums = []
            with torch.no_grad():
                for _, fn in metric_fns:
                    scores = metrics_lib.per_example(fn)
                    if scores is not None:
                        s = scores(logits, y_i)
                        msums.append(torch.sum(s * w_i.to(s.dtype)))
                    else:
                        s, n = fn(logits, y_i)
                        msums.append(s * torch.sum(w_i) / max(float(n), 1.0))
            return (lsum.to(torch.float32),
                    *(m.to(torch.float32) for m in msums))

        total = None
        for i in range(c):
            args = (hf[i], yf[i], wf[i])
            out = (remat_checkpoint(chunk, *args, save=(XENT_FWD_OP,))
                   if torch.is_grad_enabled() else chunk(*args))
            # Summed chunk by chunk in f32, as the JAX scan's carry.
            total = out if total is None else tuple(
                a + b for a, b in zip(total, out))
        return total[0], list(total[1:])

    def _chunked_train_loss(self, x, y):
        """The chunked train objective: the body once, then
        :meth:`_chunked_head`; the loss is the token mean."""
        body, _ = _split_head(self.module)
        self._clear_aux()
        h = apply_layers(body, x)
        loss_sum, msums = self._chunked_head(h, y, None)
        n_tok = float(y.numel())
        loss = loss_sum / n_tok + self._aux_sum()
        mvals = {name: (s.detach(), n_tok)
                 for (name, _), s in zip(self.metric_fns, msums)}
        return loss, mvals

    def _accum_grad_eval(self, xs, ys, m: int, scale=None, rng=None):
        # f32 accumulators whatever the gradients' dtype, as the JAX
        # package's precision.grad_accum_init makes them.
        gsum = precision_lib.grad_accum_init(self._param_list())
        precision_lib.assert_f32_accumulator(gsum)
        loss_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
        msums = {}
        for i in range(m):
            loss, grads, mvals = self._grad_eval(
                xs[i], ys[i], 1, scale,
                None if rng is None else threefry.fold_in(rng, i))
            torch._foreach_add_(gsum, [g.to(torch.float32) for g in grads])
            loss_sum = loss_sum + loss.to(torch.float32)
            for name, (s, c) in mvals.items():
                s0, c0 = msums.get(name, (0.0, 0.0))
                msums[name] = (s0 + s.to(torch.float32), c0 + float(c))
        # Divided by a list of scalars, as optax divides (see optim).
        grads = torch._foreach_div(gsum, [float(m)] * len(gsum))
        return loss_sum / m, grads, msums

    def _apply_update(self, grads) -> None:
        """The strategy's update: ``DataParallel`` averages the gradients
        and updates in place; ZeRO-1 updates each rank's blocks and
        all-gathers them; FSDP divides the reduce-scattered blocks and
        updates them (``Strategy.apply_update``)."""
        self.strategy.apply_update(self.tx, self._param_list(), grads,
                                   self.opt_state, self._opt_layout_list())

    def _train_step(self, x, y, accum_m: int = 1):
        """One optimizer step on a device batch: returns the loss (a
        device scalar) and each metric's (sum, count)."""
        loss, grads, mvals = self._grad_eval(
            x, y, accum_m, optim.loss_scale_value(self.opt_state),
            self._step_key(self.step))
        self._apply_update(grads)
        return loss, mvals

    def _check_capturable(self):
        why = self.strategy.forward_collectives(
            _has_batch_norm(self.module), moe=moe_lib.has_moe(self.module))
        if why is not None:
            raise NotImplementedError(why)

    def _graph_grad_eval(self, x, y, accum_m: int, scale=None, rng=None):
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype, accum_m)
        graph = self._graphs.get(key)
        if graph is None:
            # The loss scale and the step key are static inputs: copied in
            # before each replay, never host values frozen at capture.
            graph = self._graphs[key] = StepGraph(
                lambda a, b, s, r: self._grad_eval(a, b, accum_m, s, r),
                self.module, x, y, scale, rng)
        return graph.replay(x, y, scale, rng)

    def _multi_step(self, xs, ys, k: int, accum_m: int):
        """``k`` optimizer steps on a stacked device batch (``[k, batch,
        ...]``, or ``[k*M, micro, ...]`` with accumulation) with no host
        sync: returns the k losses' sum and the metric pairs' sums, on
        the device (the JAX ``_get_multi_step_train_step``)."""
        grad_eval = (self._graph_grad_eval if xs.is_cuda
                     else self._grad_eval)
        loss_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
        msums = {name: (loss_sum, 0.0) for name, _ in self.metric_fns}
        for i in range(k):
            rows = slice(i * accum_m, (i + 1) * accum_m)
            x, y = ((xs[i], ys[i]) if accum_m == 1
                    else (xs[rows], ys[rows]))
            loss, grads, mvals = grad_eval(
                x, y, accum_m, optim.loss_scale_value(self.opt_state),
                self._step_key(self.step + i))
            self._apply_update(grads)
            loss_sum = loss_sum + loss.to(torch.float32)
            msums = {name: (s + mvals[name][0].to(torch.float32),
                            c + float(mvals[name][1]))
                     for name, (s, c) in msums.items()}
        return loss_sum, msums

    def _stager_for(self) -> DeviceStager:
        if self._stager is None or self._stager.device != self.device:
            self._stager = DeviceStager(self.device)
        return self._stager

    @staticmethod
    def _split(buf, stacked, accum_m):
        """A staged buffer ``(k, n, ...)`` as the step takes it: ``(n,
        ...)`` unstacked, ``(k*M, n/M, ...)`` with accumulation (``(M,
        n/M, ...)`` unstacked); views."""
        if accum_m > 1:
            return buf.view((-1, buf.shape[1] // accum_m) + buf.shape[2:])
        return buf if stacked else buf[0]

    def _stage_rows(self, arrays, idxs, stacked, accum_m):
        """Stage rows ``idxs`` (an index array a step) of the host arrays
        (CPU tensors): this replica's rows of each microbatch, gathered by
        ``torch.index_select`` (threaded, without the GIL) straight into
        the stager's buffers."""
        stager = self._stager_for()
        rows = []
        for idx in idxs:
            idx = np.asarray(idx).reshape(accum_m, -1)
            lo, hi = self.strategy.row_range(idx.shape[1])
            rows.append(torch.from_numpy(
                np.ascontiguousarray(idx[:, lo:hi]).reshape(-1)))
        batch = {}
        for name, src in arrays.items():
            src = self.strategy.shard_seq(src)
            buf = stager.host(name, (len(rows), len(rows[0]))
                              + tuple(src.shape[1:]), src.dtype)
            for i, r in enumerate(rows):
                torch.index_select(src, 0, r, out=buf[i])
            batch[name] = self._split(buf, stacked, accum_m)
        return stager.stage(batch)

    def _stage_batch(self, arrays, stacked, accum_m, per_host):
        """Stage an iterator's host batches (``(B, ...)``, or ``(k, B,
        ...)`` stacked): this replica's rows of each microbatch (all of a
        per-host source's), copied into the stager's buffers."""
        stager = self._stager_for()
        batch = {}
        for name, a in arrays.items():
            t = torch.from_numpy(np.asarray(a))
            t = self.strategy.shard_seq(t, 2 if stacked else 1)
            t = t if stacked else t[None]
            if not per_host:
                k, n = t.shape[:2]
                lo, hi = self.strategy.row_range(n // accum_m)
                t = t.reshape((k, accum_m, n // accum_m) + t.shape[2:])
                t = t[:, :, lo:hi].reshape((k, -1) + t.shape[3:])
            buf = stager.host(name, t.shape, t.dtype)
            buf.copy_(t)
            batch[name] = self._split(buf, stacked, accum_m)
        return stager.stage(batch)

    def _stage_pipeline(self, source, k, stacked, accum_m):
        """Stage ``k`` batches of a ``data.Pipeline`` that emits this
        replica's rows: it writes them straight into the stager's
        buffers (``next_k(out=)``)."""
        stager = self._stager_for()
        xs = stager.host("x", (k,) + tuple(source.batch_shape),
                         torch.float32)
        ys = stager.host("y", (k, source.shard_rows), torch.int32)
        source.next_k(k, out=(xs.numpy(), ys.numpy()))
        return stager.stage({"x": self._split(xs, stacked, accum_m),
                             "y": self._split(ys, stacked, accum_m)})

    # -------------------------------------------------------------------- fit
    def fit(
        self,
        x,
        y=None,
        batch_size: int = 32,
        epochs: int = 1,
        steps_per_epoch: Optional[int] = None,
        validation_data=None,
        validation_steps: Optional[int] = None,
        shuffle: bool = True,
        verbose: int = 1,
        initial_epoch: int = 0,
        seed: Optional[int] = None,
        callbacks: Sequence = (),
        prefetch: Optional[int] = None,
        grad_accum: Optional[int] = None,
    ) -> History:
        """Train on host arrays ``(x, y)`` or on a batch iterator ``x``
        (``y=None``; e.g. ``data.Pipeline``, whose ``batch_size``,
        ``steps_per_pass`` and ``batch_shape`` it reads; a plain iterator
        needs ``steps_per_epoch``). Arrays: ``batch_size`` rows per step
        (the global batch: under ``DataParallel`` each rank takes its
        share, and it must divide evenly), ``steps_per_epoch`` steps per
        epoch (default ``len(x) // batch_size``), batches drawn in the JAX
        package's order (``shuffle``, ``seed``), continuing from
        ``model.step``. Returns a ``History`` of per-epoch means.

        ``grad_accum=M`` splits each step's batch into M microbatches and
        applies one update of their mean gradient (module docstring).
        ``prefetch`` (default 2, or ``DTPU_PREFETCH_DEPTH``) is how many
        dispatches a background thread stages ahead (0: inline); the
        stream is the same at any depth, and a mid-epoch stop rewinds a
        seekable source to the step trained. The stall report lands in
        ``model.last_fit_telemetry``.

        ``callbacks`` (``training.callbacks``) are called as in the JAX
        package: ``on_train_begin`` (before the batch order is set, so a
        restoring ``ModelCheckpoint`` moves it), then per epoch
        ``on_epoch_begin``, ``on_batch_end(model, step, {"loss": device
        scalar})`` after each dispatch (the global batch's loss, the
        dispatch's per-step mean under ``steps_per_execution``; under
        ``DataParallel`` the ranks' losses are averaged for it, one
        all-reduce a dispatch when there are callbacks) and
        ``on_epoch_end(model, epoch, logs)``, and ``on_train_end(model,
        history)``; a callback that sets ``model.stop_training`` ends the
        run after the dispatch or epoch.
        After a restore (``model._resumed_step``) with ``initial_epoch``
        0, ``epochs`` is the total: the finished epochs are skipped and
        the interrupted one runs its remaining steps.
        ``validation_data`` — ``(x, y)`` arrays, or a batch iterator read
        for ``validation_steps`` batches (default: one pass) — is
        evaluated after each epoch and logged as ``val_<name>``."""
        if not self.compiled:
            raise RuntimeError("Call compile() before fit()")
        if self.built and quant_lib.is_quantized(self.module):
            raise RuntimeError(
                "model parameters are int8-quantized (quant.quantize_model)"
                " — quantized weights carry no gradients, so fit() is "
                "unavailable. Serve with generate()/predict()/serving."
                "Engine, or restore the f32 checkpoint to keep training.")
        self._fit_source = None
        if y is None:
            if not hasattr(x, "__next__"):
                raise ValueError(
                    "fit(x) without y requires a batch iterator "
                    "(e.g. distributed_tpu_torch.data.Pipeline)")
            source = x
            # Checkpoints taken during this fit record its cursor.
            self._fit_source = source
            batch_size = getattr(source, "batch_size", batch_size)
            per_host = _per_host_source(source, self.strategy)
            if steps_per_epoch is None:
                steps_per_epoch = getattr(source, "steps_per_pass", None)
                if steps_per_epoch is None:
                    raise ValueError(
                        "steps_per_epoch is required with a plain iterator")
            if not self.built:
                bshape = getattr(source, "batch_shape", None)
                if bshape is None:
                    raise RuntimeError(
                        "Build the model first (model.build(input_shape)) "
                        "when fitting from an iterator without batch_shape")
                self.build(tuple(bshape[1:]), seed=0 if seed is None else seed)

            def next_batch():
                return next(source)
        else:
            source, per_host = None, False
            x = _host_array(x)
            y = _host_array(y)
            if not self.built:
                self.build(x.shape[1:], seed=0 if seed is None else seed)
            n = x.shape[0]
            if batch_size > n:
                raise ValueError(f"batch_size {batch_size} > dataset size {n}")
            if steps_per_epoch is None:
                steps_per_epoch = n // batch_size
        if grad_accum is None:
            # compile(strategy="auto") may have planned an accumulation
            # factor; an explicit fit argument still wins.
            grad_accum = self._auto_grad_accum
        accum_m = 1 if grad_accum is None else _positive_int("grad_accum",
                                                             grad_accum)
        if batch_size % accum_m:
            raise ValueError(
                f"grad_accum={accum_m} must divide batch_size {batch_size} "
                "(each optimizer step's batch splits into M equal "
                "microbatches)")
        self.strategy.local_batch_size(batch_size // accum_m)
        if (validation_data is not None
                and hasattr(validation_data, "__next__")
                and validation_steps is None
                and getattr(validation_data, "steps_per_pass", None) is None):
            raise ValueError(
                "validation_steps is required when validation_data is a "
                "plain iterator (sources with steps_per_pass, e.g. "
                "data.Pipeline, default to one pass)")
        multi_k = self.steps_per_execution or 1
        if multi_k > 1 and self.device.type == "cuda":
            self._check_capturable()
        if prefetch is None:
            prefetch = int(os.environ.get("DTPU_PREFETCH_DEPTH", "2"))
        prefetch = max(0, int(prefetch))
        timer = StepTimer()
        self._stall_timer = timer
        history = History()
        callbacks = list(callbacks)
        self.stop_training = False
        self._resumed_step = None
        for cb in callbacks:
            cb.on_train_begin(self)
        if y is not None:
            # After on_train_begin: a restoring ModelCheckpoint may have
            # moved self.step, and the batch order continues from it.
            stream = _index_stream(n, batch_size, shuffle, seed,
                                   start_step=self.step)
            arrays = {"x": _host_tensor(x), "y": _host_tensor(y)}

        def stage(k):
            """``k`` steps' batches on the device: ``(B, ...)`` for one
            step, ``[k, B, ...]`` stacked; with accumulation the batch axis
            splits into ``[M, B/M]`` (``[k*M, B/M, ...]`` stacked, as the
            JAX loop stages it). This replica's rows of the batch axis,
            written straight into the stager's (pinned) buffers."""
            stacked = multi_k > 1
            if y is not None:
                return self._stage_rows(
                    arrays, [next(stream) for _ in range(k)], stacked,
                    accum_m)
            if isinstance(source, Pipeline) and (
                    per_host or self.strategy.num_replicas_in_sync == 1
            ) and self.strategy.num_batch_shards == (
                    self.strategy.num_replicas_in_sync):
                # Its rows as they come; under a sequence split each
                # rank cuts its positions from them (_stage_batch).
                return self._stage_pipeline(source, k, stacked, accum_m)
            if stacked:
                pairs = [next_batch() for _ in range(k)]
                xb = np.stack([p[0] for p in pairs])
                yb = np.stack([p[1] for p in pairs])
            else:
                xb, yb = next_batch()
            return self._stage_batch({"x": xb, "y": yb}, stacked, accum_m,
                                     per_host)

        resume_offset = 0
        if self._resumed_step is not None and initial_epoch == 0:
            initial_epoch, resume_offset = divmod(self._resumed_step,
                                                  steps_per_epoch)
            if y is None:
                self._rewind_source(source)
        self._resumed_step = None
        self._restored_data_state = None
        clear_overlap_trace()
        clear_pipeline_trace()
        self.module.train()
        try:
            self._fit_epochs(
                epochs, steps_per_epoch, batch_size, verbose, initial_epoch,
                resume_offset, stage, multi_k, accum_m, prefetch, source,
                history, callbacks, validation_data, validation_steps, timer)
        finally:
            self.module.eval()
        for cb in callbacks:
            # Before the report: a flushing ModelCheckpoint's wait counts
            # as checkpoint_wait.
            cb.on_train_end(self, history)
        self._finish_telemetry(timer, source)
        self._stall_timer = None
        return history

    def _rewind_source(self, source):
        """Move an iterator source to the restored step: the checkpoint's
        cursor (``load_state``, which checks the stream's identity), else
        a seek, else replaying a counting iterator; a plain iterator gets
        a warning."""
        data_state = self._restored_data_state
        if data_state is not None and hasattr(source, "load_state"):
            source.load_state(data_state)
        elif hasattr(source, "seek"):
            source.seek(self._resumed_step)
        elif getattr(source, "steps_emitted", None) is not None:
            for _ in range(max(0, self._resumed_step
                               - source.steps_emitted)):
                next(source)
        else:
            dlog.warning(
                "Resuming from a plain iterator: cannot fast-forward the "
                "data source; batch alignment with the restored step "
                f"({self._resumed_step}) is the caller's responsibility")

    def _fit_epochs(self, epochs, steps_per_epoch, batch_size, verbose,
                    initial_epoch, resume_offset, stage, multi_k, accum_m,
                    prefetch, source, history, callbacks, validation_data,
                    validation_steps, timer):
        reps = self.strategy.num_batch_shards
        obs_reg = obs_registry.default_registry()
        obs_rec = obs_flight.default_recorder()
        flush_every = max(
            1, int(os.environ.get("DTPU_OBS_FLUSH_EVERY", "5") or 5))
        self._obs_window = []  # (per-step wall, per-step own host seconds)
        self._fit_steps_done = 0
        for epoch in range(initial_epoch, epochs):
            t0 = time.perf_counter()
            for cb in callbacks:
                cb.on_epoch_begin(self, epoch)
            losses = []
            msums: Dict[str, list] = {name: [] for name, _ in self.metric_fns}
            epoch_steps = steps_per_epoch - resume_offset
            resume_offset = 0
            bar = None
            if verbose == 1:
                bar = ProgressLine(epoch_steps,
                                   prefix=f"Epoch {epoch + 1}/{epochs}: ")
            # Each dispatch's size is fixed up front ([1, ...] plain; [K,
            # ..., tail] fused), so the producer never reads past the epoch.
            sizes, left = [], epoch_steps
            while left > 0:
                sizes.append(min(multi_k, left))
                left -= sizes[-1]
            staged = DevicePrefetcher(stage, sizes, depth=prefetch)
            done = 0
            last_t = time.perf_counter()
            try:
                for k in sizes:
                    with obs_spans.span("input_wait", timer=timer) as sp_in:
                        _, batch = staged.get()
                        batch = batch.tensors
                    with obs_spans.span("dispatch", timer=timer) as sp_disp:
                        if multi_k == 1:
                            loss, mvals = self._train_step(
                                batch["x"], batch["y"], accum_m)
                            loss_log = loss
                        else:
                            loss, mvals = self._multi_step(
                                batch["x"], batch["y"], k, accum_m)
                            loss_log = loss / k
                    self.step += k
                    done += k
                    self._fit_steps_done += k
                    # Liveness beat for a gang launcher (throttled; a no-op
                    # outside a gang): one a dispatch, so a K-step CUDA
                    # graph dispatch beats once.
                    _gang_heartbeat()
                    losses.append(loss)  # a step's loss, or a K-step sum
                    for name, _ in self.metric_fns:
                        msums[name].append(mvals[name])
                    if callbacks:
                        # The global batch's loss on every rank, as in JAX.
                        logs = {"loss": loss_log if reps == 1 else
                                self.strategy.all_reduce_sum(
                                    loss_log.clone()) / reps}
                        for cb in callbacks:
                            cb.on_batch_end(self, self.step, logs)
                    if bar is not None:
                        bar.update(done)
                    # The iteration's wall and own host time (wall less
                    # the input and dispatch waits): one flight record and
                    # one ring entry a dispatch; no device value read.
                    now = time.perf_counter()
                    wall, last_t = now - last_t, now
                    own = max(wall - sp_in.seconds - sp_disp.seconds, 0.0)
                    obs_reg.ring_append("fit/step_seconds", {
                        "step": int(self.step), "k": int(k),
                        "seconds": round(wall, 6),
                        "self_seconds": round(own, 6)})
                    obs_rec.record(
                        "step", step=int(self.step), k=int(k),
                        seconds=round(wall, 6),
                        input_wait_s=round(sp_in.seconds, 6),
                        dispatch_s=round(sp_disp.seconds, 6),
                        self_s=round(own, 6))
                    obs_reg.counter("fit/steps", k)
                    self._obs_window.append((wall / k, own / k))
                    self._flush_obs_window(flush_every)
                    if self.stop_training:
                        break
            except SystemExit:
                raise  # a deliberate exit (preemption): its own dump ran
            except BaseException as e:
                # The step loop died: leave the black box behind (a no-op
                # unless a dump location is configured).
                obs_flight.dump(reason=f"exception:{type(e).__name__}")
                raise
            finally:
                staged.close()
                if staged.unconsumed_steps and source is not None and (
                        hasattr(source, "seek") and getattr(
                            source, "steps_emitted", None) is not None):
                    # The producer staged past a mid-epoch stop: rewind so
                    # the source's cursor is the step actually trained.
                    source.seek(source.steps_emitted
                                - staged.unconsumed_steps)
            if bar is not None:
                bar.close()
            epoch_steps = done
            # One host sync per epoch: every loss and metric sum at once,
            # summed over the replicas (each loss is its rank's mean, so the
            # losses are divided by their number; each rank scores as many
            # elements, so the counts are multiplied by it).
            with obs_spans.span("dispatch", timer=timer):
                vec = self.strategy.all_reduce_sum(torch.cat(
                    [torch.stack(losses).to(torch.float32)]
                    + [torch.stack([p[0] for p in pairs]).to(torch.float32)
                       for pairs in msums.values()])).cpu().numpy()
            # The epoch's host sync is where the queued work catches up:
            # beat again so the epoch's end starts freshly armed.
            _gang_heartbeat()
            n_loss = len(losses)
            if multi_k == 1:
                logs = {"loss": float(np.mean(vec[:n_loss] / reps))}
            else:
                logs = {"loss": float(np.sum(vec[:n_loss] / reps)
                                      / max(epoch_steps, 1))}
            for i, (name, pairs) in enumerate(msums.items()):
                s = vec[(i + 1) * n_loss:(i + 2) * n_loss]
                c = np.float32(sum(float(p[1]) for p in pairs) * reps)
                logs[name] = float(np.float32(s.sum()) / max(c, 1.0))
            if validation_data is not None:
                if hasattr(validation_data, "__next__"):
                    val = self.evaluate(validation_data,
                                        steps=validation_steps, verbose=0)
                else:
                    val = self.evaluate(validation_data[0],
                                        validation_data[1],
                                        batch_size=batch_size, verbose=0)
                logs.update({f"val_{k}": v for k, v in val.items()})
            dt = time.perf_counter() - t0
            history.record(epoch, logs)
            obs_rec.record("epoch_end", epoch=int(epoch),
                           steps=int(epoch_steps), seconds=round(dt, 4),
                           loss=round(float(logs["loss"]), 6))
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, logs)
                # A checkpoint write can be slow: beat between callbacks
                # (liveness_timeout must still exceed any single blocking
                # operation, see launch.LocalLauncher.run).
                _gang_heartbeat()
            if self.stop_training:
                epochs = epoch + 1  # for the epoch counter printed below
            if verbose:
                parts = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                print(f"Epoch {epoch + 1}/{epochs} - "
                      f"{batch_size * done} samples - {dt:.2f}s "
                      f"({dt / max(done, 1) * 1000:.1f}ms/step) - {parts}")
            if self.stop_training:
                break

    def _flush_obs_window(self, every: int, force: bool = False):
        """Emit the steps' wall and own seconds since the last flush as a
        ``metrics_snapshot`` event (with the registry on and an event log
        set) every ``every`` dispatches, and at the fit's end."""
        window = self._obs_window
        if not window or (not force and len(window) < every):
            return
        if obs_registry.enabled() and events_lib.default_log() is not None:
            rank, world = dlog.rank_world()
            events_lib.emit(
                evs.METRICS_SNAPSHOT, rank=int(rank), world=int(world),
                step=int(self.step),
                step_seconds=[round(w, 6) for w, _ in window[-64:]],
                self_seconds=[round(s, 6) for _, s in window[-64:]])
        window.clear()

    def _finish_telemetry(self, timer, source):
        """``last_fit_telemetry``: the stall report and the JAX report's
        other keys (device memory, the model state's bytes, the precision
        policy, the collective estimate, the scanned-overlap record),
        stored in the metrics registry as ``model.fit``."""
        report = timer.stall_report()
        report["device_memory"] = _device_memory(self.device)
        # Measured from what this rank holds (blocks where sharded), the
        # largest over the ranks, as the JAX report's tree_bytes_per_device.
        report["model_state_bytes_per_device"] = tree_bytes_per_device(
            self._param_list(), list(self.state.values()),
            self.opt_state)["max_bytes_per_device"]
        # The buddy tier's price (ModelCheckpoint(buddy=) sets it at train
        # end): the mirror bytes beside the state bytes they insure.
        red = getattr(self, "_redundancy_report", None)
        if red is not None:
            report["redundancy"] = red
        report["precision"] = (None if self.precision is None
                               else self.precision.name)
        if source is not None and getattr(source, "decode_workers",
                                          None) is not None:
            report["input_decode_workers"] = int(source.decode_workers)
        report["comm_bytes_estimate"] = self.strategy.comm_bytes_estimate(
            {p: torch.empty(s, dtype=t.dtype, device="meta") for (p, s), t
             in zip(self._param_shapes().items(), self._param_list())},
            compute_dtype=(None if self.precision is None
                           else self.precision.compute_dtype),
            hints=self.module.sharding_hints())
        # The scanned stack's record of this fit's last forward on this
        # thread (nn.scan.last_overlap_trace), read as the JAX report reads
        # its trace-time record: with the FSDP gather overlapped, only
        # layer 0's gather is exposed (1/L), else all of them (1.0).
        record = last_overlap_trace()
        if record is None:
            record = self._overlap_record
        else:
            self._overlap_record = record
        layers = int(record["layers"]) if record else 0
        active = bool(record and record["active"])
        report["overlap"] = {
            "overlap": active,
            "exposed_comm_fraction": (round(1.0 / layers, 6)
                                      if active and layers else 1.0),
            "layers": layers,
        }
        if obs_registry.enabled() and events_lib.default_log() is not None:
            events_lib.emit(
                evs.OVERLAP_REPORT, overlap=report["overlap"]["overlap"],
                exposed_comm_fraction=report["overlap"][
                    "exposed_comm_fraction"],
                layers=layers, strategy=type(self.strategy).__name__)
        # The pipelined stack's schedule record (nn.pipeline), read as the
        # JAX report reads its trace-time record.
        ptrace = last_pipeline_trace()
        if ptrace is None:
            ptrace = getattr(self, "_pipeline_record", None)
        else:
            self._pipeline_record = ptrace
        if ptrace is not None:
            report["pipeline"] = dict(ptrace)
            if obs_registry.enabled() and \
                    events_lib.default_log() is not None:
                events_lib.emit(
                    evs.PIPELINE_SCHEDULE_SELECTED,
                    schedule=ptrace["schedule"],
                    interleave=ptrace["interleave"],
                    num_stages=ptrace["num_stages"],
                    num_microbatches=ptrace["num_microbatches"],
                    strategy=type(self.strategy).__name__)
                events_lib.emit(
                    evs.BUBBLE_REPORT,
                    bubble_fraction=ptrace["bubble_fraction"],
                    ticks=ptrace["ticks"], schedule=ptrace["schedule"],
                    interleave=ptrace["interleave"],
                    num_stages=ptrace["num_stages"],
                    num_microbatches=ptrace["num_microbatches"])
        # The auto-shard decision rides with every fit it governed.
        if self.last_plan is not None:
            report["plan"] = self.last_plan.summary()
        self._flush_obs_window(1, force=True)
        obs_reg = obs_registry.default_registry()
        obs_reg.gauge("fit/steps_per_sec", round(
            self._fit_steps_done / report["total_seconds"], 3))
        obs_reg.gauge("fit/input_stall_fraction",
                      report["input_stall_fraction"])
        obs_reg.gauge("fit/model_state_bytes_per_device",
                      report["model_state_bytes_per_device"])
        for key, val in (report["device_memory"] or {}).items():
            obs_reg.gauge(f"fit/device_memory/{key}", val)
        self.last_fit_telemetry = obs_reg.set_report("model.fit", report)

    # --------------------------------------------------------------- evaluate
    def _score(self, xb, yb, rows=None, *, per_ex):
        """Device sums and host counts of one batch: ``([loss, the ratio
        loss's count or None, the aux terms or None, metric...],
        [count...])``. ``rows``: the batch's valid rows when it was padded
        (the last batch of a chunked head, an MoE or a pipelined model,
        as the JAX step pads), else all count. The MoE layers' aux terms
        are weighted by the valid count, as in JAX."""
        if self.head_chunks and self.head_chunks > 1:
            return self._score_chunked(xb, yb, rows)
        n = yb.shape[0]
        mask = None
        if rows is not None:
            mask = (torch.arange(n, device=yb.device) < rows).to(
                torch.float32)
        self._clear_aux()
        weights = (moe_lib.sample_weights(mask) if mask is not None
                   and per_ex is not None else contextlib.nullcontext())
        with weights:
            logits = self._logits(xb)

        def weighted(elems):
            if mask is None:
                return elems.sum(), float(elems.numel())
            w = mask.reshape((n,) + (1,) * (elems.dim() - 1)).expand(
                elems.shape).to(elems.dtype)
            return (elems * w).sum(), float(rows * (elems.numel() // n))

        per_row = yb.numel() // max(n, 1)
        valid = float((n if rows is None else rows) * per_row)
        ratio_count = None
        if per_ex is not None:
            loss_sum, counted = weighted(per_ex(logits, yb))
            if mask is not None:
                valid = counted
        else:
            out = (losses_lib.get_sum_count(self.loss_fn)
                   or self.loss_fn)(logits, yb)
            if isinstance(out, tuple):
                # A ratio: its sums and counts over the ranks make the
                # global batch's ratio, weighted by the batch's valid
                # count (``_eval_batches``).
                loss_sum, ratio_count = out[0], out[1].to(torch.float32)
            else:
                loss_sum = out * valid
        row_sums, row_counts = [loss_sum, ratio_count,
                                self._aux_weighted(valid)], [valid]
        for name, fn in self.metric_fns:
            scores = metrics_lib.per_example(fn)
            if scores is not None:
                sc, cnt = weighted(scores(logits, yb))
                row_sums.append(sc)
                row_counts.append(cnt)
            else:
                msum, mcount = fn(logits, yb)
                if mask is not None:
                    ex = float(rows)
                    msum = msum * ex / max(float(mcount), 1.0)
                    mcount = ex
                row_sums.append(msum)
                row_counts.append(float(mcount))
        return [None if v is None else v.to(torch.float32)
                for v in row_sums], row_counts

    def _score_chunked(self, xb, yb, rows):
        """:meth:`_score` through the chunked head: the body once, then the
        head, the loss and the metrics per chunk of tokens, the padded
        rows weighted 0 (the JAX ``_get_chunked_eval_step``)."""
        n = yb.shape[0]
        rows = n if rows is None else rows
        mask = (torch.arange(n, device=yb.device) < rows).to(torch.float32)
        w = mask.reshape((n,) + (1,) * (yb.dim() - 1)).expand(yb.shape)
        body, _ = _split_head(self.module)
        self._clear_aux()
        weights = (moe_lib.sample_weights(mask) if losses_lib.
                   get_per_example(self.loss_fn) is not None
                   else contextlib.nullcontext())
        with weights:
            h = apply_layers(body, xb)
        loss_sum, msums = self._chunked_head(h, yb, w)
        valid = float(rows * (yb.numel() // max(n, 1)))
        return ([loss_sum, None, self._aux_weighted(valid)] + msums), \
            [valid] * (1 + len(msums))

    def _aux_weighted(self, valid):
        """The MoE layers' aux terms of the last forward times the valid
        count (JAX's ``_aux_loss_sum(state) * valid``), or None: a slot of
        its own, added after a ratio loss is formed (``_eval_batches``)."""
        aux = self._aux_sum()
        return aux * valid if torch.is_tensor(aux) else None

    def _eval_batches(self, batches):
        """Sum the scores of ``batches`` (an iterable of device ``(x, y)``
        pairs of this replica, ``(x, y, valid rows)`` for a padded one, or
        None for a batch that ends before its rows) in eval mode, reduced over the replicas; returns the
        per-element means."""
        per_ex = losses_lib.get_per_example(self.loss_fn)
        k = 1 + len(self.metric_fns)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sums, counts = [], []
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode(), self.strategy.scope(), \
                    self._policy_scope():
                for pair in batches:
                    if pair is None:
                        sums.append([zero, None, None] + [zero] * (k - 1))
                        counts.append([0.0] * k)
                        continue
                    s, c = self._score(*pair, per_ex=per_ex)
                    sums.append(s)
                    counts.append(c)
                    _gang_heartbeat()
        finally:
            self.module.train(was_training)
        rows = [[v if v is not None else zero for v in row] for row in sums]
        vec = self.strategy.all_reduce_sum(torch.cat([
            torch.stack([v for row in rows for v in row]).to(torch.float64),
            torch.tensor([c for row in counts for c in row],
                         dtype=torch.float64, device=self.device),
        ])).cpu().numpy()
        nb = len(rows)
        vals = vec[:nb * (k + 2)].reshape(nb, k + 2)
        dens_b = vec[nb * (k + 2):].reshape(nb, k)
        ratio = any(row[1] is not None for row in sums)
        for b in range(nb):
            if ratio or vals[b, 1] > 0:
                # The global batch's ratio times its valid count.
                vals[b, 0] *= dens_b[b, 0] / max(vals[b, 1], 1.0)
        # The aux terms join after the ratio is formed, as in JAX.
        vals[:, 0] += vals[:, 2]
        vals = np.delete(vals, (1, 2), axis=1)
        totals = [sum(float(v) for v in vals[:, j]) for j in range(k)]
        dens = [sum(float(c) for c in dens_b[:, j]) for j in range(k)]
        out = {"loss": totals[0] / max(dens[0], 1.0)}
        for j, (name, _) in enumerate(self.metric_fns, start=1):
            out[name] = totals[j] / max(dens[j], 1.0)
        return out

    def evaluate(self, x, y=None, batch_size: int = 32, verbose: int = 1,
                 steps: Optional[int] = None) -> Dict[str, float]:
        """Loss and metrics over arrays ``(x, y)``, or over ``steps``
        batches of a batch iterator ``x`` (default: the source's
        ``steps_per_pass``; the iterator is advanced, not reset), as
        per-element means (an LM's loss is the mean over every token, as
        in training). The last batch of arrays may be partial; it is
        scored as it is, with no padding (PyTorch needs no static
        shapes), which the JAX package's masked padding computes the
        same. Under ``DataParallel`` each rank scores its rows of every
        batch and the sums are reduced across the ranks at the end. The
        module runs in eval mode and is left in the mode it was in
        (``fit`` validates between its epochs)."""
        if y is None:
            if hasattr(x, "__next__"):
                return self._evaluate_iterator(x, steps=steps,
                                               verbose=verbose)
            raise TypeError(
                "evaluate() needs (x, y) arrays or a batch iterator "
                f"yielding (x, y); got {type(x).__name__} without labels")
        if not (self.built and self.compiled):
            raise RuntimeError("Model must be built and compiled")
        x = self.strategy.shard_seq(_host_array(x))
        y = self.strategy.shard_seq(_host_array(y))
        n = x.shape[0]
        lo, hi = self.strategy.row_range(batch_size)
        # The chunks split the batch's tokens, an MoE routes the batch's
        # tokens in groups, a pipeline splits its rows into microbatches,
        # and a loss without a per-example form is taken over the whole
        # batch: those score a short last batch padded to batch_size with
        # its last row, weighted 0, as the JAX package pads every batch.
        padded = bool(self.head_chunks and self.head_chunks > 1) or any(
            isinstance(m, (moe_lib.MoE, PipelinedBlocks))
            for m in self.module.modules()) or (
            losses_lib.get_per_example(self.loss_fn) is None)

        def batches():
            for start in range(0, n, batch_size):
                if padded:
                    xb, yb = x[start:start + batch_size], y[start:start
                                                             + batch_size]
                    valid = xb.shape[0]
                    if valid < batch_size:
                        pad = batch_size - valid
                        xb = np.concatenate([xb, np.repeat(xb[-1:], pad, 0)])
                        yb = np.concatenate([yb, np.repeat(yb[-1:], pad, 0)])
                    yield (self._to_device(xb[lo:hi]),
                           self._to_device(yb[lo:hi]),
                           min(max(valid - lo, 0), hi - lo))
                    continue
                rows = slice(min(start + lo, n), min(start + hi, n))
                if rows.start == rows.stop:  # the batch ends before us
                    yield None
                else:
                    yield (self._to_device(x[rows]), self._to_device(y[rows]))

        out = self._eval_batches(batches())
        if verbose:
            parts = " - ".join(f"{k}: {v:.4f}" for k, v in out.items())
            print(f"Evaluate - {n} samples - {parts}")
        return out

    def _evaluate_iterator(self, source, *, steps=None, verbose=1):
        if not (self.built and self.compiled):
            raise RuntimeError("Model must be built and compiled")
        if steps is None:
            steps = getattr(source, "steps_per_pass", None)
            if steps is None:
                raise ValueError(
                    "steps is required when evaluating from a plain "
                    "iterator (sources with steps_per_pass, e.g. "
                    "data.Pipeline, default to one pass)")
        per_host = _per_host_source(source, self.strategy)
        rows = [0]

        def batches():
            for step_i in range(int(steps)):
                try:
                    xb, yb = next(source)
                except StopIteration:
                    raise ValueError(
                        f"validation iterator exhausted after {step_i} of "
                        f"{int(steps)} batches — a finite iterator cannot "
                        "be re-consumed across epochs; use a repeating "
                        "source (data.Pipeline) or pass a smaller steps/"
                        "validation_steps") from None
                rows[0] += np.shape(xb)[0]
                t = self._stage_batch({"x": xb, "y": yb}, False, 1,
                                      per_host).tensors
                yield t["x"], t["y"]

        out = self._eval_batches(batches())
        if verbose:
            n = rows[0] * (int(source.shard[1]) if per_host else 1)
            parts = " - ".join(f"{k}: {v:.4f}" for k, v in out.items())
            print(f"Evaluate - {n} samples - {parts}")
        return out

    # ---------------------------------------------------------------- predict
    def predict(self, x, batch_size: int = 32,
                steps: Optional[int] = None) -> np.ndarray:
        """The logits of every row of the host array ``x``, as f32 numpy,
        ``batch_size`` rows per forward pass in eval mode (the last batch
        partial); or of ``steps`` batches of a batch iterator (default:
        the source's ``steps_per_pass``; batches are ``(x, y)`` or bare
        x, and ``batch_size`` is ignored). Under ``DataParallel`` every
        rank computes all rows, so each returns the whole result, as in
        the JAX package. A per-host-sharded source (``data.Pipeline(
        shard=)``) gives each rank its rows of every batch: under a
        strategy whose batch axis is the whole world (``DataParallel``,
        ``ZeroDataParallel``, ``FSDP``) each rank runs the forward on its
        rows and the logits are all-gathered over the batch group in
        shard order, so every rank again returns the whole result; under
        a strategy with other axes too the rows are those of the rank's
        row line (the ranks of a model, pipe, expert or seq line hold the
        same ones, at full T) and the gather runs over the row group. Up
        to 16 batches of logits stay on the device before they are
        fetched."""
        self._require_built()
        if hasattr(x, "__next__"):
            if steps is None:
                steps = getattr(x, "steps_per_pass", None)
                if steps is None:
                    raise ValueError(
                        "steps is required when predicting from a plain "
                        "iterator (sources with steps_per_pass, e.g. "
                        "data.Pipeline, default to one pass)")
            per_host = _per_host_source(x, self.strategy)
            source = x

            def host_batches():
                for step_i in range(int(steps)):
                    try:
                        batch = next(source)
                    except StopIteration:
                        raise ValueError(
                            f"prediction iterator exhausted after {step_i} "
                            f"of {int(steps)} batches — pass a smaller "
                            "steps or a repeating source (data.Pipeline)"
                        ) from None
                    yield np.asarray(batch[0] if isinstance(batch, tuple)
                                     else batch)
        else:  # steps goes with an iterator; arrays ignore it, as in JAX
            per_host = False
            arr = _host_array(x)
            self.strategy.local_batch_size(batch_size)

            def host_batches():
                for start in range(0, arr.shape[0], batch_size):
                    yield arr[start:start + batch_size]

        fetched, pending = [], []
        with self._eval_forward() as forward:
            for xb in host_batches():
                out = forward(xb).to(torch.float32)
                if per_host:  # every rank's rows, in shard order
                    out = self.strategy.all_gather_rows(out).flatten(0, 1)
                pending.append(out)
                if len(pending) >= 16:
                    fetched.append(pending.pop(0).cpu().numpy())
            fetched += [o.cpu().numpy() for o in pending]
        return np.concatenate(fetched, axis=0)

    # --------------------------------------------------------------- generate
    @staticmethod
    def _sample_logits(logits, key, temperature, top_k):
        """The JAX ``Model._sample_logits``: f32 logits, everything below
        the k-th largest masked to -inf, then the argmax (``temperature``
        0) or ``categorical(key, logits / temperature)``."""
        logits = logits.to(torch.float32)
        if top_k is not None:
            k = min(int(top_k), logits.shape[-1])
            kth = torch.topk(logits, k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, float("-inf"), logits)
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        # A tensor divisor: a Python scalar divides by its reciprocal's
        # product on CUDA, and the draw must see JAX's quotient.
        t = torch.full((), float(temperature), dtype=torch.float32,
                       device=logits.device)
        return threefry.categorical(key, logits / t)

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """Autoregressive sampling from a token LM with a dense KV cache,
        as the JAX ``Model.generate``: ``prompt`` (B, T_p) int tokens in,
        (B, T_p + max_new_tokens) int32 numpy out. ``temperature=0`` is
        greedy argmax; ``top_k`` keeps the k most likely tokens; ``seed``
        keys the draw (``jax.random.PRNGKey(seed)``, split once a step:
        sampled tokens are JAX's own). The cache holds a bucket of
        positions (a multiple of 64, or the exact length where the
        positional table is shorter); the prompt is teacher-forced
        through the same cached step the sampled tokens take. The loop is
        plain Python over the layers' ``decode``, on the model's device;
        the tokens are fetched once at the end."""
        self._require_built()
        prompt = np.asarray(prompt)
        if prompt.ndim != 2:
            raise ValueError(
                f"prompt must be (batch, tokens); got {prompt.shape}")
        b, t_p = prompt.shape
        if t_p < 1:
            raise ValueError(
                "prompt must contain at least one token (the decode loop is "
                f"seeded from prompt[:, 0]); got shape {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1; got {top_k}")
        max_len = t_p + max_new_tokens
        bucket = max(64, -(-max_len // 64) * 64)
        dtype = self.decode_dtype()
        try:
            cache = self.module.init_cache(b, bucket, dtype, self.device)
        except ValueError:
            # The bucket exceeds the model's capacity (a positional table
            # shorter than it): the exact requested length instead.
            bucket = max_len
            cache = self.module.init_cache(b, bucket, dtype, self.device)
        tokens = torch.from_numpy(prompt.astype(np.int64)).to(self.device)
        key = threefry.PRNGKey(seed)
        tok = tokens[:, 0]
        out = []
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode(), self._policy_scope():
                for t in range(max_len - 1):
                    logits, cache = self.module.decode(cache, tok[:, None],
                                                       pos=t)
                    key, sub = threefry.split(key)
                    if t + 1 < t_p:  # teacher-forced: the prompt's token
                        tok = tokens[:, t + 1]
                    else:
                        tok = self._sample_logits(logits[:, 0], sub,
                                                  temperature, top_k)
                    out.append(tok)
        finally:
            self.module.train(was_training)
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return np.concatenate([prompt[:, :1].astype(np.int32), toks], axis=1)

    # ---------------------------------------------------------------- weights
    def save_weights(self, path):
        """Write the parameters and the state (BatchNorm's running
        statistics) as ``{"params", "state"}`` to an HDF5 file, or npz when
        ``path`` ends in ``.npz``: the JAX package's ``save_weights``
        files. Chief-only; ``checkpoint.Checkpointer`` keeps training
        checkpoints."""
        self._require_built()
        tree = {"params": self.params, "state": self.state}
        if self._sharded() and not ckpt._is_chief():
            return None  # the gather above is every rank's; rank 0 writes
        path = str(path)
        if path.endswith(".npz"):
            return ckpt.save_npz(path, tree)
        return ckpt.export_hdf5(path, tree)

    def _sharded(self) -> bool:
        """True when this rank holds blocks of any leaf (parameters or
        optimizer state)."""
        return any(lay is not None for lay in self._opt_layout_list()) or any(
            layout_of(t) is not None for t in self._param_list())

    def load_weights(self, path):
        """Load a ``save_weights`` file of either package (HDF5, or npz by
        its suffix), or a bare parameter tree (``export_hdf5(path,
        params)``; the state is left as it is then). Paths and shapes are
        checked before anything is copied. A compiled model's optimizer
        state starts afresh, as in the JAX package."""
        if not self.built:
            raise RuntimeError(
                "Build the model first (model.build(input_shape)) so the "
                "loaded weights have parameters to go into")
        path = str(path)
        if path.endswith(".npz"):
            tree, _ = ckpt.load_npz(path)
        else:
            tree, _ = ckpt.import_hdf5(path)
        if "params" in tree and set(tree) <= {"params", "state"}:
            # A stateless model's empty state leaves no entry in the file.
            params, state = tree["params"], tree.get("state")
        else:
            params, state = tree, None
        params = ckpt.flatten_tree(params)
        self._check_tree(self._param_shapes(), params, "parameter")
        if state is not None:
            state = ckpt.flatten_tree(state)
            self._check_tree(self.state, state, "state")
        self.load_params(params)
        if state is not None:
            self.load_state(state)
        if self.compiled:
            self._init_opt_state()
        return self

    # ---------------------------------------------------------------- summary
    def summary(self):
        """Keras-style table of the layers (name, output shape, parameter
        count) and the total, with the JAX ``Model.summary``'s text:
        printed on rank 0, and returned."""
        if self.input_shape is None:
            raise ValueError("Build the model (or fit once) before summary()")
        rows = self.module.summary_lines(self.input_shape)
        width = max(len(r[0]) for r in rows) + 2
        lines = [f"Model: {self.name}", "-" * (width + 30)]
        total = 0
        for name, shape, count in rows:
            lines.append(f"{name:<{width}}{str(shape):<22}{count}")
            total += count
        lines.append("-" * (width + 30))
        lines.append(f"Total params: {total}")
        text = "\n".join(lines)
        if dlog.rank_world()[0] == 0:
            print(text)
        return text


__all__ = ["Model"]
