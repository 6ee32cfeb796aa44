"""Distribution strategies: ``SingleDevice``, ``DataParallel``, ZeRO-1, FSDP, TP and SP.

The counterpart of the JAX package's ``parallel/strategy.py``, with its
contract: a ``Model`` built inside ``strategy.scope()`` is distributed
(scope-wraps-construction), ``DataParallel()`` with no arguments takes the
topology from the environment, and ``MultiWorkerMirroredStrategy`` is its
alias.

The mechanism is PyTorch's, not GSPMD's: one process per card, joined by a
``torch.distributed`` process group (``cluster.initialize`` forms it from
``DTPU_CONFIG``/``TF_CONFIG``; NCCL on the card, gloo on the CPU). Every
rank builds the same parameters from the same seed, takes the same global
batch indices and keeps its own rows of them (the JAX package's row
sharding), and averages the gradients with one all-reduce per dtype
before the optimizer, so the replicas stay bit-identical.
BatchNorm is sync-BN, as GSPMD makes it in the JAX package: a layer that
needs statistics over the global batch finds the strategy its train step
runs under (``current_strategy()``; ``Model.fit`` enters the model's
``scope()`` for each step) and calls ``all_reduce_sum``/``broadcast``,
which are collectives under ``DataParallel`` and do nothing under
``SingleDevice``.
``torch.nn.parallel.DistributedDataParallel`` is not used: its reducer
hooks ``.grad`` accumulation, which the port's ``torch.autograd.grad``
step never does. ``DataParallel()`` outside a process group forms a
world-1 group on its device, so the all-reduce is one code path whatever
the number of ranks.

The sharded strategies keep the JAX package's placement rule
(``_largest_divisible_spec``: a leaf is split on its largest dimension
that the number of ranks divides, the first such on a tie; scalars and
awkward shapes stay whole) and give each rank block r, the index range
``[r*b, (r+1)*b)`` of that dimension (``collectives.Layout``):

- ``ZeroDataParallel`` (ZeRO-1): parameters replicated, every optimizer
  statistic with ndim >= 1 sharded. The gradients are all-reduced as
  under ``DataParallel``; each rank updates its block of every sharded
  leaf (K11 runs over the blocks) and the updated blocks are all-gathered
  into the replicated parameters, one bucket per dtype.
- ``FullyShardedDataParallel`` (ZeRO-3 over ``"fsdp"``) and ``FSDP``
  (over ``"data"``): parameters and their statistics sharded. A layer
  gathers a leaf where it reads it, after the compute cast
  (``nn.core.Layer._compute_leaf``: ``constrain_compute_params``), so a
  bf16 policy moves bf16; the gather's backward reduce-scatters the
  gradient to the blocks, which are then divided by N as ``DataParallel``
  divides, and replicated leaves go through ``DataParallel``'s
  all-reduce. ``overlap_spec`` hands ``nn.ScannedBlocks`` the gather's
  asynchronous form, so slice i+1's gather is issued before slice i's
  compute.

The optimizer's quantities that span a leaf or the tree (the clip's
global norm, Lamb's trust ratio, the loss scale's finite check) are summed
over the ranks' blocks, a replicated leaf counted once
(``optim.leaf_reduction``).

``DataTensorParallel`` and ``DataSeqParallel`` run over a mesh with two
axes (``parallel.mesh``; data x model, data x seq): the layers'
``sharding_hints`` roles lay a leaf out on the model axis (Megatron's
column and row blocks, which the layers compute with, not gather), and
the batch's second dimension splits over the seq axis, with ring or
Ulysses attention across it. ``DataPipelineParallel``,
``DataExpertParallel`` and ``CompositeParallel`` keep the JAX names and
raise "not yet ported".
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import collectives
from .collectives import Layout

_local = threading.local()


def current_strategy() -> Optional["Strategy"]:
    return getattr(_local, "strategy", None)


def _largest_divisible_spec(shape, n: int) -> Optional[int]:
    """The JAX package's ZeRO placement rule: the largest dimension of
    ``shape`` that ``n`` divides (the first such on a tie), or None for a
    scalar or a shape with no such dimension (kept whole)."""
    best, best_size = None, 0
    for d, size in enumerate(shape):
        if size % n == 0 and size > best_size:
            best, best_size = d, size
    return best


def _leaf_comm_bytes(leaf, compute_dtype=None) -> int:
    """Bytes one leaf moves in a collective at ``compute_dtype`` (floating
    leaves only; an int8 payload keeps its byte), as the JAX
    ``_leaf_comm_bytes``."""
    dtype = leaf.dtype
    if compute_dtype is not None and dtype.is_floating_point:
        dtype = compute_dtype
    return int(leaf.numel()) * dtype.itemsize


def _comm_row(gathered=0, grad=0, act_per_token=0) -> dict:
    """The JAX package's ``comm_bytes_estimate`` schema: the parameter
    gather, the gradient reduce, the per-token activation reduce (tensor
    parallelism), and the pipeline traffic that no port strategy has
    yet."""
    return {
        "gathered_param_bytes_per_device": int(gathered),
        "grad_reduce_bytes_per_device": int(grad),
        "activation_reduce_bytes_per_token_per_device": int(act_per_token),
        "pipeline_hop_bytes_per_token_per_device": 0,
    }


class Strategy:
    """Base strategy: one replica on ``self.device``, nothing to reduce."""

    device: torch.device

    @property
    def num_replicas_in_sync(self) -> int:
        return 1

    @contextlib.contextmanager
    def scope(self):
        prev = current_strategy()
        _local.strategy = self
        try:
            yield self
        finally:
            _local.strategy = prev

    def local_batch_size(self, global_batch: int) -> int:
        return global_batch

    def row_range(self, global_batch: int):
        """(start, stop): this replica's rows of a global batch, rows
        ``[r*b/P, (r+1)*b/P)`` for rank r of P, the JAX package's row
        sharding."""
        lb = self.local_batch_size(global_batch)
        start = self._rank() * lb
        return start, start + lb

    def _rank(self) -> int:
        return 0

    def reduce_gradients(self, grads: Sequence[torch.Tensor]):
        """The gradients averaged over the replicas (as they are here)."""
        return grads

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the replicas, in place (as it is here)."""
        return t

    @property
    def num_batch_shards(self) -> int:
        """How many ranks hold distinct pieces of a global batch (rows, or
        rows x sequence blocks): the count ``all_reduce_sum`` sums over,
        by which ``fit`` divides the ranks' summed mean losses."""
        return self.num_replicas_in_sync

    def seq_offset(self, t_local: int) -> int:
        """The global position of this rank's first token when the
        sequence is split across ranks (``DataSeqParallel``), else 0."""
        return 0

    def shard_seq(self, a, dim: int = 1):
        """This rank's block of ``a`` (host array or tensor) on its
        sequence dimension ``dim`` where the strategy splits sequences;
        ``a`` as it is otherwise."""
        return a

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        """The JAX strategies' per-step, per-device collective estimate
        (``last_fit_telemetry["comm_bytes_estimate"]``), with the same
        keys, from the full leaves' shapes and dtypes (``params``: any
        tensors of those, ``meta`` ones included), floating leaves priced
        at ``compute_dtype`` where a policy gives one; ``hints`` the
        module's ``sharding_hints()`` (read by tensor parallelism): one
        replica moves nothing."""
        return _comm_row()

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` replaced in place by replica ``src``'s (as it is here)."""
        return t

    def forward_collectives(self, batch_norm: bool) -> Optional[str]:
        """Why a CUDA graph of a training step (``steps_per_execution >
        1`` on the card) cannot be taken under this strategy: the
        collectives its forward issues, and the ROADMAP item that would
        let a graph capture them; None where the forward issues none (the
        gradients' reduce runs in the update, outside the graph).
        ``batch_norm``: a BatchNorm runs in the model."""
        return None

    # -- placement (the sharded strategies override) ------------------------
    def param_layout(self, shape, role: Optional[str] = None
                     ) -> Optional[Layout]:
        """This rank's block of a parameter of full ``shape`` whose layer
        gives it the tensor-parallel ``role`` (``sharding_hints``: "col",
        "row", "row1" or None), or None: the parameter is stored whole."""
        return None

    def opt_layout(self, shape, param_layout: Optional[Layout] = None
                   ) -> Optional[Layout]:
        """This rank's block of an optimizer statistic of full ``shape``
        (one per parameter, of its shape, stored as ``param_layout``), or
        None: stored whole."""
        return None

    def computes_block(self, layout: Layout) -> bool:
        """True when a layer computes with its block of a leaf stored as
        ``layout`` (Megatron tensor parallelism) instead of gathering the
        whole leaf."""
        return False

    def init_opt_state(self, tx, params):
        """``tx``'s state, built on the tensors the update reads
        (``params``: each parameter's block where its statistics are
        sharded)."""
        return tx.init(params)

    def constrain_compute_params(self, w, layout: Optional[Layout]):
        """A leaf as a layer computes with it, from its stored (and
        compute-cast) form: gathered when it is stored sharded. The JAX
        hook pins the compute-dtype copy to the masters' sharding so that
        the gathers move compute-dtype bytes; here the gather itself runs
        after the cast."""
        return collectives.gather_leaf(w, layout)

    def overlap_spec(self):
        """The scanned stack's one-layer-ahead gather
        (``nn.ScannedBlocks(overlap=)``): a callable ``(leaf, layout) ->
        collectives.Pending``, or None where the parameters are resident
        (no gather to overlap)."""
        return None

    def opt_state_sharding(self, opt_state: Dict[str, torch.Tensor]):
        """``{path: layout or None}`` for a flat optimizer-state tree of
        full leaves (``{path: tensor or array}``, optax's paths): where
        each leaf's block lives under this strategy (a scalar stays
        whole), as the JAX ``opt_state_sharding``."""
        return {p: (self.opt_layout(tuple(a.shape))
                    if len(getattr(a, "shape", ())) >= 1 else None)
                for p, a in opt_state.items()}

    def apply_update(self, tx, params, grads, opt_state,
                     opt_layouts: Sequence[Optional[Layout]]) -> None:
        """One optimizer step on the live parameters: the gradients
        averaged over the replicas, then ``tx``'s in-place update."""
        tx.update(params, self.reduce_gradients(grads), opt_state)


class SingleDevice(Strategy):
    """No distribution: the model on one device (``None``: the card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)


def _cuda_for_rank(device: torch.device) -> torch.device:
    """A CUDA device with an index: the current device, which
    ``cluster.initialize`` sets to this rank's card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class DataParallel(Strategy):
    """Synchronous all-reduce data parallelism over the default process
    group: parameters replicated, the global batch split across the
    ranks, the gradients averaged every step.

    ``device=None`` is this rank's card (it raises without one); pass
    ``device="cpu"`` for a gloo group on the CPU. Without a process group
    it forms one of world size 1 on ``device`` (NCCL on the card, gloo on
    the CPU)."""

    axis = "data"

    def __init__(self, device=None):
        self.device = _cuda_for_rank(resolve_device(device))
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if not dist.is_initialized():
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        elif dist.get_backend() != backend:
            raise ValueError(
                f"DataParallel on {self.device} needs a {backend} process "
                f"group; the default group is {dist.get_backend()}")

    @property
    def num_replicas_in_sync(self) -> int:
        return dist.get_world_size()

    def _rank(self) -> int:
        return dist.get_rank()

    def local_batch_size(self, global_batch: int) -> int:
        n = self.num_replicas_in_sync
        if global_batch % n:
            raise ValueError(
                f"Global batch {global_batch} not divisible by {n} replicas"
            )
        return global_batch // n

    def reduce_gradients(self, grads: Sequence[torch.Tensor]):
        """Sum over the ranks, divided by their number: one flat bucket per
        dtype, one all-reduce each; the gradients come back as views of
        the buckets."""
        return self._bucket_mean(grads, [True] * len(grads))

    def _bucket_mean(self, grads, summed: Sequence[bool]):
        """The one division path of every data-parallel strategy: the
        gradients, one flat bucket per (dtype, kind), all-reduced where
        ``summed[i]`` is False (a sharded gradient arrives summed by the
        gather's reduce-scatter) and divided by the number of ranks."""
        n = self.num_batch_shards
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        groups: Dict[tuple, List[int]] = {}
        for i, g in enumerate(grads):
            groups.setdefault((g.dtype, bool(summed[i])), []).append(i)
        for (_, reduce), idxs in groups.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idxs])
            if reduce:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                group=self._batch_group)
            flat.div_(n)
            pieces = flat.split([grads[i].numel() for i in idxs])
            for i, piece in zip(idxs, pieces):
                out[i] = piece.view(grads[i].shape)
        return out

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        # One gradient all-reduce of the whole parameter tree a step, at
        # the compute dtype under a policy (the cotangents it moves).
        return _comm_row(grad=sum(_leaf_comm_bytes(p, compute_dtype)
                                  for p in params.values()))

    @property
    def mesh(self):
        """The strategy's 1-D ``DeviceMesh`` over the default group, its
        axis named ``self.axis`` (``parallel.mesh.make_mesh``), made on
        first use."""
        if getattr(self, "_mesh", None) is None:
            from .mesh import make_mesh

            self._mesh = make_mesh(
                {self.axis: self.num_replicas_in_sync},
                device_type=self.device.type)
        return self._mesh

    #: The group whose ranks hold distinct pieces of a batch (None: the
    #: default group): the gradients' and the losses' all-reduce.
    _batch_group = None

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._batch_group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src)
        return t

    def forward_collectives(self, batch_norm: bool) -> Optional[str]:
        if not batch_norm:
            return None
        return ("steps_per_execution > 1 under DataParallel with BatchNorm "
                "on the card: not yet ported (ROADMAP 1.6). Sync-BN's "
                "collectives run inside the forward, which the step's CUDA "
                "graph would capture; the port captures no NCCL call")


# The reference's name for the same strategy.
MultiWorkerMirroredStrategy = DataParallel


class _Sharded(DataParallel):
    """The placement rule over this group's ranks, shared by ZeRO-1 and
    FSDP."""

    def _layout(self, shape) -> Optional[Layout]:
        shape = tuple(int(s) for s in shape)
        n = self.num_replicas_in_sync
        d = _largest_divisible_spec(shape, n)
        return None if d is None else Layout(shape, d, n, self._rank())

    def opt_layout(self, shape, param_layout=None) -> Optional[Layout]:
        return self._layout(shape)

    def _leaf_reducer(self, layouts: Sequence[Optional[Layout]]):
        replicated = [lay is None for lay in layouts]
        return lambda values: collectives.leaf_sums(values, replicated)


class ZeroDataParallel(_Sharded):
    """ZeRO-1 data parallelism: parameters replicated, optimizer state
    sharded over the ranks (Rajbhandari et al., 2020, stage 1), as the
    JAX ``ZeroDataParallel``.

    The forward and backward are ``DataParallel``'s (the same rows, the
    same all-reduced gradient); only the update is partitioned: each rank
    keeps its block of every statistic with ndim >= 1 (a leaf of an
    awkward shape whole), updates its block of each parameter, and the
    updated blocks are all-gathered into the replicated parameters. With
    Adam the model state per card drops from 3x the parameters to (1 +
    2/N)x."""

    def apply_update(self, tx, params, grads, opt_state, opt_layouts):
        from .. import optim

        grads = self.reduce_gradients(grads)
        blocks, gblocks = [], []
        for p, g, lay in zip(params, grads, opt_layouts):
            if lay is None:
                blocks.append(p)
                gblocks.append(g)
            else:
                blocks.append(p.detach()[lay.index()].contiguous())
                gblocks.append(g[lay.index()].contiguous())
        with optim.leaf_reduction(self._leaf_reducer(opt_layouts)):
            tx.update(blocks, gblocks, opt_state)
        idx = [i for i, lay in enumerate(opt_layouts) if lay is not None]
        if idx:
            collectives.all_gather_blocks(
                [params[i].detach() for i in idx], [blocks[i] for i in idx],
                [opt_layouts[i] for i in idx])

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        # DP's gradient all-reduce plus the all-gather of the updated
        # blocks, which are f32 masters whatever the policy.
        out = super().comm_bytes_estimate(params, compute_dtype)
        out["gathered_param_bytes_per_device"] = sum(
            _leaf_comm_bytes(p) for p in params.values()
            if p.dim() >= 1 and self._layout(p.shape) is not None)
        return out


class FullyShardedDataParallel(_Sharded):
    """ZeRO-3 fully sharded data parallelism over the ``"fsdp"`` axis, as
    the JAX ``FullyShardedDataParallel``: every parameter and its
    optimizer statistics sharded on the leaf's largest divisible
    dimension, the batch split over the same ranks. A layer gathers each
    leaf where it reads it (after the compute cast) and the gather's
    backward reduce-scatters the gradient to the blocks; the update runs
    on the blocks. Per-card parameter memory is O(total / N)."""

    def __init__(self, device=None, *, axis: str = "fsdp"):
        super().__init__(device)
        self.axis = axis

    def param_layout(self, shape, role=None) -> Optional[Layout]:
        return self._layout(shape)

    def overlap_spec(self):
        return collectives.start_gather

    def forward_collectives(self, batch_norm: bool) -> Optional[str]:
        return ("steps_per_execution > 1 under FSDP on the card: not yet "
                "ported (ROADMAP 1.3a). The forward gathers every sharded "
                "parameter, which the step's CUDA graph would capture; the "
                "port captures no NCCL call")

    def apply_update(self, tx, params, grads, opt_state, opt_layouts):
        from .. import optim

        # Sharded gradients arrive summed by the reduce-scatter; they are
        # divided by N in the same bucket code that divides the
        # all-reduced replicated ones (DataParallel's division).
        grads = self._bucket_mean(grads, [lay is None for lay in opt_layouts])
        with optim.leaf_reduction(self._leaf_reducer(opt_layouts)):
            tx.update(params, grads, opt_state)

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        # ZeRO-3: one gather of every sharded parameter (counted once; the
        # backward's re-gather under remat repeats it) and the gradients'
        # reduce-scatter, both at the compute dtype under a policy.
        gathered = sum(_leaf_comm_bytes(p, compute_dtype)
                       for p in params.values()
                       if p.dim() >= 1 and self._layout(p.shape) is not None)
        grad = sum(_leaf_comm_bytes(p, compute_dtype)
                   for p in params.values())
        return _comm_row(gathered=gathered, grad=grad)


class FSDP(FullyShardedDataParallel):
    """ZeRO-3 over the ``"data"`` axis, as the JAX ``FSDP``: the same
    mechanics as ``FullyShardedDataParallel``, the shard axis named as
    the batch axis (one device group gives both the data parallelism and
    the parameter sharding).

    - ``DataParallel``:       params 1x,   opt 1x per card
    - ``ZeroDataParallel``:   params 1x,   opt 1/N per card (ZeRO-1)
    - ``FSDP``:               params 1/N,  opt 1/N per card (ZeRO-3)
    """

    def __init__(self, device=None, *, axis: str = "data"):
        super().__init__(device, axis=axis)


# ----------------------------------------------- tensor and sequence parallel
def role_of(path: str, hints) -> Optional[str]:
    """The ``sharding_hints`` role of the leaf at ``path`` ("a/b/kernel"):
    the string met walking the nested hint tree along the path (a string
    at a container applies to its whole subtree), else None."""
    node = hints
    for part in path.split("/"):
        if isinstance(node, str):
            return node
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return node if isinstance(node, str) else None


def _role_dim(role: Optional[str], ndim: int) -> Optional[int]:
    """The JAX ``DataTensorParallel._role_spec`` as a dimension: "col"
    the last, "row" the first, "row1" the second (behind a stacked
    axis, from 2 dimensions on); any other role none."""
    if role == "col" and ndim >= 1:
        return ndim - 1
    if role == "row" and ndim >= 1:
        return 0
    if role == "row1" and ndim >= 2:
        return 1
    return None


class _HintedParallel(DataParallel):
    """A data-parallel strategy over an n-D mesh (``parallel.mesh``)
    whose leaves may be laid out by the layers' ``sharding_hints``
    roles, as the JAX ``_HintedParallel``: ``param_layout`` turns a role
    into a ``Layout`` on one of the mesh's axes, the optimizer's
    statistics are laid out like their parameters, and the batch's rows
    split over the ``axis`` line (``row_range``). ``devices`` (ranks),
    ``mesh`` and the axis sizes are the JAX constructors'; ``device``
    the port's (None: this rank's card, "cpu": a gloo group)."""

    def __init__(self, devices, mesh, axis, split_axis, split, keyword,
                 device):
        super().__init__(device)
        if mesh is None:
            from .mesh import make_mesh

            ndev = (dist.get_world_size() if devices is None
                    else len(devices))
            if ndev % split:
                raise ValueError(
                    f"{ndev} devices not divisible by {keyword}={split}")
            mesh = make_mesh({axis: ndev // split, split_axis: split},
                             device_type=self.device.type, devices=devices)
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"Mesh {names} has no axis {axis!r}")
        if mesh.size() != dist.get_world_size():
            raise ValueError(
                f"a {type(self).__name__} mesh spans every rank of the "
                f"process group: {mesh.size()} of {dist.get_world_size()}")
        self._mesh = mesh
        self.axis = axis
        self.axis_sizes = {a: int(mesh.size(i)) for i, a in enumerate(names)}
        self._batch_group = mesh.get_group(axis)
        if self.device.type == "cuda":
            # Form each line's NCCL communicator now: point-to-point calls
            # (the ring's) on a group whose communicator does not exist
            # yet would each form their own.
            for a in names:
                if self.axis_sizes[a] > 1:
                    t = torch.zeros(1, device=self.device)
                    dist.all_reduce(t, group=mesh.get_group(a))

    @property
    def num_replicas_in_sync(self) -> int:
        # Only the batch axis counts, as in JAX: the other axes split the
        # model or the sequence, not the rows.
        return self.axis_sizes[self.axis]

    def _rank(self) -> int:
        return int(self.mesh.get_local_rank(self.axis))

    def _axis_line(self, axis: str):
        """``(size, this rank's coordinate, process group)`` of ``axis``."""
        return (self.axis_sizes[axis], int(self.mesh.get_local_rank(axis)),
                self.mesh.get_group(axis))

    def opt_layout(self, shape, param_layout=None) -> Optional[Layout]:
        return param_layout

    def forward_collectives(self, batch_norm: bool) -> Optional[str]:
        return (f"steps_per_execution > 1 under {type(self).__name__} on the"
                " card: not yet ported (ROADMAP 1.3a). The forward's tensor- "
                "and sequence-parallel collectives would be captured by the "
                "step's CUDA graph; the port captures no NCCL call")

    def opt_state_sharding(self, opt_state):
        raise NotImplementedError(
            "opt_state_sharding under a hinted strategy: a statistic's "
            "layout is its parameter's (Model.opt_layouts)")


class DataTensorParallel(_HintedParallel):
    """Data x tensor parallelism, as the JAX ``DataTensorParallel``: the
    batch's rows split over ``axis`` ("data"), the weight matrices of
    hinted layers (``Dense(shard=)``, ``MultiHeadAttention``) split
    Megatron-style over ``model_axis`` ("model", ``model_parallel``
    ranks): "col" on a leaf's last dimension, "row" on its first, "row1"
    on its second (a stacked leaf's, ``ScannedBlocks``). Every other leaf
    is replicated.

    Where JAX lets GSPMD insert the collectives, the layers call them
    (``parallel.collectives``): a column-parallel product takes its input
    through ``copy_to_group`` (the backward all-reduces its gradient over
    the model line) and gives this rank's feature block, a row-parallel
    product all-reduces its partial sums forward (``reduce_from_group``)
    before its bias. Attention projects this rank's heads (``wq``'s
    column block r holds heads ``[r*H/tp, (r+1)*H/tp)``), runs on them,
    and ``wo``'s row product is all-reduced. No weight is gathered.

    Gradients of the blocks are whole for the block; every gradient is
    all-reduced over the data line only and divided by its size. The
    norms that span leaves (``grad_clip``, Lamb, the loss scale's check)
    sum a split leaf's partials over the model line and count a
    replicated leaf once (``optim.leaf_reduction``). With
    ``model_parallel=1`` every block is the whole leaf and each
    collective of the model line runs over one rank: ``DataParallel``'s
    arithmetic through the tensor-parallel code.
    """

    def __init__(self, devices=None, *, mesh=None, model_parallel: int = 2,
                 axis: str = "data", model_axis: str = "model",
                 device=None):
        super().__init__(devices, mesh, axis, model_axis,
                         int(model_parallel), "model_parallel", device)
        if model_axis not in self.axis_sizes:
            raise ValueError(
                f"Mesh {tuple(self.axis_sizes)} has no axis {model_axis!r}")
        self.model_axis = model_axis
        self.tp, self.tp_rank, self.tp_group = self._axis_line(model_axis)

    def param_layout(self, shape, role=None) -> Optional[Layout]:
        shape = tuple(int(s) for s in shape)
        d = _role_dim(role, len(shape))
        if d is None:
            return None
        if shape[d] % self.tp:
            raise ValueError(
                f"{role!r} leaf of shape {shape}: dimension {d} ({shape[d]}) "
                f"not divisible by {self.model_axis}={self.tp}")
        return Layout(shape, d, self.tp, self.tp_rank, self.tp_group,
                      self.model_axis)

    def computes_block(self, layout: Layout) -> bool:
        return layout.axis == self.model_axis

    def constrain_compute_params(self, w, layout: Optional[Layout]):
        if layout is not None and self.computes_block(layout):
            return w
        return collectives.gather_leaf(w, layout)

    def apply_update(self, tx, params, grads, opt_state, opt_layouts):
        from .. import optim

        grads = self.reduce_gradients(grads)
        replicated = [lay is None for lay in opt_layouts]
        group = self.tp_group
        with optim.leaf_reduction(
                lambda values: collectives.leaf_sums(values, replicated,
                                                     group)):
            tx.update(params, grads, opt_state)

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        """Megatron traffic, as the JAX estimate: the gradient all-reduce
        over the data line moves what a rank holds (a 1/tp block of a
        split leaf; without ``hints``, DP's whole tree), and each
        row-parallel product adds a forward and a backward all-reduce of
        its (tokens, width) output, priced per token; no weight is
        gathered."""
        tp, data = self.tp, self.axis_sizes[self.axis]
        grad = act = 0
        for path, p in params.items():
            role = role_of(path, hints or {})
            nbytes = _leaf_comm_bytes(p, compute_dtype)
            split = tp > 1 and _role_dim(role, p.dim()) is not None
            if data > 1:
                grad += nbytes // tp if split else nbytes
            if role in ("row", "row1") and tp > 1:
                dt = compute_dtype if compute_dtype is not None else p.dtype
                stack = int(p.shape[0]) if role == "row1" else 1
                act += 2 * stack * int(p.shape[-1]) * dt.itemsize
        return _comm_row(grad=grad, act_per_token=act)


class DataSeqParallel(_HintedParallel):
    """Data x sequence (context) parallelism, as the JAX
    ``DataSeqParallel``: a batch's rows split over ``axis`` ("data") and
    its second dimension over ``seq_axis`` ("seq", ``seq_parallel``
    ranks), so each rank holds ``T/s`` positions of its rows and the
    activations a rank keeps are O(T/s). Parameters are replicated.
    ``MultiHeadAttention`` finds the seq axis and runs ``attention``:
    "ring" (``ops.ring_attention``: K/V blocks rotate round the seq line,
    the zigzag schedule for causal attention) or "ulysses" (two
    all-to-alls trade the sequence blocks for head blocks, so each rank
    runs flash attention over the whole sequence for ``H/s`` heads;
    ``num_heads`` must divide by ``s``). ``PositionalEmbedding`` adds the
    rows of this rank's positions.

    Each rank's loss is the mean over its own tokens; the gradients and
    the losses are summed over every rank of the mesh and divided by
    their number (each holds as many tokens), which is the global mean's.
    """

    def __init__(self, devices=None, *, mesh=None, seq_parallel: int = 2,
                 axis: str = "data", seq_axis: str = "seq",
                 attention: str = "ring", device=None):
        if attention not in ("ring", "ulysses"):
            raise ValueError(
                f"attention must be 'ring' or 'ulysses', got {attention!r}")
        super().__init__(devices, mesh, axis, seq_axis, int(seq_parallel),
                         "seq_parallel", device)
        if seq_axis not in self.axis_sizes:
            raise ValueError(
                f"Mesh {tuple(self.axis_sizes)} has no axis {seq_axis!r}")
        self.seq_axis = seq_axis
        self.seq_attention = attention
        self.sp, self.sp_rank, self.sp_group = self._axis_line(seq_axis)
        # Every rank of the mesh holds a distinct piece of the batch.
        self._batch_group = None

    @property
    def num_batch_shards(self) -> int:
        return self.axis_sizes[self.axis] * self.sp

    def seq_offset(self, t_local: int) -> int:
        return self.sp_rank * int(t_local)

    def shard_seq(self, a, dim: int = 1):
        """This rank's ``T/s`` positions of ``a``'s dimension ``dim``
        (JAX's ``_put_batch_rows_seq``: a leaf with fewer dimensions is
        split by rows only), raising JAX's error where ``s`` does not
        divide its length."""
        if len(a.shape) <= dim:
            return a
        t = a.shape[dim]
        if t % self.sp:
            raise ValueError(
                f"sequence length {t} not divisible by "
                f"{self.seq_axis}={self.sp} shards")
        b = t // self.sp
        sl = [slice(None)] * len(a.shape)
        sl[dim] = slice(self.sp_rank * b, (self.sp_rank + 1) * b)
        return a[tuple(sl)]


def _unported_strategy(name: str, what: str):
    raise NotImplementedError(f"{name} ({what}): not yet ported (ROADMAP 1.7)")


class DataPipelineParallel(Strategy):
    """The JAX ``DataPipelineParallel``'s name and signature; building one
    raises "not yet ported" (ROADMAP 1.7, with ``nn/pipeline.py``)."""

    def __init__(self, devices=None, *, mesh=None, pipeline_parallel=2,
                 num_microbatches=None, axis="data", pipe_axis="pipe",
                 device=None):
        _unported_strategy("DataPipelineParallel", "nn/pipeline.py")


class DataExpertParallel(Strategy):
    """The JAX ``DataExpertParallel``'s name and signature; building one
    raises "not yet ported" (ROADMAP 1.7, with ``nn/moe.py``)."""

    def __init__(self, devices=None, *, mesh=None, expert_parallel=2,
                 axis="data", expert_axis="expert", device=None):
        _unported_strategy("DataExpertParallel", "nn/moe.py")


class CompositeParallel(Strategy):
    """The JAX ``CompositeParallel``'s name and signature; building one
    raises "not yet ported" (ROADMAP 1.7)."""

    def __init__(self, axes=None, devices=None, *, mesh=None,
                 num_microbatches=None, seq_attention="ring", device=None):
        _unported_strategy("CompositeParallel", "every axis on one mesh")


__all__ = [
    "CompositeParallel", "DataExpertParallel", "DataParallel",
    "DataPipelineParallel", "DataSeqParallel", "DataTensorParallel", "FSDP",
    "FullyShardedDataParallel", "MultiWorkerMirroredStrategy",
    "SingleDevice", "Strategy", "ZeroDataParallel", "current_strategy",
]
