"""Distribution strategies, from ``SingleDevice`` to ``CompositeParallel``.

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
Ulysses attention across it. ``DataExpertParallel`` splits the MoE's
expert stacks over an expert line, ``DataPipelineParallel`` a pipelined
stack's stages over a pipe line (``nn.pipeline``), and
``CompositeParallel`` resolves every role on one n-axis mesh.

A loss whose divisor depends on the data (``losses.
cross_entropy_with_ignore``, a ``(sum, count)`` loss, the MoE's
load-balance term) is taken against the global count, one all-reduce
over the batch group (``Model._rank_loss``), so every strategy trains the
JAX step's global objective.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import collectives
from .collectives import Layout

_local = threading.local()


class TokenLayout(NamedTuple):
    """A rank's block of the global batch's tokens (``Strategy.
    token_layout``): the global ``rows`` x ``seq`` tokens, this rank's
    first row and first position, and the number of ranks that hold
    distinct blocks (the batch group: rows x sequence blocks)."""

    rows: int
    seq: int
    row_start: int
    seq_offset: int
    shards: int


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


def _comm_row(gathered=0, grad=0, act_per_token=0, hop_per_token=0) -> dict:
    """The JAX package's ``comm_bytes_estimate`` schema: the parameter
    gather, the gradient reduce, the per-token activation reduce (tensor
    parallelism) and the per-token stage hops (pipeline parallelism)."""
    return {
        "gathered_param_bytes_per_device": int(gathered),
        "grad_reduce_bytes_per_device": int(grad),
        "activation_reduce_bytes_per_token_per_device": int(act_per_token),
        "pipeline_hop_bytes_per_token_per_device": int(hop_per_token),
    }


# The strategies' collective estimates as functions of the full leaves and
# the mesh's sizes, so that the auto-shard planner prices a candidate
# without building its strategy (which would form process groups).
def _dp_comm(params, compute_dtype=None) -> dict:
    # One gradient all-reduce of the whole parameter tree a step, at the
    # compute dtype under a policy (the cotangents it moves).
    return _comm_row(grad=sum(_leaf_comm_bytes(p, compute_dtype)
                              for p in params.values()))


def _sharded_leaf(p, n: int) -> bool:
    """True when the placement rule splits leaf ``p`` over ``n`` ranks."""
    return p.dim() >= 1 and _largest_divisible_spec(
        tuple(p.shape), n) is not None


def _zero1_comm(params, compute_dtype, n: int) -> dict:
    # DP's gradient all-reduce plus the all-gather of the updated blocks,
    # which are f32 masters whatever the policy.
    out = _dp_comm(params, compute_dtype)
    out["gathered_param_bytes_per_device"] = sum(
        _leaf_comm_bytes(p) for p in params.values() if _sharded_leaf(p, n))
    return out


def _fsdp_comm(params, compute_dtype, n: int) -> dict:
    # ZeRO-3: one gather of every sharded parameter (counted once; the
    # backward's re-gather under remat repeats it) and the gradients'
    # reduce-scatter, both at the compute dtype under a policy.
    gathered = sum(_leaf_comm_bytes(p, compute_dtype)
                   for p in params.values() if _sharded_leaf(p, n))
    grad = sum(_leaf_comm_bytes(p, compute_dtype) for p in params.values())
    return _comm_row(gathered=gathered, grad=grad)


def _tp_comm(params, compute_dtype, hints, tp: int, data: int) -> dict:
    """Megatron traffic, as the JAX estimate: the gradient all-reduce over
    the data line moves what a rank holds (a 1/tp block of a split leaf;
    without ``hints``, DP's whole tree), and each row-parallel product
    adds a forward and a backward all-reduce of its (tokens, width)
    output, priced per token; no weight is gathered."""
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

    def row_shard(self):
        """``(index, count)``: this rank's coordinate on the row line and
        the number of row shards, the slice of each global batch a
        per-host source gives it (``data.Pipeline(shard="auto")``)."""
        n = int(self.num_replicas_in_sync)
        return (int(self._rank()) if n > 1 else 0), n

    def token_layout(self, b: int, t: int) -> TokenLayout:
        """Where this rank's ``(b, t)`` block of tokens sits in the global
        batch that the JAX step sees (its token ``(i, j)`` is global token
        ``(row_start + i) * T + seq_offset + j``), for the layers whose
        statistics run over the global token order (``nn.MoE``'s routing
        groups). ``all_reduce_sum`` sums over the ``shards`` ranks that
        hold the distinct blocks."""
        rows = int(self.num_replicas_in_sync)
        shards = int(self.num_batch_shards)
        row_start = self.row_range(b * rows)[0] if rows > 1 else 0
        seq = shards // rows
        return TokenLayout(b * rows, t * seq, int(row_start),
                           int(self.seq_offset(t)) if seq > 1 else 0, shards)

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

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``(R, *t.shape)``: ``t`` of each of the R ranks that hold
        distinct rows of a batch, in row order (``t[None]`` here)."""
        return t[None]

    def writes_block(self, layout: Layout) -> bool:
        """True when this rank writes its block of a leaf stored as
        ``layout`` to a sharded checkpoint: every block of a line split
        once, a block held alike along the batch line by its first
        rank."""
        return layout.axis is None or self._rank() == 0

    def forward_collectives(self, batch_norm: bool,
                            moe: bool = False) -> Optional[str]:
        """Why a CUDA graph of a training step (``steps_per_execution >
        1`` on the card) cannot be taken under this strategy: the
        collectives its forward issues, and the ROADMAP item that would
        let a graph capture them; None where the forward issues none (the
        gradients' reduce runs in the update, outside the graph).
        ``batch_norm``: a BatchNorm runs in the model; ``moe``: an
        ``nn.MoE`` does."""
        return self.capture_blocker(
            batch_norm, moe, self.num_batch_shards if moe else 1)

    @classmethod
    def capture_blocker(cls, batch_norm: bool, moe: bool,
                        batch_shards: int) -> Optional[str]:
        """:meth:`forward_collectives` of an instance of this class whose
        batch splits ``batch_shards`` ways (read for an MoE only), without
        building one (the auto-shard planner's pruning rule on the
        card)."""
        if moe and batch_shards > 1:
            return ("steps_per_execution > 1 with an nn.MoE under data "
                    "parallelism on the card: not yet ported (ROADMAP "
                    "1.3a). The routing's statistics are reduced over the "
                    "ranks in the forward, which the step's CUDA graph "
                    "would capture; the port captures no NCCL call")
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
    the CPU). ``devices`` (ranks), ``mesh`` (a one-axis
    ``parallel.make_mesh`` mesh) and ``axis`` are the JAX constructor's:
    they must span every rank of the group in rank order (a subset, or
    a mesh of more axes, raises "not yet ported", ROADMAP 1.7b)."""

    axis = "data"
    _mesh = None

    def __init__(self, devices=None, *, mesh=None, axis: str = "data",
                 device=None):
        self._form_group(device)
        self.axis = axis
        world = dist.get_world_size()
        name = type(self).__name__
        if devices is not None and [int(d) for d in devices] != list(
                range(world)):
            raise NotImplementedError(
                f"{name}(devices={list(devices)}) on a group of {world} "
                "ranks: a strategy over a subset or a reordering of the "
                "ranks is not yet ported (ROADMAP 1.7b)")
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            if axis not in names:
                raise ValueError(f"Mesh {names} has no axis {axis!r}")
            if len(names) != 1 or mesh.mesh.flatten().tolist() != list(
                    range(world)):
                raise NotImplementedError(
                    f"{name}(mesh=) over the axes {names} of "
                    f"{mesh.size()} of {world} ranks: only a one-axis mesh "
                    "over every rank in rank order is ported; the others "
                    "are not yet ported (ROADMAP 1.7b)")
            self._mesh = mesh
            self._batch_group = mesh.get_group(axis)

    def _form_group(self, device) -> None:
        self.device = _cuda_for_rank(resolve_device(device))
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        if not dist.is_initialized():
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        elif dist.get_backend() != backend:
            raise ValueError(
                f"{type(self).__name__} on {self.device} needs a {backend} "
                f"process group; the default group is {dist.get_backend()}")

    @property
    def num_replicas_in_sync(self) -> int:
        return dist.get_world_size()

    def row_axes(self) -> tuple:
        """Mesh axes the batch's row (leading) dim shards over."""
        return (self.axis,)

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

    def _bucket_mean(self, grads, reduce: Sequence):
        """The one division path of every data-parallel strategy: the
        gradients, one flat bucket per (dtype, kind), each all-reduced as
        ``reduce[i]`` says (True: over the batch group; False: not, a
        sharded gradient arrives summed by the gather's reduce-scatter; a
        process group: over that group) and divided by the number of
        batch shards.

        A loss whose divisor depends on the data (a ratio loss, the MoE's
        load-balance term) is taken per rank as ``N x`` its share of the
        global objective (``Model._rank_loss``), so this division gives
        the sum of the shares' gradients: the global objective's."""
        n = self.num_batch_shards
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        groups: Dict[tuple, List[int]] = {}
        for i, g in enumerate(grads):
            groups.setdefault((g.dtype, reduce[i]), []).append(i)
        for (_, over), idxs in groups.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idxs])
            if over is not False:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                group=self._batch_group if over is True
                                else over)
            flat.div_(n)
            pieces = flat.split([grads[i].numel() for i in idxs])
            for i, piece in zip(idxs, pieces):
                out[i] = piece.view(grads[i].shape)
        return out

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        return _dp_comm(params, compute_dtype)

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
    #: default group): the gradients' and the losses' all-reduce. Every
    #: group a strategy keeps is held weakly (``collectives.WeakGroup``).
    _batch_group = collectives.WeakGroup()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._batch_group)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        group = self._rows_group()
        n = dist.get_world_size(group)
        out = t.new_empty((n * t.numel(),))
        collectives._all_gather(out, t.contiguous().reshape(-1), group=group)
        return out.view((n,) + tuple(t.shape))

    def _rows_group(self):
        """The group of the ranks that hold distinct rows (the batch
        group, less a sequence split)."""
        return self._batch_group

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src)
        return t

    @classmethod
    def capture_blocker(cls, batch_norm: bool, moe: bool,
                        batch_shards: int) -> Optional[str]:
        if not batch_norm:
            return super().capture_blocker(batch_norm, moe, batch_shards)
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
        return _zero1_comm(params, compute_dtype, self.num_replicas_in_sync)


class FullyShardedDataParallel(_Sharded):
    """ZeRO-3 fully sharded data parallelism over the ``"fsdp"`` axis, as
    the JAX ``FullyShardedDataParallel``: every parameter and its
    optimizer statistics sharded on the leaf's largest divisible
    dimension, the batch split over the same ranks. A layer gathers each
    leaf where it reads it (after the compute cast) and the gather's
    backward reduce-scatters the gradient to the blocks; the update runs
    on the blocks. Per-card parameter memory is O(total / N)."""

    def __init__(self, devices=None, *, mesh=None, axis: str = "fsdp",
                 device=None):
        super().__init__(devices, mesh=mesh, axis=axis, device=device)

    def param_layout(self, shape, role=None) -> Optional[Layout]:
        return self._layout(shape)

    def overlap_spec(self):
        return collectives.start_gather

    @classmethod
    def capture_blocker(cls, batch_norm: bool, moe: bool,
                        batch_shards: int) -> Optional[str]:
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
        return _fsdp_comm(params, compute_dtype, self.num_replicas_in_sync)


class FSDP(FullyShardedDataParallel):
    """ZeRO-3 over the ``"data"`` axis, as the JAX ``FSDP``: the same
    mechanics as ``FullyShardedDataParallel``, the shard axis named as
    the batch axis (one device group gives both the data parallelism and
    the parameter sharding).

    - ``DataParallel``:       params 1x,   opt 1x per card
    - ``ZeroDataParallel``:   params 1x,   opt 1/N per card (ZeRO-1)
    - ``FSDP``:               params 1/N,  opt 1/N per card (ZeRO-3)
    """

    def __init__(self, devices=None, *, mesh=None, axis: str = "data",
                 device=None):
        super().__init__(devices, mesh=mesh, axis=axis, device=device)


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

    tp_group = collectives.WeakGroup()
    sp_group = collectives.WeakGroup()
    ep_group = collectives.WeakGroup()
    pp_group = collectives.WeakGroup()

    def __init__(self, devices, mesh, axis, split_axis, split, keyword,
                 device):
        self._form_group(device)
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

    def constrain_compute_params(self, w, layout: Optional[Layout]):
        # Gather each split the layer does not compute with (the fsdp
        # split of a two-axis leaf), up to the one it does.
        if layout is None:
            return w
        for level in layout.levels():
            if self.computes_block(level):
                break
            w = collectives.gather(w, level)
        return w

    def apply_update(self, tx, params, grads, opt_state, opt_layouts):
        from .. import optim

        grads = self.reduce_gradients(grads)
        with optim.leaf_reduction(
                lambda values: _line_sums(values, opt_layouts)):
            tx.update(params, grads, opt_state)

    @classmethod
    def capture_blocker(cls, batch_norm: bool, moe: bool,
                        batch_shards: int) -> Optional[str]:
        return (f"steps_per_execution > 1 under {cls.__name__} on the"
                " card: not yet ported (ROADMAP 1.3a). The forward's tensor-, "
                "sequence-, expert- and pipeline-parallel collectives would "
                "be captured by the step's CUDA graph; the port captures no "
                "NCCL call")

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
        return _tp_comm(params, compute_dtype, hints, self.tp,
                        self.axis_sizes[self.axis])


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

    def _rows_group(self):
        return self.mesh.get_group(self.axis)

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


def _line_sums(values: List[torch.Tensor],
               layouts: Sequence[Optional[Layout]]) -> List[torch.Tensor]:
    """Per-leaf partial sums (0-d tensors, one per leaf of an update's
    lists) summed over every line a leaf's blocks split over (each split
    of a two-axis layout in turn); a whole leaf's as it is. The norms
    that span leaves (``grad_clip``, Lamb, the loss scale's check) under
    the hinted strategies (``optim.leaf_reduction``)."""
    t = torch.stack(values)
    lines: Dict[str, tuple] = {}
    for i, lay in enumerate(layouts):
        for level in ([] if lay is None else lay.levels()):
            if level.n > 1:
                lines.setdefault(level.axis, (level.group, []))[1].append(i)
    for group, idx in lines.values():
        part = t[idx].contiguous()
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        t = t.index_copy(0, torch.tensor(idx, device=t.device), part)
    return list(t.unbind())


def _stage_layout(shape, axis, n, rank, group) -> Layout:
    """Dim 0 of a pipelined stack over the pipe line, with the JAX
    ``_check_pipe_divisible`` error."""
    if shape[0] % n:
        raise ValueError(
            f"{shape[0]} pipelined blocks not divisible by {axis}={n} "
            "stages")
    return Layout(shape, 0, n, rank, group, axis)


def _pipe_comm(params, hints, n, data, m, compute_dtype):
    """The JAX ``DataPipelineParallel.comm_bytes_estimate``: the gradient
    all-reduce over the data line moves what a rank holds (a 1/n stage
    slice of a "pipe" stack), and the schedule hops one microbatch of
    activations per sending tick: ``width x itemsize x (M+n-2) / M`` per
    token, ``width`` the smallest ``shape[1]`` of the stacks' leaves of 3
    or more dimensions."""
    grad, width = 0, None
    for path, p in params.items():
        piped = role_of(path, hints or {}) == "pipe" and n > 1
        nbytes = _leaf_comm_bytes(p, compute_dtype)
        if data > 1:
            grad += nbytes // n if piped else nbytes
        if piped and p.dim() >= 3:
            w = int(p.shape[1])
            width = w if width is None else min(width, w)
    hop = 0
    if width is not None and n > 1:
        dt = compute_dtype if compute_dtype is not None else torch.float32
        hop = width * dt.itemsize * (m + n - 2) // m
    return _comm_row(grad=grad, hop_per_token=hop)


class DataExpertParallel(_HintedParallel):
    """Data x expert parallelism, as the JAX ``DataExpertParallel``: the
    batch's rows split over ``axis`` ("data") and replicated along
    ``expert_axis`` ("expert", ``expert_parallel`` ranks); the MoE's
    expert stacks (``nn.MoE``'s (E, ...) leaves, role "expert") split on
    dim 0 over the expert line, so a rank holds E/ep experts. Every other
    leaf is replicated.

    Where JAX lets GSPMD shard the dispatch and combine, the layer runs
    Megatron's pair over the expert line: its tokens and gates go in
    through ``copy_to_group`` (the backward sums their gradients over the
    line), the rank's experts run on the whole dispatch buffer, and the
    partial combine is summed by ``reduce_from_group``. With
    ``expert_parallel=1`` the expert leaves are blocks of a one-rank line
    and the pair runs over it. The gradients are all-reduced over the
    data line only."""

    def __init__(self, devices=None, *, mesh=None, expert_parallel: int = 2,
                 axis: str = "data", expert_axis: str = "expert",
                 device=None):
        super().__init__(devices, mesh, axis, expert_axis,
                         int(expert_parallel), "expert_parallel", device)
        if expert_axis not in self.axis_sizes:
            raise ValueError(
                f"Mesh {tuple(self.axis_sizes)} has no axis {expert_axis!r}")
        self.expert_axis = expert_axis
        self.ep, self.ep_rank, self.ep_group = self._axis_line(expert_axis)

    def param_layout(self, shape, role=None) -> Optional[Layout]:
        shape = tuple(int(s) for s in shape)
        if role != "expert" or not shape:
            return None
        if shape[0] % self.ep:
            raise ValueError(
                f"{shape[0]} experts not divisible by "
                f"{self.expert_axis}={self.ep}")
        return Layout(shape, 0, self.ep, self.ep_rank, self.ep_group,
                      self.expert_axis)

    def computes_block(self, layout: Layout) -> bool:
        return layout.axis == self.expert_axis


class DataPipelineParallel(_HintedParallel):
    """Data x pipeline parallelism, as the JAX ``DataPipelineParallel``:
    the batch's rows split over ``axis`` ("data"); an
    ``nn.PipelinedBlocks`` stack (role "pipe") split on its stage axis
    over ``pipe_axis`` ("pipe", ``pipeline_parallel`` ranks), so a rank
    holds S/pp consecutive blocks, and run by the GPipe (or interleaved)
    schedule over ``num_microbatches`` microbatches (default: the pipe
    size), the activations hopping rank to rank (``nn/pipeline.py``).
    The other leaves (embeddings, the head) are replicated and computed
    on every pipe rank; every gradient is all-reduced over the data line
    only. At ``pipeline_parallel=1`` the stack runs as the sequential
    scan, as in JAX."""

    def __init__(self, devices=None, *, mesh=None,
                 pipeline_parallel: int = 2,
                 num_microbatches: Optional[int] = None, axis: str = "data",
                 pipe_axis: str = "pipe", device=None):
        super().__init__(devices, mesh, axis, pipe_axis,
                         int(pipeline_parallel), "pipeline_parallel", device)
        if pipe_axis not in self.axis_sizes:
            raise ValueError(
                f"Mesh {tuple(self.axis_sizes)} has no axis {pipe_axis!r}")
        self.pipe_axis = pipe_axis
        self.pp, self.pp_rank, self.pp_group = self._axis_line(pipe_axis)
        if num_microbatches is None:
            num_microbatches = self.pp
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {num_microbatches}")
        self.num_microbatches = int(num_microbatches)

    def param_layout(self, shape, role=None) -> Optional[Layout]:
        if role != "pipe":
            return None
        return _stage_layout(tuple(int(s) for s in shape), self.pipe_axis,
                             self.pp, self.pp_rank, self.pp_group)

    def computes_block(self, layout: Layout) -> bool:
        return layout.axis == self.pipe_axis

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        return _pipe_comm(params, hints, self.pp, self.axis_sizes[self.axis],
                          self.num_microbatches, compute_dtype)


class CompositeParallel(_HintedParallel):
    """Every canonical axis on one mesh at once, as the JAX
    ``CompositeParallel``: ``axes`` (e.g. ``{"data": 2, "model": 2,
    "pipe": 2}``) or an n-axis ``mesh``. The roles resolve together
    (``_role_spec``): "col"/"row"/"row1" over "model", "expert" and
    "pipe" on dim 0 over their lines, and with an "fsdp" axis the ZeRO-3
    overlay on the largest free dimension that the fsdp size divides (a
    pipelined stack excluded): a leaf split over "model" and "fsdp" is a
    two-axis ``Layout`` (the fsdp split of the Megatron block). The
    batch's rows split over ("data", "fsdp"), the sequence over "seq"
    with ring or Ulysses attention as under ``DataSeqParallel``.

    The ported combinations (the axes larger than 1) are data x model x
    pipe, data x fsdp x pipe, data x seq, fsdp x model, fsdp x seq, seq x
    model, and expert with model, seq, fsdp or pipe, each held to the JAX
    strategy, and every mesh whose split axes are a subset of one of
    them; the others raise "not yet ported" (ROADMAP 1.7). Under an
    expert axis the MoE runs as under ``DataExpertParallel`` (the rows
    replicated along the expert line), on the tokens the other axes give
    it (``Strategy.token_layout``). A mesh that splits both "seq" and
    "pipe" raises: ring or Ulysses attention would run inside the
    pipeline's schedule, which the JAX package refuses too."""

    #: axes that shard batch rows (in canonical mesh order)
    BATCH_AXES = ("data", "fsdp")
    _PORTED = ({"data", "model", "pipe"}, {"data", "fsdp", "pipe"},
               {"data", "seq"}, {"fsdp", "model"}, {"fsdp", "seq"},
               {"seq", "model"}, {"expert", "model"}, {"expert", "seq"},
               {"expert", "fsdp"}, {"expert", "pipe"})
    _rows = collectives.WeakGroup()
    _rest_group = collectives.WeakGroup()

    def __init__(self, axes=None, devices=None, *, mesh=None,
                 num_microbatches: Optional[int] = None,
                 seq_attention: str = "ring", device=None):
        from .mesh import AXES, make_mesh

        self._form_group(device)
        if mesh is None:
            if not axes:
                raise ValueError(
                    "CompositeParallel needs axis sizes, e.g. "
                    "CompositeParallel({'data': 2, 'model': 2, 'pipe': 2})")
            mesh = make_mesh(dict(axes), device_type=self.device.type,
                             devices=devices)
        names = tuple(mesh.mesh_dim_names or ())
        unknown = set(names) - set(AXES)
        if unknown:
            raise ValueError(
                f"Mesh axes {sorted(unknown)} are not canonical {AXES}")
        row_axes = [a for a in self.BATCH_AXES if a in names]
        if not row_axes:
            raise ValueError(
                "CompositeParallel needs at least one batch axis "
                f"({self.BATCH_AXES}) in the mesh; got {names}")
        if seq_attention not in ("ring", "ulysses"):
            raise ValueError(
                f"attention must be 'ring' or 'ulysses', got "
                f"{seq_attention!r}")
        if mesh.size() != dist.get_world_size():
            raise ValueError(
                f"a CompositeParallel mesh spans every rank of the process "
                f"group: {mesh.size()} of {dist.get_world_size()}")
        self._mesh = mesh
        self.axis = row_axes[0]
        self._row_axes = tuple(row_axes)
        self.axis_sizes = {a: int(mesh.size(i)) for i, a in enumerate(names)}
        split = {a for a, n in self.axis_sizes.items() if n > 1}
        if {"seq", "pipe"} <= split:
            raise ValueError(
                f"CompositeParallel over {sorted(split)}: a sequence split "
                "with a pipeline would run ring or Ulysses attention inside "
                "the pipeline's schedule, which the JAX package cannot run "
                "either (its shard_map refuses the context mesh); split "
                "the sequence or the stages, not both")
        if not any(split <= ported for ported in self._PORTED):
            raise NotImplementedError(
                f"CompositeParallel over {sorted(split)}: not yet ported "
                "(ROADMAP 1.7); the ported combinations are data x model x "
                "pipe, data x fsdp x pipe, data x seq, fsdp x model, fsdp x "
                "seq, seq x model and expert with model, seq, fsdp or pipe")

        def present(name):
            return name if self.axis_sizes.get(name, 1) > 1 else None

        self.model_axis = present("model")
        self.pipe_axis = present("pipe")
        self.seq_axis = present("seq")
        self.expert_axis = present("expert")
        self.fsdp_axis = present("fsdp")
        self.seq_attention = seq_attention
        if num_microbatches is None:
            num_microbatches = (self.axis_sizes[self.pipe_axis]
                                if self.pipe_axis else 1)
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {num_microbatches}")
        self.num_microbatches = int(num_microbatches)
        coords = {a: int(mesh.get_local_rank(a)) for a in names}
        self._coords = coords
        # The row group (data x fsdp) and the batch group (rows x seq):
        # one group per combination of the other axes' coordinates,
        # formed by every rank in the same order.
        self._rows = self._sub_group(self._row_axes)
        self._batch_group = self._sub_group(
            self._row_axes + ((self.seq_axis,) if self.seq_axis else ()))
        # A gradient of an fsdp block arrives summed over the fsdp line
        # (the gather's reduce-scatter): the rest of the batch group sums
        # it (apply_update).
        rest = tuple(a for a in self._row_axes + (
            (self.seq_axis,) if self.seq_axis else ())
            if a != self.fsdp_axis)
        self._rest_group = (self._sub_group(rest) if rest and self.fsdp_axis
                            else None)
        if self.seq_axis:
            self.sp, self.sp_rank, self.sp_group = self._axis_line("seq")
        if self.model_axis:
            self.tp, self.tp_rank, self.tp_group = self._axis_line("model")
        if self.device.type == "cuda":
            for a in names:
                if self.axis_sizes[a] > 1:
                    t = torch.zeros(1, device=self.device)
                    dist.all_reduce(t, group=mesh.get_group(a))

    def _sub_group(self, axes):
        """The process group of this rank's ranks that differ only in
        ``axes`` (a sub-mesh, flattened in mesh order)."""
        names = tuple(self._mesh.mesh_dim_names)
        if len(axes) == 1:
            return self._mesh.get_group(axes[0])
        grid = self._mesh.mesh
        keep = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in keep]
        moved = grid.permute(*other, *keep).reshape(
            -1, int(torch.tensor([grid.shape[i] for i in keep]).prod()))
        mine = None
        for row in moved.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        return mine

    @property
    def num_replicas_in_sync(self) -> int:
        n = 1
        for a in self._row_axes:
            n *= self.axis_sizes[a]
        return n

    @property
    def row_axes(self) -> tuple:
        return self._row_axes

    @property
    def num_batch_shards(self) -> int:
        return self.num_replicas_in_sync * (self.sp if self.seq_axis else 1)

    def _rank(self) -> int:
        r = 0
        for a in self._row_axes:
            r = r * self.axis_sizes[a] + self._coords[a]
        return r

    def _rows_group(self):
        return self._rows

    def seq_offset(self, t_local: int) -> int:
        return self.sp_rank * int(t_local) if self.seq_axis else 0

    def shard_seq(self, a, dim: int = 1):
        if not self.seq_axis:
            return a
        return DataSeqParallel.shard_seq(self, a, dim)

    # -- placement ----------------------------------------------------------
    def _role_split(self, role, shape):
        """(dim, axis) of the JAX ``_role_spec``'s role split, or None."""
        nd = len(shape)
        if role in ("col", "row") and self.model_axis and nd >= 1:
            return (nd - 1 if role == "col" else 0), self.model_axis
        if role == "row1" and self.model_axis and nd >= 2:
            return 1, self.model_axis
        if role == "expert" and self.expert_axis and nd >= 1:
            return 0, self.expert_axis
        if role == "pipe" and self.pipe_axis and nd >= 1:
            return 0, self.pipe_axis
        return None

    def _line(self, axis, shape, dim) -> Layout:
        n, rank, group = self._axis_line(axis)
        if axis == self.pipe_axis:
            return _stage_layout(shape, axis, n, rank, group)
        if shape[dim] % n:
            raise ValueError(
                f"leaf of shape {shape}: dimension {dim} ({shape[dim]}) not "
                f"divisible by {axis}={n}")
        return Layout(shape, dim, n, rank, group, axis)

    def param_layout(self, shape, role=None) -> Optional[Layout]:
        shape = tuple(int(s) for s in shape)
        split = self._role_split(role, shape)
        lay = None if split is None else self._line(split[1], shape,
                                                    split[0])
        if self.fsdp_axis and role != "pipe":
            n = self.axis_sizes[self.fsdp_axis]
            taken = None if split is None else split[0]
            best, best_size = None, 0
            for d, size in enumerate(shape):
                if d != taken and size % n == 0 and size > best_size:
                    best, best_size = d, size
            if best is not None:
                inner_shape = shape if lay is None else lay.block_shape
                fs = self._line(self.fsdp_axis, inner_shape, best)
                lay = fs if lay is None else lay._replace(sub=fs)
        return lay

    def computes_block(self, layout: Layout) -> bool:
        return layout.axis in (self.model_axis, self.expert_axis,
                               self.pipe_axis)

    def writes_block(self, layout: Layout) -> bool:
        mine = {lv.axis for lv in layout.levels()}
        return all(c == 0 for a, c in self._coords.items() if a not in mine)

    def apply_update(self, tx, params, grads, opt_state, opt_layouts):
        from .. import optim

        # An fsdp block's gradient is all-reduced over the rest of the
        # batch group, every other over the whole batch group; then all
        # are divided by the number of shards.
        def kind(lay):
            if lay is None or not any(lv.axis == self.fsdp_axis
                                      for lv in lay.levels()):
                return True
            return self._rest_group if self._rest_group is not None \
                else False

        grads = self._bucket_mean(grads, [kind(lay) for lay in opt_layouts])
        with optim.leaf_reduction(
                lambda values: _line_sums(values, opt_layouts)):
            tx.update(params, grads, opt_state)

    def comm_bytes_estimate(self, params, compute_dtype=None,
                            hints=None) -> dict:
        if self.pipe_axis:
            return _pipe_comm(params, hints, self.axis_sizes[self.pipe_axis],
                              self.num_replicas_in_sync,
                              self.num_microbatches, compute_dtype)
        return super().comm_bytes_estimate(params, compute_dtype, hints)


__all__ = [
    "CompositeParallel", "DataExpertParallel", "DataParallel",
    "DataPipelineParallel", "DataSeqParallel", "DataTensorParallel", "FSDP",
    "FullyShardedDataParallel", "MultiWorkerMirroredStrategy",
    "SingleDevice", "Strategy", "ZeroDataParallel", "current_strategy",
]
