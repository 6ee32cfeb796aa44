"""The auto-shard planner: ``Model.compile(strategy="auto")``.

The port's copy of the JAX package's planner (``parallel/auto_shard.py``):
the same candidate matrix (SingleDevice, DP, ZeRO-1, FSDP, TP and PP x
precision x ``grad_accum`` x ``steps_per_execution``), the same pruning
texts, the same cost model (estimated step seconds = analytic FLOPs over
the backend's peak + collective bytes over its link rate + a dispatch
cost amortised by ``steps_per_execution``) and the same tie-break rules
(``TIE_REL_TOL``: toward HBM headroom under a cap, else toward the
simpler configuration). ``measure=True`` times the ``top_k`` shortlist
with real steps before committing; ``Model`` commits the winner.

Estimation is arithmetic over the number of ranks, never a collective:

- The module is built once on fake CPU tensors
  (``torch._subclasses.FakeTensorMode``: shapes and dtypes, no storage),
  the port's ``jax.eval_shape``. Its forward on a batch gives the logits'
  shape; the layers take their plain versions there, which only propagate
  shapes, and no kernel is launched or counted.
- Each candidate's bytes a rank are those of the blocks the port's
  strategies store: the placement rule ``_largest_divisible_spec``
  (ZeRO-1's statistics, FSDP's parameters and statistics), the
  tensor-parallel roles and the pipelined stack's stage split (a
  statistic laid out as the parameter whose path and shape it mirrors),
  every other leaf whole on every rank. The optimizer's tree is optax's
  (``interop.opt_state_to_tree``), priced as JAX prices it: the port
  keeps its counts as host integers and holds no leaf for a
  hyperparameter it fixes (Adam's ``eps_root``), so a live Adam model
  holds 12 bytes less than its row. The state (BatchNorm's running statistics) is
  priced whole under every strategy, as the port stores it; the JAX
  planner splits it under FSDP.
- The collective row comes from the formulas the strategies'
  ``comm_bytes_estimate`` use (``strategy._dp_comm`` and its siblings).

So every rank reaches the same plan alone, a test can plan for 8 ranks in
a process that has no process group (``devices=list(range(8))``), and
only the committed candidate builds its strategy, on every rank.

Two rules are the port's own:

- On the card, a candidate with ``steps_per_execution > 1`` whose
  strategy's forward issues collectives (``Strategy.capture_blocker``:
  sync-BN, FSDP, TP, PP, an MoE across ranks) is pruned with that
  strategy's reason: the port runs K > 1 as CUDA graphs, which capture
  no NCCL call (ROADMAP 1.3a). Off the card no candidate is pruned that
  JAX keeps.
- ``single_device`` is priced as JAX prices it (one device computes).
  Committed under a group of n > 1 ranks, every rank trains the whole
  batch alone on its own card, and the ranks stay bit-identical.

The JAX module's second job, ``shard_rows``/``ambient_mesh``, has no
counterpart here by design: XLA's partitioner cannot see inside a Pallas
kernel and would run it on the global batch, so JAX wraps the kernels in
``shard_map``; the port runs one process per card, and every kernel
already runs on its own rank's rows.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from . import strategy as S

#: Relative cost band treated as a tie (dispatch jitter on small models is
#: far larger than this; the tie-break rules below decide inside the band).
TIE_REL_TOL = 0.05

#: Analytic per-device peak FLOP/s and per-device collective bandwidth by
#: backend: the JAX package's order-of-magnitude values, copied unchanged
#: so that a plan here equals the JAX planner's, and not measured on the
#: H100. The cost model ranks candidates for one model on one backend, so
#: only the relative weight of compute, communication and dispatch matters.
_BACKEND_CONSTANTS = {
    "gpu": {"peak_flops": 1.0e14, "comm_bw": 5.0e10, "dispatch_s": 8e-4,
            "reduced_speedup": 2.0},
    # The JAX package measured bf16 slower than f32 on its CPU backend,
    # so reduced precision gets a penalty there, not a speedup.
    "cpu": {"peak_flops": 5.0e10, "comm_bw": 1.0e10, "dispatch_s": 1.5e-3,
            "reduced_speedup": 0.85},
}

_STRATEGY_RANK = {  # simplicity order for tie-breaking (lower = simpler)
    "single_device": 0, "dp": 1, "zero1": 2, "fsdp": 3, "tp": 4, "pp": 5,
}

_STRATEGY_CLASS = {
    "single_device": S.SingleDevice, "dp": S.DataParallel,
    "zero1": S.ZeroDataParallel, "fsdp": S.FSDP,
    "tp": S.DataTensorParallel, "pp": S.DataPipelineParallel,
}


def _backend_constants(backend: str) -> dict:
    try:
        return _BACKEND_CONSTANTS[backend]
    except KeyError:
        raise ValueError(
            f"no cost constants for backend {backend!r}; known: "
            f"{sorted(_BACKEND_CONSTANTS)}") from None


def _backend(device) -> str:
    """The JAX platform name of the port's ``device``: ``"gpu"`` for the
    card, ``"cpu"``."""
    dev = resolve_device(device)
    return {"cuda": "gpu", "cpu": "cpu"}.get(dev.type, dev.type)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the configuration matrix the planner scores."""

    strategy: str                # single_device | dp | zero1 | fsdp | tp | pp
    model_parallel: int = 1            # > 1 only for strategy == "tp"
    pipeline_parallel: int = 1         # > 1 only for strategy == "pp"
    num_microbatches: int = 1          # pipeline schedule M (pp only)
    precision: Optional[str] = None    # None | precision preset name
    grad_accum: int = 1
    steps_per_execution: int = 1

    def label(self) -> str:
        parts = [self.strategy]
        if self.model_parallel > 1:
            parts[-1] += f"{self.model_parallel}"
        if self.pipeline_parallel > 1:
            parts[-1] += f"{self.pipeline_parallel}"
            parts.append(f"m{self.num_microbatches}")
        if self.precision:
            parts.append(self.precision)
        if self.grad_accum > 1:
            parts.append(f"accum{self.grad_accum}")
        if self.steps_per_execution > 1:
            parts.append(f"k{self.steps_per_execution}")
        return "/".join(parts)

    def config(self) -> dict:
        return {
            "strategy": self.strategy,
            "model_parallel": self.model_parallel,
            "pipeline_parallel": self.pipeline_parallel,
            "num_microbatches": self.num_microbatches,
            "precision": self.precision,
            "grad_accum": self.grad_accum,
            "steps_per_execution": self.steps_per_execution,
        }

    def complexity(self) -> tuple:
        """Tie-break key: simpler configs sort first."""
        return (
            _STRATEGY_RANK.get(self.strategy, 99),
            self.model_parallel,
            self.pipeline_parallel,
            self.num_microbatches,
            0 if self.precision is None else 1,
            self.grad_accum,
            self.steps_per_execution,
        )

    def build_strategy(self, devices=None, *, device=None):
        """The concrete strategy of this candidate over ``devices`` (the
        ranks; default: every rank of the process group) on ``device``
        (the port's: None is this rank's card, ``"cpu"`` a gloo group).
        A collective of the group: every rank builds it, in the same
        order."""
        if self.strategy == "single_device":
            return S.SingleDevice(device)
        devices = list(devices) if devices is not None else None
        if self.strategy == "dp":
            return S.DataParallel(devices, device=device)
        if self.strategy == "zero1":
            return S.ZeroDataParallel(devices, device=device)
        if self.strategy == "fsdp":
            return S.FSDP(devices, device=device)
        if self.strategy == "tp":
            return S.DataTensorParallel(
                devices, model_parallel=self.model_parallel, device=device)
        if self.strategy == "pp":
            return S.DataPipelineParallel(
                devices, pipeline_parallel=self.pipeline_parallel,
                num_microbatches=self.num_microbatches, device=device)
        raise ValueError(f"unknown candidate strategy {self.strategy!r}")


class Feasibility:
    """Reusable HBM-cap predicate: ``check`` returns None when the
    candidate fits, else a human-readable pruning reason recorded in the
    Plan."""

    def __init__(self, hbm_cap_bytes: Optional[int] = None):
        self.hbm_cap_bytes = (
            int(hbm_cap_bytes) if hbm_cap_bytes is not None else None
        )

    def check(self, state_bytes_per_device: int,
              activation_bytes_per_device: int = 0) -> Optional[str]:
        if self.hbm_cap_bytes is None:
            return None
        need = int(state_bytes_per_device) + int(activation_bytes_per_device)
        if need <= self.hbm_cap_bytes:
            return None
        return (
            f"needs {need} bytes/device (state {int(state_bytes_per_device)}"
            f" + activations {int(activation_bytes_per_device)}) "
            f"> hbm_cap {self.hbm_cap_bytes}"
        )


@dataclasses.dataclass
class Plan:
    """The planner's decision record: the chosen config and its predicted
    numbers, every candidate's row, and the rationale for pruned ones.
    ``summary()`` is the JSON-safe dict that lands in
    ``model.last_fit_telemetry["plan"]`` and the event log
    (``auto_shard_plan``)."""

    chosen: dict
    candidates: List[dict]
    pruned: List[dict]
    devices: int
    backend: str
    batch_size: int
    n_params: int
    hbm_cap_bytes: Optional[int]
    measured: Optional[List[dict]] = None
    tie_break: Optional[str] = None

    def chosen_candidate(self) -> Candidate:
        return Candidate(**self.chosen["config"])

    def summary(self) -> dict:
        return {
            "chosen": self.chosen,
            "devices": self.devices,
            "backend": self.backend,
            "batch_size": self.batch_size,
            "n_params": self.n_params,
            "hbm_cap_bytes": self.hbm_cap_bytes,
            "candidates": self.candidates,
            "pruned": self.pruned,
            "measured": self.measured,
            "tie_break": self.tie_break,
        }


# ------------------------------------------------------------ abstraction --
def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _abstract_copy(module, input_shape, seed: int, mode):
    """A copy of ``module`` whose leaves are fake CPU tensors of the full
    shapes: built from ``seed`` when ``module`` is not built yet, else
    with each live leaf (a block, under a sharding strategy) replaced by a
    fake one of its full shape."""
    from ..parallel.collectives import layout_of

    live = list(module.parameters()) + list(module.buffers())
    with mode:
        if not live:
            abstract = copy.deepcopy(module)
            abstract.build(tuple(input_shape),
                           torch.Generator().manual_seed(int(seed)))
        else:
            memo = {}
            for t in live:
                lay = layout_of(t)
                shape = lay.shape if lay is not None else tuple(t.shape)
                fake = torch.empty(shape, dtype=t.dtype)
                memo[id(t)] = (torch.nn.Parameter(
                    fake, requires_grad=t.requires_grad)
                    if isinstance(t, torch.nn.Parameter) else fake)
            abstract = copy.deepcopy(module, memo)
    return abstract.eval()


def _meta(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {p: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
            for p, t in tree.items()}


def abstract_model_state(module, input_shape, tx, *, seed: int = 0) -> dict:
    """Abstract params/state/opt-state of ``module`` + ``tx`` (the dry-run
    twin of ``Model.build``, costing shapes, not memory): ``params`` and
    ``state`` as ``{path: meta tensor}`` of the full leaves, ``opt`` as
    the ``(path, leaf)`` pairs of optax's tree of ``tx``'s state (meta
    tensors, and numpy scalars for the counts and hyperparameters),
    ``hints`` the module's ``sharding_hints()``, ``module`` the fake copy
    the forward probe runs. One call serves every candidate (the shapes
    do not depend on the strategy)."""
    from .. import interop
    from ..nn import moe as moe_lib
    from ..nn.core import param_tree, state_tree
    from ..training.model import _has_batch_norm

    mode = _fake_mode()
    abstract = _abstract_copy(module, input_shape, seed, mode)
    params = _meta(param_tree(abstract))
    state = _meta(state_tree(abstract))
    opt = list(interop.iter_leaf_paths(interop.opt_state_to_tree(
        tx, tx.init(list(params.values())), params)))
    return {
        "params": params,
        "state": state,
        "opt": opt,
        "hints": abstract.sharding_hints(),
        "n_params": sum(int(np.prod(t.shape, dtype=np.int64))
                        for t in params.values()),
        "module": abstract,
        "mode": mode,
        "batch_norm": _has_batch_norm(abstract),
        "moe": moe_lib.has_moe(abstract),
    }


def probe_forward(abstracts: dict, input_shape, batch_size: int):
    """Abstract forward probe: ``(x dtype, logits fake tensor)``. Tries
    float32 input first (images, features), then int32 tokens, as the JAX
    probe does. The port's embedding casts its indices, so a token model
    passes the float32 probe: its input is priced at float32's 4 bytes,
    which are int32's."""
    module, mode = abstracts["module"], abstracts["mode"]
    last_err = None
    with mode, torch.no_grad():
        for dtype in (torch.float32, torch.int32):
            x = torch.zeros((int(batch_size),) + tuple(input_shape),
                            dtype=dtype)
            try:
                return dtype, module(x)
            except Exception as e:  # wrong input dtype (or rank)
                last_err = e
    raise TypeError(
        f"could not run {type(module).__name__} abstractly with float32 "
        f"or int32 input of shape {tuple(input_shape)}: {last_err}"
    )


# -------------------------------------------------------------- estimation --
def _sorted_leaves(tree: Dict[str, torch.Tensor]):
    """``(path, leaf)`` in the JAX tree's order (keys sorted at every
    level), so that a walk finds the first leaf JAX's walk finds."""
    return sorted(tree.items(), key=lambda kv: kv[0].split("/"))


def _check_divisibility(cand: Candidate, n_devices: int, batch_size: int,
                        abstracts: dict) -> Optional[str]:
    """Structural feasibility: batch math and TP/PP shard divisibility.
    Returns a pruning reason or None."""
    if cand.strategy != "single_device" and n_devices % cand.model_parallel:
        return (f"{n_devices} devices not divisible by model_parallel="
                f"{cand.model_parallel}")
    if n_devices % cand.pipeline_parallel:
        return (f"{n_devices} devices not divisible by pipeline_parallel="
                f"{cand.pipeline_parallel}")
    replicas = (
        1 if cand.strategy == "single_device"
        else n_devices // (cand.model_parallel * cand.pipeline_parallel)
    )
    if batch_size % cand.grad_accum:
        return (f"grad_accum={cand.grad_accum} does not divide the global "
                f"batch {batch_size}")
    micro = batch_size // cand.grad_accum
    if micro % replicas:
        return (f"microbatch {micro} not divisible by {replicas} replicas")
    if cand.strategy == "tp":
        m = cand.model_parallel
        bad = _tp_indivisible(abstracts["params"], abstracts["hints"], m)
        if bad:
            return (f"TP shard dim {bad[1]} of {bad[0]} not divisible by "
                    f"model_parallel={m}")
    if cand.strategy == "pp":
        pp = cand.pipeline_parallel
        stages = _pipe_stage_count(abstracts["params"], abstracts["hints"])
        if stages is None:
            return "no 'pipe'-hinted stacks to place stages from"
        if stages % pp:
            return (f"{stages} pipeline stages not divisible by "
                    f"pipeline_parallel={pp}")
        per_replica = micro // max(replicas, 1)
        if per_replica % cand.num_microbatches:
            return (f"per-replica batch {per_replica} not divisible by "
                    f"num_microbatches={cand.num_microbatches}")
    return None


def _pipe_stage_count(params, hints) -> Optional[int]:
    """Leading (stage) dim of the first 'pipe'-hinted leaf: the number of
    schedulable stages a PipelinedBlocks stack exposes. None when nothing
    is pipe-hinted (the module has no pipeline stack to place)."""
    for path, p in _sorted_leaves(params):
        if S.role_of(path, hints or {}) == "pipe" and p.dim():
            return int(p.shape[0])
    return None


def _tp_indivisible(params, hints, m: int):
    """First (path, shape) whose hinted TP dim doesn't divide by ``m``."""
    for path, p in _sorted_leaves(params):
        d = S._role_dim(S.role_of(path, hints or {}), p.dim())
        if d is not None and p.shape[d] % m:
            return path, tuple(int(s) for s in p.shape)
    return None


def _role_split(cand: Candidate, role: Optional[str], shape):
    """``(dim, parts)`` of a parameter's split under a hinted candidate
    (the strategies' ``param_layout``), or None: stored whole."""
    if cand.strategy == "tp":
        d = S._role_dim(role, len(shape))
        return None if d is None else (d, cand.model_parallel)
    if cand.strategy == "pp" and role == "pipe" and len(shape):
        return 0, cand.pipeline_parallel
    return None


def _block_bytes(shape, itemsize: int, split) -> int:
    """Bytes of a leaf's block: whole, or ``split = (dim, parts)``."""
    numel = int(np.prod(shape, dtype=np.int64))
    return numel // split[1] * itemsize if split else numel * itemsize


def _largest(shape, n: int):
    d = S._largest_divisible_spec(tuple(shape), n) if len(shape) else None
    return None if d is None else (d, n)


def _state_bytes(cand: Candidate, n: int, abstracts: dict) -> int:
    """Bytes a rank holds of the parameters, the state and the optimizer
    state under ``cand`` (plus the f32 gradient accumulator that the JAX
    planner prices for ``grad_accum > 1``, laid out as the parameters)."""
    params, hints = abstracts["params"], abstracts["hints"]
    kind = cand.strategy
    splits = {}
    for path, p in params.items():
        shape = tuple(p.shape)
        if kind == "fsdp":
            splits[path] = _largest(shape, n)
        elif kind in ("tp", "pp"):
            splits[path] = _role_split(cand, S.role_of(path, hints or {}),
                                       shape)
        else:
            splits[path] = None
    total = sum(_block_bytes(p.shape, p.element_size(), splits[path])
                for path, p in params.items())
    total += sum(_block_bytes(t.shape, t.element_size(), None)
                 for t in abstracts["state"].values())
    by_path = {tuple(path.split("/")): (tuple(p.shape), splits[path])
               for path, p in params.items()}
    for path, leaf in abstracts["opt"]:
        shape = tuple(leaf.shape)
        itemsize = (leaf.element_size() if isinstance(leaf, torch.Tensor)
                    else np.asarray(leaf).itemsize)
        if kind in ("zero1", "fsdp"):
            split = _largest(shape, n)
        elif kind in ("tp", "pp"):
            names = tuple(path.split("/"))
            split = None
            for i in range(len(names)):
                hit = by_path.get(names[i:])
                if hit is not None and hit[0] == shape:
                    split = hit[1]
                    break
        else:
            split = None
        total += _block_bytes(shape, itemsize, split)
    if cand.grad_accum > 1:
        total += sum(_block_bytes(p.shape, 4, splits[path])
                     for path, p in params.items())
    return int(total)


def _comm_estimate(cand: Candidate, n: int, params, compute_dtype,
                   hints) -> dict:
    """The candidate's strategy's ``comm_bytes_estimate``, from the same
    formulas, without building it."""
    kind = cand.strategy
    if kind == "single_device":
        return S._comm_row()
    if kind == "dp":
        return S._dp_comm(params, compute_dtype)
    if kind == "zero1":
        return S._zero1_comm(params, compute_dtype, n)
    if kind == "fsdp":
        return S._fsdp_comm(params, compute_dtype, n)
    if kind == "tp":
        return S._tp_comm(params, compute_dtype, hints,
                          cand.model_parallel, n // cand.model_parallel)
    return S._pipe_comm(params, hints, cand.pipeline_parallel,
                        n // cand.pipeline_parallel,
                        cand.num_microbatches, compute_dtype)


def _replicas(cand: Candidate, n: int) -> int:
    if cand.strategy == "single_device":
        return 1
    return n // (cand.model_parallel * cand.pipeline_parallel)


def _capture_reason(cand: Candidate, n: int, abstracts: dict
                    ) -> Optional[str]:
    """The port-only pruning rule on the card: why ``cand``'s K-step
    dispatch cannot be a CUDA graph (``Strategy.capture_blocker``)."""
    if cand.steps_per_execution <= 1:
        return None
    return _STRATEGY_CLASS[cand.strategy].capture_blocker(
        abstracts["batch_norm"], abstracts["moe"], _replicas(cand, n))


def estimate_candidate(cand: Candidate, ctx: dict) -> dict:
    """One candidate's predicted row: per-device state/activation bytes,
    per-step comm traffic, and the cost-model step seconds. Pure
    arithmetic over the shared abstract trees: nothing is placed and no
    strategy is built."""
    from .. import precision as precision_lib

    abstracts, n = ctx["abstracts"], len(ctx["devices"])
    consts = ctx["consts"]
    tokens = ctx["tokens"]
    hints = abstracts["hints"]
    policy = precision_lib.get(cand.precision)
    compute_dtype = policy.compute_dtype if policy is not None else None
    compute_itemsize = (
        policy.compute_itemsize if policy is not None else 4
    )
    state_bytes = _state_bytes(cand, n, abstracts)

    replicas = _replicas(cand, n)
    n_active = 1 if cand.strategy == "single_device" else n
    tokens_local = max(tokens // max(replicas, 1), 1)

    # Coarse activation proxy: the two tensors knowable without tracing
    # the module's internals: the input and the logits (whose cotangent
    # doubles them in backward), per microbatch, plus the staged
    # super-batch when steps_per_execution stacks K inputs on device.
    input_bytes = ctx["input_bytes"]
    logits_bytes = ctx["logits_elems"] * compute_itemsize
    act_bytes = (
        (input_bytes + 2 * logits_bytes)
        // max(replicas, 1) // cand.grad_accum
        + input_bytes * cand.steps_per_execution // max(replicas, 1)
    )

    comm = _comm_estimate(cand, n, abstracts["params"], compute_dtype, hints)
    # Per optimizer step: FSDP/ZeRO gathers repeat per microbatch; the
    # gradient reduce happens once on the accumulated value; TP's
    # activation all-reduces total the same tokens regardless of M.
    comm_bytes = (
        comm["gathered_param_bytes_per_device"] * cand.grad_accum
        + comm["grad_reduce_bytes_per_device"]
        + comm["activation_reduce_bytes_per_token_per_device"] * tokens_local
        + comm.get("pipeline_hop_bytes_per_token_per_device", 0)
        * tokens_local
    )

    flops = 6.0 * abstracts["n_params"] * tokens
    speed = consts["peak_flops"] * n_active
    if compute_dtype is not None and compute_itemsize < 4:
        speed *= consts["reduced_speedup"]
    compute_s = flops / speed
    if cand.model_parallel > 1:
        # Megatron splitting narrows every sharded product's contraction or
        # output dim by the TP factor and puts a blocking all-reduce per
        # layer on the critical path: priced as a +15% compute penalty per
        # doubling of the TP factor.
        compute_s *= 1.0 + 0.15 * float(np.log2(cand.model_parallel))
    if cand.pipeline_parallel > 1:
        # GPipe bubble: of M+n-1 schedule ticks only M do useful work per
        # stage, so pipelining is slower at equal memory and is picked only
        # when flat layouts are pruned.
        m_pipe = max(int(cand.num_microbatches), 1)
        compute_s *= (m_pipe + cand.pipeline_parallel - 1) / m_pipe
    comm_s = comm_bytes / consts["comm_bw"]
    dispatch_s = consts["dispatch_s"] / cand.steps_per_execution
    return {
        "config": cand.config(),
        "label": cand.label(),
        "state_bytes_per_device": int(state_bytes),
        "activation_bytes_per_device": int(act_bytes),
        "comm_bytes_per_step_per_device": int(comm_bytes),
        "comm_bytes_estimate": comm,
        "est_step_seconds": compute_s + comm_s + dispatch_s,
        "cost_breakdown": {
            "compute_s": compute_s,
            "comm_s": comm_s,
            "dispatch_s": dispatch_s,
        },
    }


# -------------------------------------------------------------- enumeration --
def enumerate_candidates(
    n_devices: int,
    *,
    hints=None,
    precisions: Sequence[Optional[str]] = (None,),
    grad_accums: Sequence[int] = (1, 2, 4),
    steps_per_execution: Sequence[int] = (1, 8),
    include_tp: bool = True,
    include_pp: bool = True,
) -> List[Candidate]:
    """The candidate matrix for a device count: strategies x precision x
    grad_accum x steps_per_execution. TP mesh shapes come from the
    divisors of the device count and are proposed only when the module
    carries Megatron sharding hints; PP stage counts likewise, only when
    the hints carry a 'pipe' role (a PipelinedBlocks stack), each at
    microbatch counts M in {n, 2n}."""
    strategies: List[Tuple[str, int, int, int]] = []  # (name, tp, pp, M)
    if n_devices == 1:
        strategies.append(("single_device", 1, 1, 1))
    else:
        strategies += [("single_device", 1, 1, 1), ("dp", 1, 1, 1),
                       ("zero1", 1, 1, 1), ("fsdp", 1, 1, 1)]
        if include_tp and hints:
            for m in range(2, n_devices + 1):
                if n_devices % m == 0:
                    strategies.append(("tp", m, 1, 1))
        if include_pp and _hints_have_pipe(hints):
            for pp in range(2, n_devices + 1):
                if n_devices % pp == 0:
                    for mb in (pp, 2 * pp):
                        strategies.append(("pp", 1, pp, mb))
    out = []
    for name, m, pp, mb in strategies:
        for prec in precisions:
            for ga in grad_accums:
                for k in steps_per_execution:
                    out.append(Candidate(
                        strategy=name, model_parallel=m,
                        pipeline_parallel=pp, num_microbatches=mb,
                        precision=prec,
                        grad_accum=int(ga), steps_per_execution=int(k),
                    ))
    return out


def _hints_have_pipe(hints) -> bool:
    """True when any node of the hint tree carries the 'pipe' role."""
    if hints == "pipe":
        return True
    if isinstance(hints, dict):
        return any(_hints_have_pipe(v) for v in hints.values())
    return False


def _default_devices() -> list:
    """Every rank of the default process group, or the one process."""
    return list(range(dist.get_world_size() if dist.is_initialized()
                      else 1))


# ------------------------------------------------------------------ planning --
def plan_sharding(
    module,
    input_shape,
    *,
    tx=None,
    optimizer="adam",
    batch_size: int = 32,
    devices=None,
    hbm_cap_bytes: Optional[int] = None,
    precisions: Optional[Sequence[Optional[str]]] = None,
    grad_accums: Optional[Sequence[int]] = None,
    steps_per_execution: Optional[Sequence[int]] = None,
    include_tp: bool = True,
    include_pp: bool = True,
    measure: bool = False,
    measure_fn: Optional[
        Callable[[Candidate, dict], Optional[float]]
    ] = None,
    top_k: int = 3,
    seed: int = 0,
    device=None,
) -> Plan:
    """Plan the fastest feasible sharding config for ``module`` over
    ``devices`` (the ranks, default every rank of the process group) on
    ``device`` (the port's: None is the card, ``"cpu"``). Deterministic
    for fixed inputs (``measure=False``), and the same on every rank.

    ``tx``: the optimizer whose state is priced (default
    ``optim.get(optimizer)``). ``precisions`` defaults to ``(None,
    "mixed_bfloat16")`` on the card and ``(None,)`` on the CPU, as the
    JAX planner's backend rule. ``measure=True`` times the ``top_k``
    estimate-ranked survivors with ``measure_fn`` (seconds per step, or
    None to skip one candidate) and commits to the fastest measured."""
    from .. import optim

    devices = list(devices) if devices is not None else _default_devices()
    backend = _backend(device)
    consts = _backend_constants(backend)
    if tx is None:
        tx = optim.get(optimizer)
    if precisions is None:
        precisions = (None, "mixed_bfloat16") if backend == "gpu" else (None,)
    if grad_accums is None:
        grad_accums = (1, 2, 4)
    if steps_per_execution is None:
        steps_per_execution = (1, 8)

    abstracts = abstract_model_state(module, input_shape, tx, seed=seed)
    x_dtype, logits = probe_forward(abstracts, input_shape, batch_size)
    tokens = int(np.prod(logits.shape[:-1], dtype=np.int64))
    ctx = {
        "abstracts": abstracts,
        "devices": devices,
        "consts": consts,
        "batch_size": int(batch_size),
        "tokens": tokens,
        "input_bytes": int(
            np.prod((batch_size,) + tuple(input_shape), dtype=np.int64)
        ) * x_dtype.itemsize,
        "logits_elems": int(np.prod(logits.shape, dtype=np.int64)),
        "logits_shape": tuple(logits.shape),
        "x_dtype": x_dtype,
    }

    feasibility = Feasibility(hbm_cap_bytes)
    candidates = enumerate_candidates(
        len(devices), hints=abstracts["hints"], precisions=precisions,
        grad_accums=grad_accums, steps_per_execution=steps_per_execution,
        include_tp=include_tp, include_pp=include_pp,
    )
    feasible, pruned = [], []
    for cand in candidates:
        reason = _check_divisibility(cand, len(devices), batch_size,
                                     abstracts)
        if reason is None and backend == "gpu":
            reason = _capture_reason(cand, len(devices), abstracts)
        if reason is not None:
            pruned.append({"config": cand.config(), "label": cand.label(),
                           "reason": reason})
            continue
        row = estimate_candidate(cand, ctx)
        reason = feasibility.check(
            row["state_bytes_per_device"],
            row["activation_bytes_per_device"],
        )
        if reason is not None:
            row["reason"] = reason
            pruned.append(row)
        else:
            row["reason"] = None
            feasible.append((cand, row))
    if not feasible:
        raise ValueError(
            "auto-shard planner found NO feasible candidate under "
            f"hbm_cap_bytes={hbm_cap_bytes} for batch {batch_size}: "
            + "; ".join(f"{p['label']}: {p['reason']}" for p in pruned[:6])
        )

    # Rank: cost ascending; inside the tie band prefer more HBM headroom
    # when a cap binds (activations and fragmentation live in the slack),
    # else the simpler config.
    feasible.sort(key=lambda cr: cr[1]["est_step_seconds"])
    best_cost = feasible[0][1]["est_step_seconds"]
    band = [
        cr for cr in feasible
        if cr[1]["est_step_seconds"] <= best_cost * (1.0 + TIE_REL_TOL)
    ]
    if hbm_cap_bytes is not None and len(band) > 1:
        band.sort(key=lambda cr: (cr[1]["state_bytes_per_device"],
                                  cr[0].complexity()))
        tie_break = "hbm_headroom"
    else:
        band.sort(key=lambda cr: cr[0].complexity())
        tie_break = "simplicity"
    ordered = band + [cr for cr in feasible if cr not in band]

    measured_rows = None
    if measure and measure_fn is not None:
        shortlist = ordered[: max(1, int(top_k))]
        measured_rows = []
        timed = []
        for cand, row in shortlist:
            secs = measure_fn(cand, ctx)
            measured_rows.append({
                "config": cand.config(), "label": cand.label(),
                "seconds_per_step": secs,
            })
            if secs is not None:
                timed.append((secs, cand, row))
        if timed:
            timed.sort(key=lambda t: t[0])
            _, cand0, row0 = timed[0]
            ordered = (
                [(cand0, row0)]
                + [cr for cr in ordered if cr[0] is not cand0]
            )
            tie_break = "measured"

    chosen_cand, chosen_row = ordered[0]
    plan = Plan(
        chosen=chosen_row,
        candidates=[r for _, r in ordered],
        pruned=pruned,
        devices=len(devices),
        backend=backend,
        batch_size=int(batch_size),
        n_params=abstracts["n_params"],
        hbm_cap_bytes=(
            int(hbm_cap_bytes) if hbm_cap_bytes is not None else None
        ),
        measured=measured_rows,
        tie_break=tie_break,
    )
    plan._ctx = ctx  # probe results, for Model's measure path
    return plan


__all__ = [
    "TIE_REL_TOL", "Candidate", "Feasibility", "Plan",
    "abstract_model_state", "enumerate_candidates", "estimate_candidate",
    "plan_sharding", "probe_forward",
]
