"""Parameter trees carried between the JAX package and the port.

The port's modules register their parameters under the JAX package's tree
paths (``residual_1/main/dense_1/kernel``), with the same layouts (Dense
kernels ``(din, units)``, attention projections ``(d, heads*head_dim)``),
so a JAX parameter tree loads with no transposes, and trained parameters
come back as numpy under the same paths (``params_to_numpy``); the state
(BatchNorm's running statistics) travels the same way (``state_from_jax``,
``state_to_numpy``). The path rules are those
of the JAX package's ``checkpoint/core.py``: sorted dict keys, ``#i`` for
tuple and list entries, joined by ``/``.

The optimizer state goes under optax's paths (``opt_state_to_tree``,
``opt_state_from_tree``): the JAX package keeps it as
``inject_hyperparams``' state, ``(count, hyperparams, {}, inner)``, and a
JAX restore grafts the leaves of a file onto its own template by count,
so the port writes exactly the leaves optax has, with their dtypes:

==================  ======================================================
optimizer           flat paths (``<p>``: a parameter's path)
==================  ======================================================
``SGD`` (momentum)  ``#0`` int32, ``#1/learning_rate``, ``#1/momentum``,
                    ``#3/#0/#0/<p>`` (trace)
``SGD``             ``#0``, ``#1/learning_rate``
``Adam``/``AdamW``  ``#0``, ``#1/{b1,b2,eps,eps_root,learning_rate[,
                    weight_decay]}``, ``#3/#0/#0`` int32 (count),
                    ``#3/#0/#1/<p>`` (mu), ``#3/#0/#2/<p>`` (nu)
``fused_adam[w]``   ``#0``, ``#1/{b1,b2,eps,learning_rate,weight_decay}``,
                    ``#3/#0`` int32, ``#3/#1/<p>`` (mu), ``#3/#2/<p>`` (nu)
``RMSprop``         ``#0``, ``#1/{decay,eps,initial_scale,learning_rate,
                    momentum}``, ``#3/#0/#0/<p>`` (nu), ``#3/#2/#0/<p>``
                    (the momentum trace)
``Adagrad``         ``#0``, ``#1/{eps,initial_accumulator_value,
                    learning_rate}``, ``#3/#0/#0/<p>`` (sum of squares)
``Lamb``            ``#0``, ``#1/{b1,b2,eps,eps_root,learning_rate,
                    weight_decay}``, ``#3/#0/#0`` int32 (count),
                    ``#3/#0/#1/<p>`` (mu), ``#3/#0/#2/<p>`` (nu)
``sgd_with_cosine`` ``#0/#0/<p>`` (trace), ``#1/#0`` int32 (the
                    schedule's count): plain optax.sgd, not injected
==================  ======================================================

A hyperparameter driven by a schedule adds its schedule's step count,
``#2/<name>/#0`` (int32), as inject_hyperparams keeps it; it equals the
update count.

Hyperparameters optax holds and the port does not (Adam's ``eps_root``,
``fused_adam``'s ``weight_decay``) are written as 0, and a file where they
are not 0 is refused.

The wrappers nest these layouts as optax does: ``chain(clip, tx)`` is
``(EmptyState(), <tx>)`` (the clip has no leaves, so ``tx``'s paths take
the prefix ``#1/``), and ``MultiSteps`` is ``MultiStepsState``:
``#0`` mini_step and ``#1`` gradient_step (int32), ``#2/...`` the inner
state, ``#3/<p>`` the f32 gradient accumulator, ``#4`` the empty skip
state. A checkpoint saved mid-accumulation resumes in either package.

Under a sharded strategy (``ZeroDataParallel``, ``FSDP``) a rank holds
blocks of the leaves. ``Model.load_params`` places full parameters into
this rank's blocks, ``opt_state_from_tree(..., layouts=)`` places full
optimizer leaves the same way (or takes blocks read for this rank,
``blocks=True``), and :func:`place` does both for a model at once: the
way JAX parameters and optimizer state, as numpy, reach a sharded port
model.
``dynamic_loss_scaling`` (``compile(precision="mixed_float16")``), the
outermost wrapper, is the JAX package's ``LossScaleState``: ``#0`` the
live scale (f32), ``#1`` growth_count (int32), ``#2/...`` the inner state;
a scaling and a non-scaling state differ in their leaf count, so crossing
between them raises the format error, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import optim

SEP = "/"


def iter_leaf_paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaf_paths(tree[k], f"{prefix}{k}{SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaf_paths(v, f"{prefix}#{i}{SEP}")
    elif tree is None:
        return
    else:
        yield prefix.rstrip(SEP), tree


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    """``{path: numpy array}`` for every leaf of ``tree``."""
    return {p: np.asarray(v) for p, v in iter_leaf_paths(tree, prefix)}


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Model.params`` tree (leaves as numpy arrays,
    e.g. after ``jax.device_get``) as the port's flat ``{path: tensor}``
    parameters on the CPU: floating leaves in f32, integer leaves (a
    quantized weight's int8 ``q``; its ``scale`` is f32) as they are.
    Load them with ``Model.load_params``."""
    out = {}
    for path, leaf in flatten_tree(tree).items():
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) or a.dtype.kind == "V":
            a = np.array(leaf, dtype=np.float32)
        out[path] = torch.from_numpy(np.array(a))
    return out


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The port's ``{path: tensor}`` parameters (``Model.params``) as
    ``{path: numpy array}`` on the host, floating leaves in f32 and a
    quantized weight's int8 ``q`` as int8, under the same tree paths as
    ``flatten_tree`` gives a JAX parameter tree, so the two compare leaf
    by leaf (``checkpoint.unflatten_tree`` nests them as JAX holds them)."""
    return {path: (t.detach().to("cpu", torch.float32) if
                   t.is_floating_point() else t.detach().cpu()).numpy()
            for path, t in params.items()}


def state_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Model.state`` tree (BatchNorm's running ``mean``
    and ``var``; leaves as numpy arrays) as the port's flat ``{path:
    tensor}`` state, in f32 on the CPU. Load it with ``Model.load_state``."""
    return params_from_jax(tree)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The port's ``{path: buffer}`` state (``Model.state``) as ``{path:
    f32 numpy array}``, under the paths ``flatten_tree`` gives a JAX state
    tree."""
    return params_to_numpy(state)


_FORMAT_ERROR = (
    "Checkpoint optimizer state has {got} leaves but this model's optimizer "
    "expects {want}. The optimizer-state FORMAT changed (named optimizers "
    "carry injected hyperparameters since round 4; gradient accumulation "
    "adds a MultiSteps accumulator) — or compile() used a different "
    "optimizer than the checkpointing run. To keep the weights, load "
    "params/state only (Model.load_weights on an exported file) and let "
    "the optimizer state reinitialize."
)


def _slots(tx) -> Dict[str, str]:
    """``{slot of the port's state: its optax path prefix}``."""
    if isinstance(tx, optim.SGD):
        return {"trace": "#3/#0/#0"} if "momentum" in tx.hyperparams else {}
    if isinstance(tx, optim.Adam):
        base = "#3" if tx.fused else "#3/#0"
        return {"count": f"{base}/#0", "mu": f"{base}/#1",
                "nu": f"{base}/#2"}
    if isinstance(tx, optim.Lamb):
        return {"count": "#3/#0/#0", "mu": "#3/#0/#1", "nu": "#3/#0/#2"}
    if isinstance(tx, optim.RMSprop):
        return {"nu": "#3/#0/#0", "trace": "#3/#2/#0"}
    if isinstance(tx, optim.Adagrad):
        return {"sum_of_squares": "#3/#0/#0"}
    raise ValueError(f"no optax layout for the optimizer {tx!r}")


def _fixed_hyperparams(tx) -> List[str]:
    """The hyperparameters optax holds and the port keeps at 0."""
    if isinstance(tx, optim.Adam):
        if not tx.fused:
            return ["eps_root"]
        if "weight_decay" not in tx.hyperparams:
            return ["weight_decay"]
    return []


def _expected_paths(tx, params, prefix="") -> List[str]:
    if isinstance(tx, optim.dynamic_loss_scaling):
        return ([f"{prefix}#0", f"{prefix}#1"]
                + _expected_paths(tx.inner, params, f"{prefix}#2{SEP}"))
    if isinstance(tx, optim.MultiSteps):
        return ([f"{prefix}#0", f"{prefix}#1"]
                + _expected_paths(tx.inner, params, f"{prefix}#2{SEP}")
                + [f"{prefix}#3{SEP}{p}" for p in params])
    if isinstance(tx, optim.chain):
        return _expected_paths(tx.inner, params,
                               f"{prefix}#{len(tx.maps)}{SEP}")
    if isinstance(tx, optim.sgd_with_cosine):
        return ([f"{prefix}#0{SEP}#0{SEP}{p}" for p in params]
                + [f"{prefix}#1{SEP}#0"])
    paths = [f"{prefix}#0"] + [f"{prefix}#1{SEP}{k}" for k in
                               list(tx.hyperparams) + _fixed_hyperparams(tx)]
    paths += [f"{prefix}#2{SEP}{k}{SEP}#0" for k in tx.schedules]
    for slot, path in _slots(tx).items():
        if slot == "count":
            paths.append(prefix + path)
        else:
            paths += [f"{prefix}{path}{SEP}{p}" for p in params]
    return paths


def _scalar(a):
    """A 0-d leaf (numpy, or a tensor on any device) as a Python number."""
    return a.item() if isinstance(a, torch.Tensor) else np.asarray(a).item()


def opt_state_to_tree(tx, opt_state: Dict, params: Dict[str, torch.Tensor]):
    """The port's optimizer state (``Model.opt_state`` of ``tx``, slots as
    lists in the order of ``params``, ``Model.params``) as optax's tree:
    ``(count, hyperparams, {}, inner)`` with the moments keyed by
    parameter path, nested in the wrappers' tuples. The moments are the
    state's own tensors (no copy); the counts are int32 and the
    hyperparameters f32 numpy scalars."""
    if isinstance(tx, optim.dynamic_loss_scaling):
        return (opt_state.scale, np.int32(opt_state.growth_count),
                opt_state_to_tree(tx.inner, opt_state.inner_state, params))
    if isinstance(tx, optim.MultiSteps):
        return (np.int32(opt_state["mini_step"]),
                np.int32(opt_state["gradient_step"]),
                opt_state_to_tree(tx.inner, opt_state["inner_opt_state"],
                                  params),
                dict(zip(params, opt_state["acc_grads"])), ())
    if isinstance(tx, optim.chain):
        return tuple(() for _ in tx.maps) + (
            opt_state_to_tree(tx.inner, opt_state[-1], params),)
    if isinstance(tx, optim.sgd_with_cosine):
        return ((dict(zip(params, opt_state["trace"])),),
                (np.int32(opt_state["count"]),))
    hp = {k: v.numpy() for k, v in opt_state["hyperparams"].items()}
    hp.update({k: np.float32(0.0) for k in _fixed_hyperparams(tx)})
    by_path = {s: dict(zip(params, opt_state[s])) for s in _slots(tx)
               if s != "count"}
    if isinstance(tx, optim.RMSprop):
        inner = ((by_path["nu"],), (), (by_path["trace"],))
    elif isinstance(tx, optim.Adagrad):
        inner = ((by_path["sum_of_squares"],), ())
    elif "trace" in by_path:
        inner = ((by_path["trace"],),)
    elif "mu" in by_path:
        adam = (np.int32(opt_state["count"]), by_path["mu"], by_path["nu"])
        inner = adam if getattr(tx, "fused", False) else (adam,)
    else:
        inner = ()
    sched = {k: (np.int32(opt_state["inject_count"]),) for k in tx.schedules}
    return (np.int32(opt_state["inject_count"]), hp, sched, inner)


def opt_state_from_tree(tx, tree, params: Dict[str, torch.Tensor],
                        layouts=None, blocks: bool = False) -> Dict:
    """The port's optimizer state for ``tx`` from optax's tree (as
    ``opt_state_to_tree`` writes it, or the flat ``{path: leaf}`` of a
    checkpoint of either package: any nesting whose leaf paths are
    optax's, with the gaps in its tuple numbers), the moments copied to f32 on
    the parameters' devices and matched to them by path. Raises the JAX
    package's format error when the leaf count differs, and ValueError
    for other paths, a moment of another shape or a fixed
    hyperparameter that is not 0. The state is built aside, so nothing
    changes on an error.

    ``layouts`` (``{parameter path: collectives.Layout or None}``, a
    sharded model's ``opt_layouts``): each moment is this rank's block of
    the full leaf in the tree (whose shape is checked against the
    layout's), or with ``blocks=True`` the tree already holds this rank's
    blocks."""
    flat = dict(iter_leaf_paths(tree))
    want = _expected_paths(tx, params)
    if len(flat) != len(want):
        raise ValueError(_FORMAT_ERROR.format(got=len(flat), want=len(want)))
    if set(flat) != set(want):
        raise ValueError(
            "optimizer-state paths differ: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    return _state_from_flat(tx, flat, params, "",
                            (layouts or {}, bool(blocks)))


def _moments(flat, prefix, params, placing):
    """The f32 copies of the leaves ``<prefix>/<p>`` on the parameters'
    devices, in the order of ``params`` (each this rank's block where
    ``placing`` gives the parameter a layout); a leaf of another shape
    raises."""
    layouts, blocks = placing
    out = []
    for path, p in params.items():
        a = flat[f"{prefix}{SEP}{path}"]
        lay = layouts.get(path)
        if lay is None:
            want = tuple(p.shape)
        else:
            want = lay.local_shape if blocks else lay.shape
        if tuple(a.shape) != want:
            raise ValueError(
                f"{prefix}{SEP}{path}: shape {tuple(a.shape)} != the "
                f"parameter's {want}")
        if lay is not None and not blocks:
            a = a[lay.index()]
        out.append(torch.as_tensor(a).to(p.device, torch.float32,
                                         copy=True).contiguous())
    return out


def _as_tensor(v) -> torch.Tensor:
    """A leaf as a tensor: a tensor as it is, on its own device (a
    multi-rank restore broadcasts the leaves on the card), else numpy's."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def place(model, params=None, opt_state=None, state=None) -> None:
    """Load full leaves, as numpy or tensors, into ``model`` under its
    live strategy: ``params`` (``{path: leaf}``, e.g. ``flatten_tree`` of
    a JAX ``Model.params``) into this rank's blocks (``load_params``),
    ``state`` into the state buffers, and ``opt_state`` (optax's tree or
    its flat ``{path: leaf}``, e.g. a JAX ``Model.opt_state`` after
    ``jax.device_get``) into the optimizer state, each statistic this
    rank's block where the strategy shards it."""
    opt = None
    if opt_state is not None:  # built aside: an error changes nothing
        opt = opt_state_from_tree(model.tx, opt_state, model.live_params(),
                                  layouts=model.opt_layouts)
    if params is not None:
        model.load_params({k: _as_tensor(v) for k, v in params.items()})
    if state is not None:
        model.load_state({k: _as_tensor(v) for k, v in state.items()})
    if opt is not None:
        model.opt_state = opt


def _state_from_flat(tx, flat, params, prefix, placing) -> Dict:
    if isinstance(tx, optim.dynamic_loss_scaling):
        device = next(iter(params.values())).device if params else None
        return optim.LossScaleState(
            torch.tensor(_scalar(flat[f"{prefix}#0"]), dtype=torch.float32,
                         device=device),
            int(_scalar(flat[f"{prefix}#1"])),
            _state_from_flat(tx.inner, flat, params, f"{prefix}#2{SEP}",
                             placing))
    if isinstance(tx, optim.MultiSteps):
        inner = _state_from_flat(tx.inner, flat, params, f"{prefix}#2{SEP}",
                                 placing)
        return {"mini_step": int(_scalar(flat[f"{prefix}#0"])),
                "gradient_step": int(_scalar(flat[f"{prefix}#1"])),
                "inner_opt_state": inner,
                "acc_grads": _moments(flat, f"{prefix}#3", params, placing),
                "skip_state": ()}
    if isinstance(tx, optim.chain):
        n = len(tx.maps)
        return tuple(() for _ in tx.maps) + (_state_from_flat(
            tx.inner, flat, params, f"{prefix}#{n}{SEP}", placing),)
    if isinstance(tx, optim.sgd_with_cosine):
        return {"trace": _moments(flat, f"{prefix}#0{SEP}#0", params,
                                  placing),
                "count": int(_scalar(flat[f"{prefix}#1{SEP}#0"]))}
    for k in _fixed_hyperparams(tx):
        value = _scalar(flat[f"{prefix}#1{SEP}{k}"])
        if value != 0.0:
            raise ValueError(
                f"optimizer hyperparameter {k}={value}: the port's "
                f"{type(tx).__name__} runs with {k} 0")
    slots = _slots(tx)
    moments = {s: prefix + path for s, path in slots.items() if s != "count"}
    state = {
        "inject_count": int(_scalar(flat[f"{prefix}#0"])),
        "hyperparams": {k: torch.tensor(_scalar(flat[f"{prefix}#1{SEP}{k}"]),
                                        dtype=torch.float32)
                        for k in tx.hyperparams},
    }
    if tx.schedules:
        state["scheduled"] = tuple(tx.schedules)
    if "count" in slots:
        state["count"] = int(_scalar(flat[prefix + slots["count"]]))
    for slot, path in moments.items():
        state[slot] = _moments(flat, path, params, placing)
    return state


__all__ = [
    "SEP", "flatten_tree", "iter_leaf_paths", "opt_state_from_tree",
    "opt_state_to_tree", "params_from_jax", "params_to_numpy", "place",
    "state_from_jax", "state_to_numpy",
]
