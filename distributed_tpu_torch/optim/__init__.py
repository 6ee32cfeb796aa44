"""Optimizers with optax's arithmetic, operation for operation, in f32.

The JAX package builds its named optimizers through
``optax.inject_hyperparams``, so the numeric hyperparameters live in the
optimizer STATE as f32 scalars and ``Model.set_learning_rate`` can change
the learning rate between steps. The port keeps that contract: ``init``
returns a state dict whose ``"hyperparams"`` hold the values (rounded to
f32, as optax holds them) and whose ``"inject_count"`` counts the updates
(the wrapper's own step count), ``set_hyperparam``/``get_hyperparam`` read
and write them, and ``update`` applies one step IN PLACE to the parameters
and the moments (optax returns new trees; in place keeps one copy of the
state in device memory). ``interop.opt_state_to_tree`` writes the state
under optax's tree paths, so a checkpoint carries it to the JAX package.

Adam is optax's ``scale_by_adam`` followed by ``scale(-learning_rate)``
and ``apply_updates``: ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g*g +
b2*nu``, ``count += 1``, ``mu_hat = mu / (1 - b1**count)``, ``nu_hat =
nu / (1 - b2**count)``, ``p += -lr * (mu_hat / (sqrt(nu_hat + 0) +
eps))``. ``torch.optim.Adam`` rounds differently and is not used. This is
plain tensor code, as optax's is a tree walk and no Pallas kernel;
``fused_adam``/``fused_adamw`` run the update as the fused kernel K11.

``Model.compile(grad_clip=, gradient_accumulation_steps=)`` wraps the
optimizer as the JAX package does: ``chain(clip_by_global_norm(c), tx)``
inside ``MultiSteps(..., every_k_schedule=N)``, with optax's arithmetic
and optax's state layout (``interop`` writes it under optax's paths).
``set_hyperparam``/``get_hyperparam`` reach through the wrappers.
``compile(precision="mixed_float16")`` wraps the result, outermost, in
``dynamic_loss_scaling`` (its state ``LossScaleState``), as there.

``RMSprop``, ``Adagrad`` and ``Lamb`` are the JAX package's
``inject_hyperparams`` of ``optax.rmsprop``/``adagrad``/``lamb``, with
optax's arithmetic (its source, 0.2.6): RMSprop ``nu = (1-decay)*g*g +
decay*nu``, ``u = rsqrt(nu + eps) * g`` (eps inside the root),
``u *= -lr``, then the momentum trace ``t = u + momentum*t`` (kept at
momentum 0 too), ``p += t``; Adagrad's accumulator starts at
``initial_accumulator_value`` (0.1) and ``u = rsqrt(s + eps) * g`` where
``s > 0``, else 0; Lamb is Adam (its own ``eps`` 1e-6) plus
``weight_decay * p``, scaled by the trust ratio ``||p|| / ||u||``, which
is 1 where either norm is 0. inject_hyperparams holds every numeric
default of the factory as well (RMSprop's ``initial_scale``, Adagrad's
``initial_accumulator_value``, Lamb's ``eps`` and ``eps_root``), so the
state does too.

Schedules (``cosine_schedule``, ``exponential_schedule``: optax's
warmup-cosine and exponential decays, in f32 as optax computes them) are
callables of the step count; given as an optimizer's ``learning_rate``
they are evaluated at the update's count before each update, as
inject_hyperparams does, and the value is kept in the state.
``sgd_with_cosine`` is the JAX package's plain (not injected)
``optax.sgd`` over a cosine schedule.

Under the sharded strategies (``parallel.strategy``) an update receives
each rank's blocks of the sharded leaves. The quantities that span a leaf
or the whole tree, the clip's global norm, Lamb's trust ratio and the loss
scale's finite check, are then made from per-leaf partial sums that the
strategy sums over the ranks, a replicated leaf counted once
(:func:`leaf_reduction`, :func:`_leaf_sums`); without a reduction the
sums are the local ones, the same arithmetic. The state's per-parameter
slots (``trace``, ``mu``, ``nu``, ``sum_of_squares``, ``acc_grads``) are
lists in the parameters' order, which :func:`map_slots` walks.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List

import numpy as np
import torch

from ..ops import fused_update

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=_F32)


_REDUCTION = threading.local()


@contextlib.contextmanager
def leaf_reduction(reduce):
    """Within the block, ``reduce(values) -> values`` sums per-leaf
    partials (0-d tensors, one per leaf of the update's lists) over the
    ranks that hold the leaves' blocks (``parallel.strategy``)."""
    prev = getattr(_REDUCTION, "fn", None)
    _REDUCTION.fn = reduce
    try:
        yield
    finally:
        _REDUCTION.fn = prev


def _leaf_sums(values: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-leaf partial sums, summed over the ranks under a
    :func:`leaf_reduction` (as they are without one)."""
    fn = getattr(_REDUCTION, "fn", None)
    return values if fn is None or not values else fn(values)


def map_slots(state, fn):
    """A copy of an optimizer state with every per-parameter slot list
    replaced by ``[fn(i, t) for i, t in enumerate(slot)]`` (i: the
    parameter's index), through the wrappers' states; the counts,
    hyperparameters and the loss scale are kept as they are."""
    if isinstance(state, LossScaleState):
        return LossScaleState(state.scale, state.growth_count,
                              map_slots(state.inner_state, fn))
    if isinstance(state, tuple):
        return tuple(map_slots(sub, fn) for sub in state)
    if isinstance(state, dict):
        return {k: ([fn(i, t) for i, t in enumerate(v)]
                    if isinstance(v, list) else
                    map_slots(v, fn) if k == "inner_opt_state" else v)
                for k, v in state.items()}
    return state


# ------------------------------------------------------------- schedules
# optax's schedules on an int32 step count, evaluated in f32 in optax's
# order of operations (numpy float32 scalars).
_N32 = np.float32


def _linear(init_value, end_value, steps):
    def schedule(count):
        if steps <= 0:
            return _N32(init_value)
        c = min(max(int(count), 0), steps)
        frac = _N32(1) - _N32(c) / _N32(steps)
        return _N32(_N32(init_value) - _N32(end_value)) * frac + _N32(
            end_value)

    return schedule


def _cosine(init_value, decay_steps, alpha=0.0):
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = np.minimum(_N32(count), _N32(decay_steps))
        cos = _N32(0.5) * (_N32(1) + np.cos(_N32(math.pi) * c
                                            / _N32(decay_steps)))
        decayed = _N32(1 - alpha) * cos + _N32(alpha)
        return _N32(init_value) * decayed

    return schedule


def _exponential(init_value, transition_steps, decay_rate):
    def schedule(count):
        if transition_steps <= 0 or decay_rate == 0:
            return _N32(init_value)
        p = _N32(int(count)) / _N32(transition_steps)
        if int(count) <= 0:
            return _N32(init_value)
        return _N32(init_value) * np.power(_N32(decay_rate), p)

    return schedule


def _join(first, second, boundary):
    def schedule(count):
        return first(count) if count < boundary else second(count - boundary)

    return schedule


def cosine_schedule(learning_rate: float, steps: int, warmup: int = 0):
    """Warmup-then-cosine decay: optax's ``warmup_cosine_decay_schedule(0,
    learning_rate, max(warmup, 1), max(steps, warmup + 1))``; pass it as
    any optimizer's ``learning_rate``."""
    w = max(warmup, 1)
    return _join(_linear(0.0, learning_rate, w),
                 _cosine(learning_rate, max(steps, warmup + 1) - w), w)


def exponential_schedule(learning_rate: float, decay_rate: float,
                         decay_steps: int, warmup: int = 0):
    """``learning_rate * decay_rate ** (step / decay_steps)``, after a
    linear warmup from 0 over ``warmup`` steps when given (optax's
    ``exponential_decay`` / ``warmup_exponential_decay_schedule``)."""
    decay = _exponential(learning_rate, decay_steps, decay_rate)
    if warmup:
        return _join(_linear(0.0, learning_rate, warmup), decay, warmup)
    return decay


class _Transform:
    """Base of every transform: ``init(params)`` makes its state,
    ``update(params, grads, state)`` applies one step in place."""

    def init(self, params: List[torch.Tensor]):
        raise NotImplementedError

    def update(self, params, grads, state) -> None:
        raise NotImplementedError


class _Optimizer(_Transform):
    """Base: hyperparameters as f32 scalars in the state, in-place update.
    A callable hyperparameter (a schedule) is evaluated at the update's
    count before each update and its value kept in the state, as
    ``optax.inject_hyperparams`` does."""

    name = "optimizer"

    def __init__(self, **hyperparams):
        self.hyperparams = hyperparams
        self.schedules = {k: v for k, v in hyperparams.items()
                          if callable(v)}

    def init(self, params: List[torch.Tensor]) -> Dict:
        state = {"inject_count": 0,
                 "hyperparams": {k: _f32(v(0) if callable(v) else v)
                                 for k, v in self.hyperparams.items()}}
        if self.schedules:
            state["scheduled"] = tuple(self.schedules)
        state.update(self._init_slots(params))
        return state

    def _init_slots(self, params):
        return {}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> None:
        """One step: ``params`` and the state's slots change in place."""
        for k, fn in self.schedules.items():
            state["hyperparams"][k] = _f32(fn(state["inject_count"]))
        state["inject_count"] += 1
        self._apply(params, grads, state)

    def _apply(self, params, grads, state) -> None:
        raise NotImplementedError


class SGD(_Optimizer):
    """optax.sgd: ``p += -lr * g``; with ``momentum``, optax's trace
    first: ``t = g + momentum * t``, the update ``t`` (Nesterov: ``g +
    momentum * t``)."""

    name = "sgd"

    def __init__(self, learning_rate: float = 0.001, momentum: float = 0.0,
                 nesterov: bool = False):
        # As in the JAX package, momentum 0 builds plain optax.sgd: no
        # trace in the state and no momentum hyperparameter.
        hp = dict(learning_rate=learning_rate)
        if momentum:
            hp["momentum"] = momentum
        super().__init__(**hp)
        self.nesterov = bool(nesterov)

    def _init_slots(self, params):
        if "momentum" not in self.hyperparams:
            return {}
        return {"trace": [torch.zeros_like(p, dtype=_F32) for p in params]}

    def _apply(self, params, grads, state):
        hp = state["hyperparams"]
        step = (-hp["learning_rate"]).item()
        if "momentum" not in hp:
            for p, g in zip(params, grads):
                p.add_(g.to(_F32) * step)
            return
        mom = hp["momentum"].item()
        g = [x.to(_F32) for x in grads]
        trace = state["trace"]
        torch._foreach_mul_(trace, mom)
        torch._foreach_add_(trace, g)
        upd = (torch._foreach_add(g, torch._foreach_mul(trace, mom))
               if self.nesterov else trace)
        torch._foreach_add_(params, torch._foreach_mul(upd, step))


class Adam(_Optimizer):
    """optax.adam (eps_root 0, no Nesterov), under inject_hyperparams: the
    ``torch._foreach_*`` walk of ``ops.fused_update.adam_update_ref``."""

    name = "adam"
    #: True: the update runs K11 (``ops.fused_update``) on CUDA tensors.
    fused = False

    def __init__(self, learning_rate: float = 0.001, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps)

    def _init_slots(self, params):
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=_F32) for p in params],
            "nu": [torch.zeros_like(p, dtype=_F32) for p in params],
        }

    def _scalars(self, state) -> fused_update.AdamScalars:
        """Advance the step count and compute the update's scalars in f32,
        as optax computes them on its f32 hyperparameter arrays; .item()
        hands each exact f32 value on."""
        hp = state["hyperparams"]
        one = _f32(1.0)
        b1, b2 = hp["b1"], hp["b2"]
        state["count"] += 1
        count = torch.tensor(state["count"], dtype=_F32)
        wd = hp.get("weight_decay")
        return fused_update.AdamScalars(
            neg_lr=(-hp["learning_rate"]).item(), b1=b1.item(),
            b2=b2.item(), c1=(one - b1).item(), c2=(one - b2).item(),
            eps=hp["eps"].item(), wd=0.0 if wd is None else wd.item(),
            bc1=(one - b1 ** count).item(), bc2=(one - b2 ** count).item(),
        )

    def _apply(self, params, grads, state):
        step = (fused_update.adam_update if self.fused
                else fused_update.adam_update_ref)
        step(params, grads, state["mu"], state["nu"], self._scalars(state))


class AdamW(Adam):
    """optax.adamw: ``scale_by_adam``, then ``add_decayed_weights``
    (``u + wd * p``), then ``scale(-lr)``. The ``foreach`` walk on every
    device, as optax's AdamW is no Pallas kernel."""

    name = "adamw"

    def __init__(self, learning_rate: float = 0.001,
                 weight_decay: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        _Optimizer.__init__(self, learning_rate=learning_rate, b1=b1, b2=b2,
                            eps=eps, weight_decay=weight_decay)


class fused_adam(Adam):
    """Adam whose update runs as the fused kernel K11 on CUDA tensors
    (``ops.fused_update``; the plain version on CPU tensors): the same
    arithmetic as :class:`Adam`, bit for bit."""

    name = "fused_adam"
    fused = True


class fused_adamw(AdamW):
    """AdamW through the fused kernel K11: the decay term folds into the
    same pass. The same arithmetic as :class:`AdamW`, bit for bit."""

    name = "fused_adamw"
    fused = True


class RMSprop(_Optimizer):
    """optax.rmsprop under inject_hyperparams (module docstring): ``nu``
    starts at ``initial_scale`` (0), the momentum trace at 0."""

    name = "rmsprop"

    def __init__(self, learning_rate: float = 0.001, decay: float = 0.9,
                 momentum: float = 0.0, eps: float = 1e-7):
        super().__init__(learning_rate=learning_rate, decay=decay, eps=eps,
                         initial_scale=0.0, momentum=momentum)

    def _init_slots(self, params):
        init = _f32(self.hyperparams["initial_scale"]).item()
        return {"nu": [torch.full_like(p, init, dtype=_F32) for p in params],
                "trace": [torch.zeros_like(p, dtype=_F32) for p in params]}

    def _apply(self, params, grads, state):
        hp = state["hyperparams"]
        decay = hp["decay"]
        c = (_f32(1.0) - decay).item()
        g = [x.to(_F32) for x in grads]
        nu = state["nu"]
        torch._foreach_mul_(nu, decay.item())
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   c))
        upd = torch._foreach_add(nu, hp["eps"].item())
        torch._foreach_rsqrt_(upd)
        torch._foreach_mul_(upd, g)
        torch._foreach_mul_(upd, (-hp["learning_rate"]).item())
        trace = state["trace"]
        torch._foreach_mul_(trace, hp["momentum"].item())
        torch._foreach_add_(trace, upd)
        torch._foreach_add_(params, trace)


class Adagrad(_Optimizer):
    """optax.adagrad under inject_hyperparams: ``s += g*g`` from
    ``initial_accumulator_value``, ``u = rsqrt(s + eps) * g`` where ``s >
    0`` (else 0), ``p += u * -lr``."""

    name = "adagrad"

    def __init__(self, learning_rate: float = 0.001, eps: float = 1e-7):
        super().__init__(learning_rate=learning_rate, eps=eps,
                         initial_accumulator_value=0.1)

    def _init_slots(self, params):
        init = _f32(self.hyperparams["initial_accumulator_value"]).item()
        return {"sum_of_squares": [torch.full_like(p, init, dtype=_F32)
                                   for p in params]}

    def _apply(self, params, grads, state):
        hp = state["hyperparams"]
        eps, neg_lr = hp["eps"].item(), (-hp["learning_rate"]).item()
        for p, g, acc in zip(params, grads, state["sum_of_squares"]):
            g = g.to(_F32)
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + eps),
                              torch.zeros_like(acc))
            p.add_((inv * g) * neg_lr)


class Lamb(_Optimizer):
    """optax.lamb under inject_hyperparams: Adam's moments and bias
    correction (``eps`` 1e-6, ``eps_root`` 0), ``u += weight_decay * p``,
    ``u *= ||p|| / ||u||`` (1 where either norm is 0), ``p += u * -lr``."""

    name = "lamb"

    def __init__(self, learning_rate: float = 0.001,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999):
        super().__init__(learning_rate=learning_rate, b1=b1, b2=b2,
                         eps=1e-6, eps_root=0.0, weight_decay=weight_decay)

    def _init_slots(self, params):
        return Adam._init_slots(self, params)

    def _apply(self, params, grads, state):
        s = Adam._scalars(self, state)
        g = [x.to(_F32) for x in grads]
        mus, nus = state["mu"], state["nu"]
        torch._foreach_mul_(mus, s.b1)
        torch._foreach_add_(mus, torch._foreach_mul(g, s.c1))
        torch._foreach_mul_(nus, s.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(g, g),
                                                    s.c2))
        mu_hat = torch._foreach_div(mus, [s.bc1] * len(mus))
        den = torch._foreach_div(nus, [s.bc2] * len(nus))
        torch._foreach_add_(den, state["hyperparams"]["eps_root"].item())
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, s.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, s.wd))
        # Each leaf's norms from its squares' sum (optax's safe_norm),
        # summed over the ranks' blocks under a sharded strategy.
        sq = _leaf_sums([torch.sum(p * p) for p in params]
                        + [torch.sum(u * u) for u in upd])
        for p, u, ps, us in zip(params, upd, sq[:len(params)],
                                sq[len(params):]):
            pn, un = torch.sqrt(ps), torch.sqrt(us)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            p.add_((u * ratio) * s.neg_lr)


class sgd_with_cosine(_Transform):
    """The JAX package's ``sgd_with_cosine``: plain ``optax.sgd`` (not
    injected) over :func:`cosine_schedule`: the trace ``t = g +
    momentum * t``, then ``p += -schedule(count) * t``. Its state is
    optax's: the trace, then the schedule's step count."""

    name = "sgd_with_cosine"

    def __init__(self, learning_rate: float, steps: int, warmup: int = 0,
                 momentum: float = 0.9):
        self.schedule = cosine_schedule(learning_rate, steps, warmup)
        self.momentum = float(momentum)

    def init(self, params):
        return {"trace": [torch.zeros_like(p, dtype=_F32) for p in params],
                "count": 0}

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        trace = state["trace"]
        torch._foreach_mul_(trace, _f32(self.momentum).item())
        torch._foreach_add_(trace, [g.to(_F32) for g in grads])
        step = float(-self.schedule(state["count"]))
        torch._foreach_add_(params, torch._foreach_mul(trace, step))
        state["count"] += 1


class clip_by_global_norm:
    """optax.clip_by_global_norm: every gradient scaled by ``max_norm /
    norm`` when the global norm ``sqrt(sum of every entry squared)`` is
    not below ``max_norm``. A gradient map with no state, for
    :class:`chain`; the norm stays a device scalar (no host sync)."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    @torch.no_grad()
    def __call__(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum(_leaf_sums([torch.sum(g * g) for g in grads])))
        keep = norm < self.max_norm
        return [torch.where(keep, g, (g / norm.to(g.dtype)) * self.max_norm)
                for g in grads]


class chain(_Transform):
    """optax.chain of gradient maps (``clip_by_global_norm``) and one
    optimizer, last. The state is optax's tuple: an empty state for each
    map, then the optimizer's."""

    def __init__(self, *transforms):
        *self.maps, self.inner = transforms
        if not isinstance(self.inner, _Transform) or any(
                isinstance(t, _Transform) for t in self.maps):
            raise ValueError("chain(...) takes gradient maps, then one "
                             "optimizer")

    def init(self, params):
        return tuple(() for _ in self.maps) + (self.inner.init(params),)

    def update(self, params, grads, state) -> None:
        for fn in self.maps:
            grads = fn(grads)
        self.inner.update(params, grads, state[-1])


class MultiSteps(_Transform):
    """optax.MultiSteps(tx, every_k_schedule=k) with the gradient mean:
    each call folds the gradients into a running mean (Welford's ``acc +=
    (g - acc) / (mini_step + 1)``, in f32), and every k-th call hands the
    mean to ``tx``, zeroes it and advances ``gradient_step``; the other
    calls leave the parameters as they are. The state is optax's
    ``MultiStepsState``: ``mini_step``, ``gradient_step``,
    ``inner_opt_state``, ``acc_grads``, ``skip_state`` (empty)."""

    def __init__(self, tx: _Transform, every_k_schedule: int):
        if not isinstance(every_k_schedule, int) or every_k_schedule < 1:
            raise ValueError("every_k_schedule must be an integer >= 1 (a "
                             "schedule function is not ported)")
        self.inner = tx
        self.k = every_k_schedule

    def init(self, params):
        return {"mini_step": 0, "gradient_step": 0,
                "inner_opt_state": self.inner.init(params),
                "acc_grads": [torch.zeros_like(p, dtype=_F32)
                              for p in params],
                "skip_state": ()}

    @torch.no_grad()
    def update(self, params, grads, state) -> None:
        acc = state["acc_grads"]
        n = state["mini_step"]
        # Divided by a list of scalars: a Python scalar divides by its
        # reciprocal's product on CUDA (see the module docstring).
        torch._foreach_add_(acc, torch._foreach_div(
            torch._foreach_sub([g.to(_F32) for g in grads], acc),
            [float(n + 1)] * len(acc)))
        if n == self.k - 1:
            self.inner.update(params, acc, state["inner_opt_state"])
            torch._foreach_zero_(acc)
            state["mini_step"] = 0
            state["gradient_step"] += 1
        else:
            state["mini_step"] = n + 1


class LossScaleState:
    """State of :func:`dynamic_loss_scaling`, optax's ``LossScaleState``
    fields: ``scale`` (the live scale, an f32 device scalar changed in
    place, so a CUDA graph that captured the loss's product with it reads
    the new value at every replay), ``growth_count`` (finite steps since
    the scale last changed) and ``inner_state`` (the wrapped transform's).
    Outermost, as in the JAX package: ``interop`` writes it as optax's
    tuple (``#0`` scale, ``#1`` count, ``#2/...`` the inner state)."""

    __slots__ = ("scale", "growth_count", "inner_state")

    def __init__(self, scale, growth_count, inner_state):
        self.scale = scale
        self.growth_count = growth_count
        self.inner_state = inner_state


class dynamic_loss_scaling(_Transform):
    """Dynamic loss scaling around ``inner``, the JAX package's wrapper
    (float16 training). The model's step multiplies the loss by
    ``state.scale`` before the backward, so the gradients here are scaled.
    ``update``: unscale them (times ``1 / scale``, in f32), check every
    entry is finite, and then

    - finite: apply ``inner`` to the unscaled gradients; after
      ``growth_interval`` finite steps in a row the scale grows by
      ``factor``;
    - not finite: skip the step — parameters, moments and counts stay as
      they were — and the scale shrinks by ``factor`` (not below
      ``min_scale``).

    JAX computes both branches and selects element by element; the port's
    update is in place and its counts are host integers, so the check is
    read on the host (one device-to-host read a step, as
    ``torch.amp.GradScaler`` reads its own) and the skipped branch never
    runs: the same result."""

    def __init__(self, inner, *, init_scale: float = 2.0 ** 15,
                 growth_interval: int = 2000, factor: float = 2.0,
                 min_scale: float = 1.0):
        self.inner = get(inner)
        self.init_scale = float(init_scale)
        self.growth_interval = int(growth_interval)
        self.factor = float(factor)
        self.min_scale = float(min_scale)

    def init(self, params):
        device = params[0].device if params else None
        return LossScaleState(
            torch.tensor(self.init_scale, dtype=_F32, device=device), 0,
            self.inner.init(params))

    @torch.no_grad()
    def update(self, params, grads, state: LossScaleState) -> None:
        scale = state.scale
        inv = torch.ones_like(scale) / scale
        unscaled = [(g.to(_F32) * inv).to(g.dtype) for g in grads]
        # Non-finite entries per leaf, summed over the ranks' blocks, so
        # that every rank takes the same branch.
        bad = sum(_leaf_sums([(~torch.isfinite(g)).sum().to(_F32)
                              for g in unscaled]))
        factor = torch.full_like(scale, self.factor)
        if not bool(bad):
            self.inner.update(params, unscaled, state.inner_state)
            grown = state.growth_count + 1
            if grown >= self.growth_interval:
                scale.copy_(scale * factor)
                state.growth_count = 0
            else:
                state.growth_count = grown
        else:
            scale.copy_(torch.clamp_min(scale / factor, self.min_scale))
            state.growth_count = 0


def loss_scale_value(opt_state):
    """The live loss scale (a device scalar) of an optimizer state built
    through :func:`dynamic_loss_scaling`, which is always outermost; None
    when no loss scaling is active."""
    if isinstance(opt_state, LossScaleState):
        return opt_state.scale
    return None


_REGISTRY = {
    "sgd": SGD, "adam": Adam, "adamw": AdamW, "fused_adam": fused_adam,
    "fused_adamw": fused_adamw, "rmsprop": RMSprop, "adagrad": Adagrad,
    "lamb": Lamb,
}


class EmaBaseline:
    """Exponential moving average of a host-side scalar, as the JAX
    package's ``optim.EmaBaseline``: the serving engine's per-tenant
    accept-rate EMA (adaptive speculative k). The first update adopts the
    observed value outright; ``state_dict``/``load_state`` round-trip it."""

    def __init__(self, decay: float = 0.9):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1); got {decay}")
        self.decay = float(decay)
        self.value = None  # None until the first update (cold start)

    def update(self, reward_mean: float) -> float:
        """Fold one observation in; returns the new value."""
        r = float(reward_mean)
        if self.value is None:
            self.value = r
        else:
            self.value = self.decay * self.value + (1.0 - self.decay) * r
        return self.value

    def state_dict(self):
        return {"decay": self.decay, "value": self.value}

    def load_state(self, state):
        self.decay = float(state["decay"])
        self.value = None if state["value"] is None else float(state["value"])



class AdaptiveKLCoef:
    """PPO-style adaptive KL-penalty coefficient (Schulman et al., 2017),
    as the JAX package's ``optim.AdaptiveKLCoef``: after each policy
    update, grow the coefficient when the observed policy-vs-reference KL
    overshoots ``target`` and shrink it when the policy moves too timidly.
    ``rl.PostTrainer`` accepts an instance wherever a fixed ``kl_coef``
    float goes and calls ``update`` with the measured post-update KL each
    iteration."""

    def __init__(self, init_coef: float = 0.1, target: float = 0.01,
                 factor: float = 1.5, tolerance: float = 1.5):
        if init_coef < 0 or target <= 0 or factor <= 1 or tolerance < 1:
            raise ValueError(
                "need init_coef >= 0, target > 0, factor > 1, "
                f"tolerance >= 1; got {init_coef}, {target}, {factor}, "
                f"{tolerance}"
            )
        self.coef = float(init_coef)
        self.target = float(target)
        self.factor = float(factor)
        self.tolerance = float(tolerance)

    def update(self, observed_kl: float) -> float:
        """Adapt to one iteration's measured KL; returns the new coef."""
        kl = float(observed_kl)
        if kl > self.target * self.tolerance:
            self.coef *= self.factor
        elif kl < self.target / self.tolerance:
            self.coef /= self.factor
        return self.coef

    def state_dict(self):
        return {"coef": self.coef, "target": self.target,
                "factor": self.factor, "tolerance": self.tolerance}

    def load_state(self, state):
        self.coef = float(state["coef"])
        self.target = float(state["target"])
        self.factor = float(state["factor"])
        self.tolerance = float(state["tolerance"])

def get(name_or_tx, **kwargs) -> _Transform:
    """An optimizer from its name (``"sgd"``, ``"adam"``, ``"adamw"``,
    ``"fused_adam"``, ``"fused_adamw"``, ``"rmsprop"``, ``"adagrad"``,
    ``"lamb"``; ``kwargs`` go to its constructor) or an optimizer instance
    as is."""
    if isinstance(name_or_tx, _Transform):
        return name_or_tx
    try:
        return _REGISTRY[str(name_or_tx).lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {name_or_tx!r}; known: {sorted(_REGISTRY)}"
        ) from None


def _hyperparams(opt_state, name: str) -> Dict:
    """The ``hyperparams`` dict holding ``name``, searched through the
    wrappers' states (``chain``'s tuple, ``MultiSteps``' inner state)."""
    if isinstance(opt_state, LossScaleState):
        return _hyperparams(opt_state.inner_state, name)
    if isinstance(opt_state, dict):
        hp = opt_state.get("hyperparams")
        if isinstance(hp, dict) and name in hp:
            return hp
        inner = opt_state.get("inner_opt_state")
        if inner is not None:
            return _hyperparams(inner, name)
    elif isinstance(opt_state, tuple):
        for sub in opt_state:
            try:
                return _hyperparams(sub, name)
            except KeyError:
                pass
    raise KeyError(f"optimizer state carries no hyperparameter {name!r}")


def set_hyperparam(opt_state: Dict, name: str, value) -> Dict:
    """Replace injected hyperparameter ``name`` (e.g. 'learning_rate') in
    ``opt_state``, rounded to f32 as optax holds it, searching through
    chained and accumulating states; returns the state. A schedule-driven
    hyperparameter raises ValueError (the schedule would overwrite it),
    as in the JAX package."""
    _scheduled(opt_state, name)
    _hyperparams(opt_state, name)[name] = _f32(value)
    return opt_state


def _scheduled(opt_state, name: str) -> None:
    if isinstance(opt_state, LossScaleState):
        return _scheduled(opt_state.inner_state, name)
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            _scheduled(sub, name)
    elif isinstance(opt_state, dict):
        if name in opt_state.get("scheduled", ()):
            raise ValueError(
                f"hyperparameter {name!r} is driven by a schedule; it "
                "cannot be set")
        if "inner_opt_state" in opt_state:
            _scheduled(opt_state["inner_opt_state"], name)


def get_hyperparam(opt_state: Dict, name: str) -> float:
    return _hyperparams(opt_state, name)[name].item()


__all__ = [
    "Adagrad", "Adam", "AdamW", "AdaptiveKLCoef", "EmaBaseline", "Lamb",
    "LossScaleState",
    "MultiSteps", "RMSprop", "SGD", "chain", "clip_by_global_norm",
    "cosine_schedule", "dynamic_loss_scaling", "exponential_schedule",
    "fused_adam", "fused_adamw", "get", "get_hyperparam", "leaf_reduction",
    "loss_scale_value", "map_slots", "set_hyperparam", "sgd_with_cosine",
]
