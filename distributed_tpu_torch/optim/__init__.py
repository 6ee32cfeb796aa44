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
plain tensor code, as optax's is a tree walk and no Pallas kernel; the
fused Adam kernel (``optim.fused_adam``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..ops import fused_update

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=_F32)


class _Optimizer:
    """Base: hyperparameters as f32 scalars in the state, in-place update."""

    name = "optimizer"

    def __init__(self, **hyperparams):
        self.hyperparams = hyperparams

    def init(self, params: List[torch.Tensor]) -> Dict:
        state = {"inject_count": 0,
                 "hyperparams": {k: _f32(v) for k, v in
                                 self.hyperparams.items()}}
        state.update(self._init_slots(params))
        return state

    def _init_slots(self, params):
        return {}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> None:
        """One step: ``params`` and the state's slots change in place."""
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


_REGISTRY = {
    "sgd": SGD, "adam": Adam, "adamw": AdamW, "fused_adam": fused_adam,
    "fused_adamw": fused_adamw,
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

    def update(self, observed: float) -> float:
        """Fold one observation in; returns the new value."""
        r = float(observed)
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


def get(name_or_opt, **kwargs) -> _Optimizer:
    """An optimizer from its name (``"sgd"``, ``"adam"``, ``"adamw"``,
    ``"fused_adam"``, ``"fused_adamw"``; ``kwargs`` go to its
    constructor) or an optimizer instance as is."""
    if isinstance(name_or_opt, _Optimizer):
        return name_or_opt
    try:
        return _REGISTRY[str(name_or_opt).lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"Unknown optimizer {name_or_opt!r}; known: {sorted(_REGISTRY)}"
        ) from None


def set_hyperparam(opt_state: Dict, name: str, value) -> Dict:
    """Replace injected hyperparameter ``name`` (e.g. 'learning_rate') in
    ``opt_state``, rounded to f32 as optax holds it; returns the state."""
    hp = opt_state["hyperparams"]
    if name not in hp:
        raise KeyError(f"optimizer state carries no hyperparameter {name!r}")
    hp[name] = _f32(value)
    return opt_state


def get_hyperparam(opt_state: Dict, name: str) -> float:
    hp = opt_state["hyperparams"]
    if name not in hp:
        raise KeyError(f"optimizer state carries no hyperparameter {name!r}")
    return hp[name].item()


__all__ = [
    "Adam", "AdamW", "EmaBaseline", "SGD", "fused_adam", "fused_adamw", "get",
    "get_hyperparam", "set_hyperparam",
]
