"""Optimizers with optax's arithmetic, operation for operation, in f32.

The JAX package builds its named optimizers through
``optax.inject_hyperparams``, so the numeric hyperparameters live in the
optimizer STATE as f32 scalars and ``Model.set_learning_rate`` can change
the learning rate between steps. The port keeps that contract: ``init``
returns a state dict whose ``"hyperparams"`` hold the values (rounded to
f32, as optax holds them), ``set_hyperparam``/``get_hyperparam`` read and
write them, and ``update`` applies one step IN PLACE to the parameters
and the moments (optax returns new trees; in place keeps one copy of the
state in device memory).

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

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=_F32)


class _Optimizer:
    """Base: hyperparameters as f32 scalars in the state, in-place update."""

    name = "optimizer"

    def __init__(self, **hyperparams):
        self.hyperparams = hyperparams

    def init(self, params: List[torch.Tensor]) -> Dict:
        state = {"hyperparams": {k: _f32(v) for k, v in
                                 self.hyperparams.items()}}
        state.update(self._init_slots(params))
        return state

    def _init_slots(self, params):
        return {}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> None:
        """One step: ``params`` and the state's slots change in place."""
        raise NotImplementedError


class SGD(_Optimizer):
    """optax.sgd without momentum: ``p += -lr * g``."""

    name = "sgd"

    def __init__(self, learning_rate: float = 0.001):
        super().__init__(learning_rate=learning_rate)

    @torch.no_grad()
    def update(self, params, grads, state):
        step = (-state["hyperparams"]["learning_rate"]).item()
        for p, g in zip(params, grads):
            p.add_(g.to(_F32) * step)


class Adam(_Optimizer):
    """optax.adam (eps_root 0, no Nesterov), under inject_hyperparams."""

    name = "adam"

    def __init__(self, learning_rate: float = 0.001, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps)

    def _init_slots(self, params):
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=_F32) for p in params],
            "nu": [torch.zeros_like(p, dtype=_F32) for p in params],
        }

    @torch.no_grad()
    def update(self, params, grads, state):
        hp = state["hyperparams"]
        one = _f32(1.0)
        b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
        state["count"] += 1
        count = torch.tensor(state["count"], dtype=_F32)
        # Scalars computed in f32, as optax computes them on its f32
        # hyperparameter arrays; .item() hands the exact f32 value on.
        c1, c2 = (one - b1).item(), (one - b2).item()
        bc1 = (one - b1 ** count).item()
        bc2 = (one - b2 ** count).item()
        neg_lr = (-hp["learning_rate"]).item()
        b1, b2, eps = b1.item(), b2.item(), eps.item()
        mus, nus = state["mu"], state["nu"]
        g = [x.to(_F32) for x in grads]
        # mu = (1 - b1) * g + b1 * mu
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(g, c1))
        # nu = (1 - b2) * g**2 + b2 * nu
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(g, g), c2))
        # update = mu_hat / (sqrt(nu_hat + 0) + eps), scaled by -lr
        mu_hat = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(params, upd)


_REGISTRY = {"sgd": SGD, "adam": Adam}


def get(name_or_opt, **kwargs) -> _Optimizer:
    """An optimizer from its name (``"adam"``, ``"sgd"``; ``kwargs`` go to
    its constructor) or an optimizer instance as is."""
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


__all__ = ["Adam", "SGD", "get", "get_hyperparam", "set_hyperparam"]
