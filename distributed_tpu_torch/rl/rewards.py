"""Reward functions for online post-training (``rl.PostTrainer``).

The port's copy of the JAX package's ``rl/rewards.py`` (pure numpy), the
same rewards for the same inputs.

The plug-in contract is one callable per completed rollout::

    reward_fn(prompt, completion, logprobs) -> float

- ``prompt``: the request's prompt tokens, 1-D int array.
- ``completion``: the generated tokens (prompt excluded), 1-D int array —
  may be shorter than ``max_new_tokens`` when decode hit ``eos_id``.
- ``logprobs``: the engine-captured sampling logprob of each completion
  token (1-D float, index-aligned with ``completion``; see
  ``serving.Engine.run(return_logprobs=True)``).

Anything with this signature plugs in: a learned preference model's
forward pass, a programmatic verifier (tests passed / answer matched), a
human-label lookup. The two shipped rewards are deliberately tiny — they
exist so the closed loop (rollout -> score -> train -> hot-swap) can be
exercised and benchmarked end-to-end without an external scorer, not
because either is a production objective.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["length_penalized_logprob", "ToyPreferenceModel", "get"]


def length_penalized_logprob(length_coef: float = 0.01,
                             target_len: Optional[int] = None):
    """Reward = mean sampling logprob of the completion, minus a length
    penalty: ``length_coef * |len - target_len|`` when ``target_len`` is
    given, else ``length_coef * len``. Maximizing mean logprob sharpens
    the policy toward its own modes (self-distillation) — a reward the
    policy can reliably improve from random init, which is exactly what a
    closed-loop gate needs; the penalty term exercises the part of the
    reward the logprobs alone cannot see."""

    def reward(prompt, completion, logprobs):
        completion = np.asarray(completion)
        logprobs = np.asarray(logprobs, np.float64)
        lp = float(np.mean(logprobs)) if logprobs.size else 0.0
        n = int(completion.size)
        penalty = (
            abs(n - int(target_len)) if target_len is not None else n
        )
        return lp - float(length_coef) * penalty

    return reward


class ToyPreferenceModel:
    """A stand-in preference model: a fixed, seeded per-token value table
    ``w ~ N(0, 1)`` scores a completion as the mean value of its tokens
    (plus an optional length penalty). It is a *frozen scorer* — the
    shape of a learned reward model's inference API without the training:
    the policy improves it by shifting probability mass toward
    high-``w`` tokens, which REINFORCE discovers from samples alone."""

    def __init__(self, vocab_size: int, *, seed: int = 0,
                 length_coef: float = 0.0):
        if vocab_size < 1:
            raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
        rng = np.random.default_rng(seed)
        self.table = rng.standard_normal(int(vocab_size)).astype(np.float64)
        self.length_coef = float(length_coef)

    def __call__(self, prompt, completion, logprobs):
        completion = np.asarray(completion, np.int64)
        if completion.size == 0:
            return 0.0
        score = float(np.mean(self.table[completion]))
        return score - self.length_coef * int(completion.size)


def get(name_or_fn, **kwargs):
    """Resolve a reward by name ('length_penalized_logprob',
    'toy_preference') or pass a callable through — the optim/losses
    registry idiom."""
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn == "length_penalized_logprob":
        return length_penalized_logprob(**kwargs)
    if name_or_fn == "toy_preference":
        return ToyPreferenceModel(**kwargs)
    raise ValueError(
        f"Unknown reward {name_or_fn!r}; known: "
        "['length_penalized_logprob', 'toy_preference'] or any callable "
        "(prompt, completion, logprobs) -> float"
    )
