"""Draft-LM distillation: make speculative decoding pay.

The port of the JAX package's ``rl/distill.py``. A speculative engine
only wins when the draft's greedy chain agrees with the target: every
rejected column is a wasted draft pass plus a verify row that committed
one token anyway. A randomly initialized or layer-truncated draft agrees
almost never, so speculation loses until the draft is trained toward the
target. ``DraftDistiller`` does that in the ``PostTrainer`` shape:

1. **rollout**: ``engine.run(requests, return_logprobs=True)``; the
   TARGET generates continuations and the engine records each chosen
   token's logprob (the teacher signal).
2. **distill**: the rollouts are packed into one fixed-shape
   teacher-forcing batch (``pack_distill``) and the draft is trained
   through ``Model.fit`` with ``distill_loss``, the single-sample
   forward-KL estimate ``E_teacher[log p_teacher(tok) - log
   p_draft(tok)]`` over the completion positions. Its gradient is
   cross-entropy on the teacher's tokens; its value is the KL gap.
3. **sync**: ``engine.update_weights(draft_params=...)`` copies the draft
   into the engine's served draft snapshot; a ``draft_sync`` event
   records how stale it had grown (target swaps since the last sync).

The port's engine serves copies of both models, so training the draft
never touches what the engine is serving until ``sync``; the per-round
sync order of the JAX loop (collect, distill, sync) is kept.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence as SequenceT

import numpy as np
import torch

from ..obs import registry as obs_registry
from ..serving.scheduler import Request
from .loop import Rollout, _pack, _logprob_at, collect_rollouts, \
    request_seed

__all__ = ["DraftDistiller", "pack_distill", "distill_loss"]

# y-channel layout of a packed distillation batch (pack_distill /
# distill_loss): [teacher-chosen token, teacher logprob, mask].
_CH_TOK, _CH_TLP, _CH_MASK = range(3)


def pack_distill(rollouts: SequenceT, train_len: int):
    """Pack teacher rollouts into one fixed-shape teacher-forcing batch:
    ``x`` is ``(B, L-1)`` int32 input tokens (``tokens[:-1]``,
    right-padded), ``y`` is ``(B, L-1, 3)`` float32 with per-position
    channels [teacher token, teacher logprob, mask]. The mask selects
    exactly the positions whose TARGET is a generated token (the draft is
    prefilled on real prompt tokens, so prompt predictions never affect
    acceptance). ``pack_rollouts``'s geometry; the JAX arrays, byte for
    byte."""
    x, y, spans = _pack(rollouts, train_len, 3, "pack_distill")
    for i, (lo, hi, lps) in enumerate(spans):
        y[i, lo:hi, _CH_TLP] = lps
        y[i, lo:hi, _CH_MASK] = 1.0
    return x, y


def distill_loss():
    """Forward-KL distillation loss over a ``pack_distill`` batch, a
    ``loss_fn(logits, y)`` for ``Model.compile`` that returns ``(sum,
    count)`` as ``rl_loss`` does: per masked position ``teacher_lp - log
    p_draft(teacher token)``, the single-sample estimate of
    ``KL(teacher || draft)`` under the teacher's trajectory; the ratio is
    the JAX loss's value."""

    def loss(logits, y):
        tok = y[..., _CH_TOK].to(torch.int64)
        tlp = y[..., _CH_TLP]
        w = y[..., _CH_MASK]
        lp = _logprob_at(logits, tok)
        return torch.sum(w * (tlp - lp)), torch.sum(w)

    return loss


class DraftDistiller:
    """Distill a small draft LM toward a serving engine's target.

    ``engine``: a ``serving.Engine`` over the TARGET model (greedy or
    sampled; greedy is the natural choice: acceptance compares the
    draft's greedy chain with the target's stream). ``draft``: the BUILT
    draft model to train, usually the one the engine was built with as
    ``draft_model=``; the engine serves its own snapshot of it, which
    :meth:`sync` refreshes. ``train_len`` fixes the packed batch width
    (default: the engine's ``max_len``).
    """

    def __init__(self, engine, draft, *, optimizer="adam",
                 learning_rate: float = 1e-2,
                 train_len: Optional[int] = None, seed: int = 0):
        if not draft.built:
            raise RuntimeError("Build the draft model first")
        self.engine = engine
        self.draft = draft
        self.train_len = int(train_len or engine.max_len)
        self.seed = int(seed)
        self.rounds = 0
        self.history: List[dict] = []
        kw = ({"learning_rate": float(learning_rate)}
              if isinstance(optimizer, str) else {})
        draft.compile(optimizer=optimizer, loss=distill_loss(), metrics=(),
                      **kw)

    def _request_seed(self, prompt_idx: int, sample_idx: int) -> int:
        return request_seed(self.seed, self.rounds, prompt_idx, sample_idx)

    # ------------------------------------------------------------ rollout
    def collect(self, prompts, *, max_new_tokens: int = 32,
                num_samples: int = 1) -> List[Rollout]:
        """Teacher rollouts for ``prompts`` (1-D int token arrays) with
        per-token teacher logprobs. ``num_samples > 1`` only diversifies a
        SAMPLING engine (distinct reproducible seeds per sample); a greedy
        engine would repeat itself, so it is pinned to 1 there."""
        if self.engine.temperature <= 0.0:
            num_samples = 1
        reqs = [
            Request(np.asarray(p, np.int32), int(max_new_tokens),
                    seed=self._request_seed(pi, si))
            for pi, p in enumerate(prompts)
            for si in range(int(num_samples))
        ]
        return collect_rollouts(self.engine, reqs)

    # ------------------------------------------------------------ distill
    def distill(self, rollouts: SequenceT, *, epochs: int = 8,
                batch_size: Optional[int] = None) -> dict:
        """Train the draft on ``rollouts`` through the fit path; returns
        (and appends to ``self.history``) the round's metrics row, whose
        ``loss_first``/``loss_last`` say whether the draft moved toward
        the teacher."""
        x, y = pack_distill(rollouts, self.train_len)
        self.rounds += 1
        t0 = time.perf_counter()
        hist = self.draft.fit(
            x, y, batch_size=int(batch_size or len(rollouts)),
            epochs=int(epochs), shuffle=False, verbose=0,
        )
        train_s = time.perf_counter() - t0
        losses = [float(v) for v in hist.history["loss"]]
        row = {
            "round": self.rounds,
            "num_rollouts": len(rollouts),
            "epochs": int(epochs),
            "loss_first": losses[0],
            "loss_last": losses[-1],
            "losses": losses,
            "train_s": round(train_s, 4),
        }
        self.history.append(row)
        reg = obs_registry.default_registry()
        reg.counter("rl/distill_rounds")
        reg.gauge("rl/distill_loss", losses[-1])
        reg.set_report("rl.distill", row)
        return row

    # --------------------------------------------------------------- sync
    def sync(self) -> int:
        """Copy the trained draft into the engine's served draft
        (``update_weights(draft_params=...)``, which emits ``draft_sync``
        with the staleness the draft had accumulated). Returns the
        engine's weights_version."""
        return self.engine.update_weights(draft_params=self.draft.params)

    # ---------------------------------------------------------------- fit
    def fit(self, prompts, *, max_new_tokens: int = 32,
            num_samples: int = 1, epochs: int = 8,
            rounds: int = 1, sync: bool = True) -> List[dict]:
        """``rounds`` x (collect -> distill -> sync), the sync per round as
        in the JAX loop. ``sync=False`` is for engines built WITHOUT a
        draft (distilling ahead of time); publish before speculating.
        Returns the per-round metric rows."""
        out = []
        for _ in range(int(rounds)):
            rollouts = self.collect(
                prompts, max_new_tokens=max_new_tokens,
                num_samples=num_samples,
            )
            out.append(self.distill(rollouts, epochs=epochs))
            if sync and getattr(self.engine, "_draft", None) is not None:
                self.sync()
        return out
