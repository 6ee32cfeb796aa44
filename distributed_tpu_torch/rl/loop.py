"""Online post-training: the rollout -> score -> train -> hot-swap loop.

The port of the JAX package's ``rl/loop.py``. ``PostTrainer`` closes the
loop between the serving ``Engine`` (continuous batching makes N
parallel sampled rollouts per prompt cheap) and the ``fit`` training path
(grad-accum, the data-parallel strategies and the precision policies
compose), with ``Engine.update_weights`` as the seam: every iteration
ends by copying the freshly trained parameters into the engine's served
snapshot, no restart, in-flight KV retained.

One iteration:

1. **rollout**: ``engine.run(requests, return_logprobs=True)``; each
   prompt becomes ``num_samples`` requests with distinct per-request
   seeds (the JAX engine's Threefry draws, so the tokens are JAX's), and
   the engine records each generated token's sampling logprob.
2. **score**: a pluggable ``reward_fn(prompt, completion, logprobs)``
   (``rl.rewards``) scores every completed rollout.
3. **train**: a REINFORCE / simple-PPO step through ``Model.fit``: the
   rollouts are packed into a fixed-shape ``(x, y)`` batch
   (``pack_rollouts``) whose ``y`` carries [target token, advantage,
   rollout logprob, completion mask, kl coef] per position, and
   ``rl_loss`` recomputes the policy logprobs under the current
   parameters and applies ``-advantage * logprob`` plus the k3 KL to the
   rollout logprobs. Advantage = reward - EMA baseline
   (``optim.EmaBaseline``).
4. **sync**: ``engine.update_weights(model.params)`` bumps
   ``weights_version``; the next iteration's rollouts are on-policy.

``rl_loss`` is a ratio whose divisor (the completion tokens) depends on
the data, so it returns ``(sum, count)``: ``Model`` divides each rank's
sum by the count over the whole batch group (``Model._rank_loss``), the
one ratio the JAX step takes over its global batch. Under ``grad_accum=M``
each microbatch is such a ratio and the step averages the M of them, as
JAX's accumulation step does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence as SequenceT

import numpy as np
import torch

from .. import optim
from ..obs import registry as obs_registry
from ..serving.scheduler import Request
from . import rewards as rewards_lib

__all__ = ["PostTrainer", "Rollout", "pack_rollouts", "rl_loss"]

_M63 = (1 << 63) - 1

# y-channel layout of a packed rollout batch (pack_rollouts / rl_loss).
_CH_TARGET, _CH_ADV, _CH_REF_LP, _CH_MASK, _CH_KL = range(5)


@dataclass
class Rollout:
    """One scored rollout: the full token row the engine returned
    (prompt + completion), where the prompt ends, the captured sampling
    logprobs (index-aligned with the completion), and the scalar
    reward/advantage the scorer and baseline assigned."""

    tokens: np.ndarray
    prompt_len: int
    logprobs: np.ndarray
    reward: float = 0.0
    advantage: float = 0.0

    @property
    def completion(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]


def _pack(rollouts, train_len: int, channels: int, what: str):
    """``x`` ``(B, L-1)`` int32 (``tokens[:-1]``, right-padded with 0),
    ``y`` ``(B, L-1, channels)`` float32 with the target tokens in channel
    0, and per rollout the span ``[lo, hi)`` of positions whose target is
    a completion token with its logprobs (``pack_rollouts`` and
    ``pack_distill`` share this geometry)."""
    L = int(train_len)
    if L < 2:
        raise ValueError(f"train_len must be >= 2, got {train_len}")
    b = len(rollouts)
    if b == 0:
        raise ValueError(f"{what} needs at least one rollout")
    x = np.zeros((b, L - 1), np.int32)
    y = np.zeros((b, L - 1, channels), np.float32)
    spans = []
    for i, r in enumerate(rollouts):
        toks = np.asarray(r.tokens, np.int64).reshape(-1)
        if toks.size > L:
            raise ValueError(
                f"rollout {i} has {toks.size} tokens but train_len is "
                f"{L}; raise train_len (the engine's max_len always "
                "covers its own outputs)"
            )
        n = toks.size
        x[i, : n - 1] = toks[:-1]
        y[i, : n - 1, 0] = toks[1:]
        lo = max(int(r.prompt_len) - 1, 0)
        hi = n - 1  # last position predicts the final completion token
        lps = np.asarray(r.logprobs, np.float32).reshape(-1)
        if lps.size < hi - lo:
            raise ValueError(
                f"rollout {i}: {lps.size} logprobs for {hi - lo} "
                "completion tokens — run the engine with "
                "return_logprobs=True"
            )
        spans.append((lo, hi, lps[: hi - lo]))
    return x, y, spans


def pack_rollouts(rollouts: SequenceT, train_len: int,
                  kl_coef: float = 0.0):
    """Pack scored rollouts into one fixed-shape teacher-forcing batch
    for the ``fit`` path: ``x`` is ``(B, L-1)`` int32 input tokens
    (``tokens[:-1]``, right-padded with 0), ``y`` is ``(B, L-1, 5)``
    float32 with per-position channels [target token, advantage, rollout
    logprob, mask, kl coef]. The mask selects exactly the positions whose
    TARGET is a completion token (position t predicts token t+1, so the
    completion of a ``p``-token prompt occupies positions p-1 ..
    p-1+len(completion)). ``L`` must cover every rollout (the engine's
    ``max_len`` does). The JAX package's arrays, byte for byte."""
    x, y, spans = _pack(rollouts, train_len, 5, "pack_rollouts")
    y[:, :, _CH_KL] = float(kl_coef)
    for i, (r, (lo, hi, lps)) in enumerate(zip(rollouts, spans)):
        y[i, lo:hi, _CH_ADV] = float(r.advantage)
        y[i, lo:hi, _CH_REF_LP] = lps
        y[i, lo:hi, _CH_MASK] = 1.0
    return x, y


def _logprob_at(logits, tokens):
    """``log_softmax(logits)`` in f32, read at ``tokens`` (int64)."""
    logp_all = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return logp_all.gather(-1, tokens[..., None])[..., 0]


def rl_loss(ppo_clip: Optional[float] = None):
    """The policy-gradient loss over a ``pack_rollouts`` batch, a
    ``loss_fn(logits, y)`` for ``Model.compile`` that returns ``(sum,
    count)``: the sum over the masked positions and their count, whose
    ratio is the JAX loss's value (``Model`` divides by the count of the
    whole batch group).

    Per masked position: ``-advantage * logprob`` (REINFORCE; with
    ``ppo_clip`` the PPO clipped surrogate on the importance ratio
    ``exp(logprob - rollout_logprob)`` instead) plus ``kl_coef`` times
    the k3 KL estimator ``exp(d) - 1 - d`` (d = rollout_lp - lp, always
    >= 0). The kl coef rides in the batch (y channel 4), so an
    ``optim.AdaptiveKLCoef`` changes nothing the step captured."""
    clip = None if ppo_clip is None else float(ppo_clip)

    def loss(logits, y):
        tok = y[..., _CH_TARGET].to(torch.int64)
        adv = y[..., _CH_ADV]
        ref_lp = y[..., _CH_REF_LP]
        w = y[..., _CH_MASK]
        kl_coef = y[..., _CH_KL]
        lp = _logprob_at(logits, tok)
        # Mask INSIDE the exponentials: pad positions carry arbitrary
        # logprobs, and exp() of those would overflow before the mask
        # could zero them (inf * 0 = nan).
        d = (ref_lp - lp) * w
        if clip is None:
            pg = -(w * adv * lp)
        else:
            ratio = torch.exp(-d)
            pg = -w * torch.minimum(
                ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        kl = torch.exp(d) - 1.0 - d
        return torch.sum(pg + kl_coef * w * kl), torch.sum(w)

    return loss


def request_seed(seed: int, *parts: int) -> int:
    """The JAX loop's 63-bit FNV-style mix of a trainer seed and
    (iteration or round, prompt, sample): a distinct, reproducible seed
    per rollout."""
    h = int(seed)
    for part in parts:
        h = (h * 0x100000001B3 + int(part) + 1) & _M63
    return h


def collect_rollouts(engine, reqs):
    """Run ``reqs`` on ``engine`` with logprobs; one unscored
    ``Rollout`` per request, in request order."""
    outs = engine.run(reqs, return_logprobs=True)
    rows = {r["request_id"]: r
            for r in engine.last_run_telemetry["requests"]}
    return [Rollout(np.asarray(out, np.int64), int(req.prompt.size),
                    np.asarray(rows[req.request_id]["logprobs"], np.float64))
            for req, out in zip(reqs, outs)]


class PostTrainer:
    """RLHF-style online post-training over a live serving engine.

    ``model``: the BUILT trainer model (any strategy); it is (re)compiled
    here with the policy-gradient loss, which replaces any previous
    optimizer state. ``engine``: a ``serving.Engine`` over the same
    architecture, built with ``temperature > 0`` (greedy rollouts carry
    no exploration: raises). Usually it wraps the SAME model object: the
    engine serves its own snapshot, so training between syncs never
    perturbs in-flight decodes.

    ``kl_coef`` is a float or an ``optim.AdaptiveKLCoef`` (updated each
    iteration with the measured post-update KL). ``reward_fn`` follows
    the ``rl.rewards`` contract. ``train_len`` fixes the packed batch
    width (default: the engine's ``max_len``). ``optimizer``: a name
    (with ``learning_rate``) or an ``optim`` instance, e.g.
    ``optim.fused_adam(1e-5)``, whose update is the fused Adam kernel.
    """

    def __init__(self, model, engine, reward_fn="length_penalized_logprob",
                 *, optimizer="adam", learning_rate: float = 1e-3,
                 kl_coef=0.0, ppo_clip: Optional[float] = None,
                 baseline_decay: float = 0.9,
                 train_len: Optional[int] = None,
                 grad_accum: Optional[int] = None,
                 measure_kl: bool = True, seed: int = 0):
        if not model.built:
            raise RuntimeError("Build the trainer model first")
        if engine.temperature <= 0.0:
            raise ValueError(
                "PostTrainer needs a sampling engine (temperature > 0): "
                "greedy rollouts are deterministic per prompt, so the "
                "policy gradient has nothing to explore"
            )
        self.model = model
        self.engine = engine
        self.reward_fn = rewards_lib.get(reward_fn)
        self.kl = kl_coef  # float or optim.AdaptiveKLCoef
        self.baseline = optim.EmaBaseline(decay=baseline_decay)
        self.train_len = int(train_len or engine.max_len)
        self.grad_accum = grad_accum
        self.measure_kl = bool(measure_kl)
        self.seed = int(seed)
        self.iteration = 0
        self.history: List[dict] = []
        kw = ({"learning_rate": float(learning_rate)}
              if isinstance(optimizer, str) else {})
        model.compile(optimizer=optimizer, loss=rl_loss(ppo_clip),
                      metrics=(), **kw)

    # ------------------------------------------------------------- helpers
    @property
    def kl_coef(self) -> float:
        return self.kl.coef if hasattr(self.kl, "coef") else float(self.kl)

    def _request_seed(self, prompt_idx: int, sample_idx: int) -> int:
        """Distinct, reproducible seed per (iteration, prompt, sample)."""
        return request_seed(self.seed, self.iteration, prompt_idx,
                            sample_idx)

    def _measured_kl(self, x, y) -> float:
        """Mean post-update KL-to-rollout over the completion tokens (the
        k3 estimator on the re-scored batch): the number an
        ``AdaptiveKLCoef`` steers on. One forward pass of the whole batch
        in eval mode, as the JAX ``predict(x, batch_size=len(x))``; the
        log-softmax and the gather run on the device in f32, a few rows
        at a time, and only the ``(B, L)`` logprobs come to the host."""
        lp = predict_logprobs(self.model, x, y[..., _CH_TARGET])
        w = y[..., _CH_MASK]
        d = (y[..., _CH_REF_LP] - lp) * w
        kl = np.exp(d) - 1.0 - d
        return float(np.sum(w * kl) / max(np.sum(w), 1.0))

    # ------------------------------------------------------------- iterate
    def iterate(self, prompts, *, num_samples: int = 4,
                max_new_tokens: int = 32, train_epochs: int = 1) -> dict:
        """One closed-loop iteration over ``prompts`` (a list of 1-D int
        token arrays): ``num_samples`` sampled rollouts per prompt on the
        engine, scored, one policy-gradient update per ``train_epochs``
        through ``fit`` (batch = all rollouts; ``grad_accum`` splits it
        into microbatches), then a weight hot-swap into the engine.
        Returns (and appends to ``self.history``) the iteration's metrics
        row: rewards, loss, measured KL, and the three loop couplings
        (rollout tokens/s, train steps/s, weight-sync latency)."""
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        self.iteration += 1
        reqs = [
            Request(np.asarray(p, np.int32), int(max_new_tokens),
                    seed=self._request_seed(pi, si))
            for pi, p in enumerate(prompts)
            for si in range(num_samples)
        ]
        t0 = time.perf_counter()
        rollouts = collect_rollouts(self.engine, reqs)
        rollout_s = time.perf_counter() - t0
        for roll in rollouts:
            roll.reward = float(self.reward_fn(
                roll.tokens[:roll.prompt_len], roll.completion,
                roll.logprobs))
        rewards = np.asarray([r.reward for r in rollouts], np.float64)
        # Advantage against the PRE-update baseline (the first iteration
        # centers on its own mean: EmaBaseline's cold start), then fold
        # this batch in for the next one.
        base = (
            self.baseline.value if self.baseline.value is not None
            else float(rewards.mean())
        )
        for roll in rollouts:
            roll.advantage = roll.reward - base
        self.baseline.update(float(rewards.mean()))
        x, y = pack_rollouts(rollouts, self.train_len, self.kl_coef)
        t0 = time.perf_counter()
        hist = self.model.fit(
            x, y, batch_size=len(rollouts), epochs=int(train_epochs),
            shuffle=False, verbose=0, grad_accum=self.grad_accum,
        )
        train_s = time.perf_counter() - t0
        train_steps = int(train_epochs)
        measured_kl = self._measured_kl(x, y) if self.measure_kl else None
        if measured_kl is not None and hasattr(self.kl, "update"):
            self.kl.update(measured_kl)
        t0 = time.perf_counter()
        version = self.engine.update_weights(self.model.params)
        sync_s = time.perf_counter() - t0
        row = {
            "iteration": self.iteration,
            "num_rollouts": len(rollouts),
            "reward_mean": float(rewards.mean()),
            "reward_std": float(rewards.std()),
            "baseline": float(base),
            "mean_completion_tokens": float(
                np.mean([r.completion.size for r in rollouts])
            ),
            "loss": float(hist.history["loss"][-1]),
            "kl": measured_kl,
            "kl_coef": self.kl_coef,
            "rollout_s": round(rollout_s, 4),
            "rollout_tokens_per_sec": self.engine.last_run_telemetry[
                "tokens_per_sec"
            ],
            "train_s": round(train_s, 4),
            "train_steps": train_steps,
            "train_steps_per_sec": round(train_steps / train_s, 3),
            "weight_sync_s": round(sync_s, 4),
            "weights_version": version,
        }
        self.history.append(row)
        # Registry view of the closed loop: the latest row as a stored
        # report, the couplings as gauges and counters.
        reg = obs_registry.default_registry()
        reg.counter("rl/iterations")
        reg.counter("rl/rollouts", len(rollouts))
        reg.gauge("rl/reward_mean", row["reward_mean"])
        reg.gauge("rl/kl", measured_kl if measured_kl is not None else 0.0)
        reg.gauge("rl/weight_sync_s", row["weight_sync_s"])
        reg.gauge("rl/rollout_tokens_per_sec",
                  row["rollout_tokens_per_sec"])
        reg.set_report("rl.iteration", row)
        return row

    def train(self, prompts, *, iterations: int = 4, num_samples: int = 4,
              max_new_tokens: int = 32, train_epochs: int = 1) -> List[dict]:
        """Run ``iterations`` closed-loop iterations; returns their
        metric rows (also accumulated on ``self.history``)."""
        return [
            self.iterate(
                prompts, num_samples=num_samples,
                max_new_tokens=max_new_tokens, train_epochs=train_epochs,
            )
            for _ in range(int(iterations))
        ]


# Rows of f32 log-softmax computed at once by predict_logprobs: bounds the
# device temporaries to ~(rows x L x V x 8) bytes.
_LOGPROB_ROWS = 4


def predict_logprobs(model, x, targets) -> np.ndarray:
    """``(B, L)`` f32 numpy: the model's log-probability of ``targets``
    (float or int, ``(B, L)``) at each position of ``x``, from
    ``predict``'s forward of the whole batch; the logits stay on the
    device."""
    tok = torch.from_numpy(np.asarray(targets).astype(np.int64))
    out = []
    with model._eval_forward() as forward:
        logits = forward(x)
        tok = tok.to(logits.device)
        for i in range(0, logits.shape[0], _LOGPROB_ROWS):
            rows = slice(i, i + _LOGPROB_ROWS)
            out.append(_logprob_at(logits[rows], tok[rows]).cpu())
    return torch.cat(out).numpy()
