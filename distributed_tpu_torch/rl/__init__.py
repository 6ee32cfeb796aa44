"""Online post-training over the live serving engine (the JAX package's
``rl``): generate rollouts on ``serving.Engine`` (continuous batching,
per-token logprob capture), score them with a pluggable reward, update
the policy through ``Model.fit``, and copy the new weights into the
engine with ``Engine.update_weights``; and ``DraftDistiller``, which
trains a speculative engine's draft toward its target the same way.

    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                temperature=1.0, decode_kernel="fused")
    pt = dtt.rl.PostTrainer(model, engine,
                            kl_coef=dtt.optim.AdaptiveKLCoef(),
                            optimizer=dtt.optim.fused_adam(1e-5))
    rows = pt.train(prompts, iterations=3, num_samples=4)
"""

from .distill import DraftDistiller, distill_loss, pack_distill
from .loop import PostTrainer, Rollout, pack_rollouts, rl_loss
from .rewards import ToyPreferenceModel, length_penalized_logprob
from . import rewards

__all__ = [
    "PostTrainer",
    "Rollout",
    "pack_rollouts",
    "rl_loss",
    "DraftDistiller",
    "distill_loss",
    "pack_distill",
    "rewards",
    "ToyPreferenceModel",
    "length_penalized_logprob",
]
