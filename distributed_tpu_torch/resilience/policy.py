"""Restart policy: exponential backoff with a bounded restart budget.

The port's copy of the JAX package's ``resilience/policy.py``.

The reference's fault story is "Workers will need to restart training if
any fails" (the reference's README) — an operator action with no
policy at all. This module makes the policy an explicit, unit-testable
value: how many restarts a run may consume, how long to wait before each,
and whether preemption (a SIGTERM the run answered with a clean final
checkpoint, exit code ``preemption.PREEMPTED_EXIT_CODE``) spends budget.

Preemption is exempt by default: on shared clusters preemption is
routine capacity management, not a defect of the job, so a run that checkpoints
and exits cleanly should restart for free (bounded separately by
``max_preemptions`` so a pathological kill loop still terminates).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How a :class:`~distributed_tpu_torch.resilience.Supervisor` restarts.

    ``delay(restart_number)`` for restart_number = 1, 2, 3... is
    ``backoff * backoff_factor**(restart_number - 1)`` capped at
    ``backoff_max`` — the standard bounded exponential schedule.
    """

    max_restarts: int = 3
    backoff: float = 1.0
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    preemption_exempt: bool = True
    max_preemptions: int = 16

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.backoff < 0:
            raise ValueError(f"backoff must be >= 0, got {self.backoff}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}"
            )
        if self.backoff_max < self.backoff:
            raise ValueError(
                f"backoff_max ({self.backoff_max}) must be >= backoff "
                f"({self.backoff})"
            )
        if self.max_preemptions < 0:
            raise ValueError(
                f"max_preemptions must be >= 0, got {self.max_preemptions}"
            )

    def delay(self, restart_number: int) -> float:
        """Seconds to wait before the ``restart_number``-th restart (1-based)."""
        if restart_number < 1:
            raise ValueError(f"restart_number is 1-based, got {restart_number}")
        return min(
            self.backoff * self.backoff_factor ** (restart_number - 1),
            self.backoff_max,
        )

    def allows_restart(self, restarts_used: int) -> bool:
        """True while the failure budget has room for one more restart."""
        return restarts_used < self.max_restarts

    def allows_preemption_restart(self, preemptions_used: int) -> bool:
        return preemptions_used < self.max_preemptions
