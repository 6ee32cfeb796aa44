"""Elastic gang policy: survive *permanent* worker loss by re-forming the
gang at a new world size.

The port's copy of the JAX package's ``resilience/elastic.py``.

The fixed-size :class:`~distributed_tpu_torch.resilience.Supervisor` answers every
failure the same way: relaunch the identical N-worker gang. That is the
right answer for transient faults (a crash, a flaky host reboot) and the
wrong one for permanent capacity loss — a dead host makes every fixed-N
relaunch die at the same collective, so the restart budget burns down to
``budget_exhausted`` with zero forward progress. Production clusters lose
*and regain* capacity continuously; the run should follow the capacity.

:class:`ElasticPolicy` is the decision value the supervisor consults at
each restart boundary:

- **Permanent-loss detection** is either *attributed* — a
  :class:`FailureLedger` counts, per rank, consecutive attempts in which
  that rank initiated the gang failure (gang-kill collateral and
  preemptions never count); a rank that reaches ``failure_threshold`` is
  declared permanently lost — or *probed*: a pluggable ``probe`` callable
  returns the currently available worker count (a cluster-manager query, a
  quota file), which both shrinks and grows the target world.
- **Resize** relaunches the *identical command* at the new world size N′.
  A resize restart is budget-free (capacity change is not a defect of the
  job), bounded separately by ``max_resizes`` so an oscillating probe
  still terminates.
- **Grow-back** happens at the same boundaries: when the probe reports
  more capacity than the current world, the next relaunch runs at
  ``min(probe(), max_workers)``. (Attribution alone cannot observe
  returning capacity, so probeless policies only shrink.) The supervisor
  cannot interrupt a *healthy* gang — resizes take effect at the next
  restart boundary, whatever causes it (failure or preemption).

Batch-math contract: ``divisor_of`` (set it to the global batch size)
snaps every candidate world size down to the largest divisor, so the
re-formed gang's ``data.Pipeline(shard=(rank, N'))`` splits the *same*
global batch exactly and the loss trajectory is preserved across the
resize.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Set


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """How a :class:`~distributed_tpu_torch.resilience.Supervisor` resizes.

    ``min_workers``/``max_workers`` bound every world size the supervisor
    may launch (``max_workers=None`` means the supervisor's initial gang
    size). ``failure_threshold`` is the consecutive-initiated-failure
    count at which a rank is declared permanently lost (attribution path;
    ignored when ``probe`` is set). ``probe``, when given, is called at
    every restart boundary and must return the number of workers the
    cluster can currently run — it overrides attribution and is the only
    way the gang grows back. ``divisor_of`` snaps candidate sizes down to
    the largest divisor (set it to the global batch so every resize keeps
    exact batch math). ``max_resizes`` bounds total resizes per run.
    """

    min_workers: int = 1
    max_workers: Optional[int] = None
    failure_threshold: int = 2
    probe: Optional[Callable[[], int]] = None
    divisor_of: Optional[int] = None
    max_resizes: int = 16

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}"
            )
        if self.max_workers is not None and self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})"
            )
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {self.failure_threshold}"
            )
        if self.divisor_of is not None and self.divisor_of < 1:
            raise ValueError(
                f"divisor_of must be >= 1, got {self.divisor_of}"
            )
        if self.max_resizes < 0:
            raise ValueError(
                f"max_resizes must be >= 0, got {self.max_resizes}"
            )

    def snap(self, n: int, default_max: int) -> Optional[int]:
        """The world size actually launched for a candidate ``n``: clamped
        into [min_workers, max_workers] and, under ``divisor_of``, rounded
        DOWN to the largest divisor still >= min_workers. Returns None when
        no feasible size exists (e.g. min_workers itself doesn't divide) —
        the caller then falls back to a fixed-size restart.

        A candidate below ``min_workers`` clamps UP: the policy's floor is
        a statement that the job is not worth running smaller, so the
        supervisor relaunches at the floor and lets the attempt prove
        whether the capacity is really there.
        """
        hi = self.max_workers if self.max_workers is not None else default_max
        n = max(self.min_workers, min(int(n), max(hi, self.min_workers)))
        if self.divisor_of is None:
            return n
        for d in range(n, self.min_workers - 1, -1):
            if self.divisor_of % d == 0:
                return d
        return None


class FailureLedger:
    """Per-rank failure attribution across supervised attempts.

    ``record(initiators)`` after each failed attempt: every rank that
    *initiated* the failure (its own exit/hang — not gang-kill collateral,
    not a preemption) increments its consecutive count; every other rank's
    count resets to zero. A rank whose count reaches the policy's
    ``failure_threshold`` is permanently lost — the same rank killing the
    gang attempt after attempt is the signature of a bad host, which a
    fixed-size relaunch can never route around. Reset on every resize: the
    re-formed gang renumbers ranks, so old attributions are meaningless.
    """

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.attempts_recorded = 0

    def record(self, initiators: Iterable[int]) -> None:
        initiators = set(initiators)
        if not initiators:
            # Unattributable failure (launch error, whole-gang timeout):
            # nobody's count moves — neither blame nor exoneration.
            return
        self.attempts_recorded += 1
        for r in initiators:
            self.counts[r] = self.counts.get(r, 0) + 1
        for r in list(self.counts):
            if r not in initiators:
                self.counts[r] = 0

    def permanent(self, threshold: int) -> Set[int]:
        return {r for r, c in self.counts.items() if c >= threshold}

    def reset(self) -> None:
        self.counts.clear()
        self.attempts_recorded = 0
