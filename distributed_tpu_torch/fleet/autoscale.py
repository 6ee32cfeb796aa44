"""Queue-depth / SLO autoscaling for the decode pool.

:class:`~distributed_tpu_torch.resilience.ElasticPolicy` resizes a TRAINING
gang on capacity signals: its ``probe()`` seam returns "how many workers
can run right now" and the supervisor follows it at restart boundaries.
:class:`QueueAutoscaler` is that seam generalized from capacity-driven to
LOAD-driven for serving: the target replica count follows queue depth and
tail latency instead of worker failures, and ``probe()`` exposes the
current target in exactly the ElasticPolicy shape — so the same policy
object that resizes a training gang can be pointed at a serving fleet
(``ElasticPolicy(probe=autoscaler.probe)``) without either side knowing.

Decision rules (deliberately simple, hysteretic, and pure — testable from
synthetic traces):

- **Grow** by one replica when queue depth per replica exceeds
  ``queue_high``, or when the recent p99 TTFT exceeds ``slo_ttft_s``
  (when set). Bursts are what autoscaling exists for; growth is cheap
  because replica spin-up is pool allocation: replicas share one
  model and its dispatches (``fleet.replica.EnginePrograms``).
- **Shrink** by one replica when the queue is below ``queue_low`` per
  replica AND at least one replica's worth of decode slots sits idle —
  the load provably fits in fewer replicas. Shrinking waits out
  ``cooldown_s`` since the last change (growth reacts immediately after
  its own cooldown; shedding capacity is the decision to be slow about).
- Targets clamp to ``[min_replicas, max_replicas]``; every change is
  recorded with its reason for the fleet's telemetry.

A copy of the JAX package's ``fleet/autoscale.py`` (host arithmetic
only), kept here so the port stands alone.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["QueueAutoscaler"]


class QueueAutoscaler:
    """See module docstring. ``spinup_s`` is the modeled replica warm-up
    latency the fleet adds before a grown replica takes work (on top of
    the measured pool-allocation cost)."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4, *,
                 queue_high: float = 2.0, queue_low: float = 0.25,
                 slo_ttft_s: Optional[float] = None,
                 cooldown_s: float = 0.5, spinup_s: float = 0.0):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}"
            )
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas "
                f"({min_replicas})"
            )
        if queue_low >= queue_high:
            raise ValueError(
                f"queue_low ({queue_low}) must be < queue_high "
                f"({queue_high}) — equal thresholds oscillate"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.slo_ttft_s = slo_ttft_s
        self.cooldown_s = float(cooldown_s)
        self.spinup_s = float(spinup_s)
        self._target = self.min_replicas
        self._last_change: Optional[float] = None
        self.events: List[dict] = []

    # ---------------------------------------------------------------- seam
    def probe(self) -> int:
        """The ElasticPolicy capacity seam: the worker count this policy
        currently wants. Safe to hand to ``ElasticPolicy(probe=...)``."""
        return self._target

    @property
    def target(self) -> int:
        return self._target

    # ------------------------------------------------------------- decide
    def _change(self, now: float, to: int, reason: str) -> int:
        self.events.append({
            "t": round(float(now), 4), "from": self._target, "to": to,
            "reason": reason,
        })
        self._target = to
        self._last_change = float(now)
        return to

    def decide(self, now: float, *, queue_depth: int, replicas: int,
               free_slots: int = 0, slots_per_replica: int = 1,
               recent_p99_ttft: Optional[float] = None) -> int:
        """One autoscaling decision at fleet time ``now`` from live pool
        signals (router + replica queue depths summed into
        ``queue_depth``; ``free_slots`` across live decode replicas).
        Returns the new target replica count."""
        in_cooldown = (
            self._last_change is not None
            and now - self._last_change < self.cooldown_s
        )
        if in_cooldown:
            return self._target
        per = queue_depth / max(replicas, 1)
        slo_breach = (
            self.slo_ttft_s is not None
            and recent_p99_ttft is not None
            and recent_p99_ttft > self.slo_ttft_s
        )
        if (per > self.queue_high or slo_breach) and (
                self._target < self.max_replicas):
            reason = ("p99_ttft %.3fs > slo %.3fs"
                      % (recent_p99_ttft, self.slo_ttft_s)) if slo_breach \
                else "queue_depth %d > %.2g/replica" % (queue_depth,
                                                        self.queue_high)
            return self._change(now, self._target + 1, reason)
        if (per < self.queue_low
                and free_slots >= slots_per_replica
                and not slo_breach
                and self._target > self.min_replicas):
            return self._change(
                now, self._target - 1,
                "queue_depth %d < %.2g/replica, %d slots idle"
                % (queue_depth, self.queue_low, free_slots),
            )
        return self._target
