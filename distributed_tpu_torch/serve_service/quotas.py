"""Per-tenant token-bucket quotas for the service front door.

The router's weighted fair queuing (``fleet.router``) divides SERVICE
fairly among tenants already in the queue — but it happily lets one
tenant fill the bounded queue, which rejects everyone's overflow with
``queue_full`` and makes admission a lottery the flooder keeps winning.
Quotas bound ADMISSION instead: each tenant owns a token bucket of
request-token capacity (``prompt + max_new_tokens``, the same token-work
unit WFQ charges), refilled at ``rate`` tokens/second with ``burst``
headroom. A tenant past its bucket is rejected at submit with reason
``"quota"`` and a ``retry_after_s`` hint, BEFORE the request touches the
shared queue — so a flooding tenant throttles itself and a paying tenant
never waits behind the flood.

Tenants without a configured limit are unmetered: quotas are an opt-in
cap on known abusers/tiers, not a default tax. Pure host arithmetic over
a caller-supplied clock, same testability discipline as the router. A
copy of the JAX package's ``serve_service/quotas.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["TokenBucket", "TenantQuotas"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second, at most ``burst``
    banked. ``try_take`` either debits the whole cost or nothing —
    partial admission of a generation request is meaningless."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"rate and burst must be > 0, got rate={rate} burst={burst}"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)  # start full: cold tenants admit freely
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self.level = min(self.burst,
                             self.level + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, cost: float, now: float) -> bool:
        self._refill(now)
        if self.level >= cost:
            self.level -= cost
            return True
        return False

    def retry_after(self, cost: float) -> float:
        """Seconds until the bucket could cover ``cost`` (assuming no
        other spend) — the reject hint clients should back off by. A cost
        beyond ``burst`` can never be covered; report the full-refill
        horizon so the caller sees a finite, honest bound."""
        need = min(float(cost), self.burst) - self.level
        return max(need, 0.0) / self.rate


class TenantQuotas:
    """Per-tenant buckets. ``limits`` maps tenant name to
    ``(rate_tokens_per_s, burst_tokens)``; unlisted tenants are
    unmetered. Rejections are recorded for telemetry (the service also
    emits a ``quota_reject`` event per rejection)."""

    def __init__(self, limits: Optional[Dict[str, Tuple[float, float]]]
                 = None):
        self._buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(rate, burst)
            for name, (rate, burst) in (limits or {}).items()
        }
        self.rejected: List[dict] = []

    def admit(self, tenant: str, cost: float, now: float
              ) -> Tuple[bool, Optional[float]]:
        """``(True, None)`` when admitted (or unmetered), else
        ``(False, retry_after_s)``."""
        bucket = self._buckets.get(tenant)
        if bucket is None or bucket.try_take(cost, now):
            return True, None
        retry = bucket.retry_after(cost)
        self.rejected.append({
            "tenant": tenant, "cost": float(cost), "t": float(now),
            "retry_after_s": round(retry, 4),
        })
        return False, retry

    def telemetry(self) -> dict:
        by_tenant: Dict[str, int] = {}
        for r in self.rejected:
            by_tenant[r["tenant"]] = by_tenant.get(r["tenant"], 0) + 1
        return {
            "limits": {
                name: {"rate": b.rate, "burst": b.burst}
                for name, b in sorted(self._buckets.items())
            },
            "rejected": len(self.rejected),
            "rejected_by_tenant": by_tenant,
        }
