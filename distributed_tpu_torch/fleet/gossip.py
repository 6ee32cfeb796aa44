"""Cross-replica prefix gossip: the fleet-wide chain-hash index.

Each decode replica's
:class:`~distributed_tpu_torch.serving.kv_cache.PrefixStore` is local: a
cold replica re-earns every prefix the warm one already computed. Gossip
closes the gap with two pieces:

- **The index** (:class:`PrefixGossipIndex`, this module): replicas
  ADVERTISE their store's chain-hash keys, stamped with the weights
  version the blocks were computed under; the router consults the global
  view at placement (a replica that can adopt a remote run scores prefix
  affinity too, ties still break by queue depth), and the fleet moves
  the blocks — ``fleet.handoff.pack_prefix`` on the warm side,
  ``adopt_prefix`` on the cold side.
- **The stamp**: advertisements and payload manifests carry
  ``weights_version`` so a peer can NEVER adopt blocks computed under
  old weights — ``update_weights`` flushes every store, withdraws every
  advertisement, AND bumps the version, so even an advertisement that
  raced the swap fails the stamp check at adoption time (the
  ``PrefixStore.flush`` staleness contract, extended fleet-wide).

Advertisement is SYNC semantics, not append: each call replaces the
replica's advertised set with its store's current keys, so local
eviction (refcount-aware LRU under pool pressure) propagates on the next
sync instead of leaving dangling claims. A claim can still go stale
between sync and adoption — ``pack_prefix`` probes the live store and
returns the (possibly shorter, possibly empty) run it actually holds,
and the adopter just keeps what arrives: chain keys make any leading run
self-consistent.

Host-side bookkeeping only (no tensor enters); the transport for
real-process fleets is ``serve_service.transport`` (shm ``.npy`` blocks
same-host, ``DTS1`` inline frames cross-host), whose manifests carry the
same ``weights_version`` stamp. A copy of the JAX package's
``fleet/gossip.py``, kept here so the port stands alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixGossipIndex"]


class PrefixGossipIndex:
    """Chain-hash key -> advertising replicas, with weights-version
    stamps. See the module docstring for the protocol."""

    def __init__(self):
        # replica -> {chain key -> weights_version}
        self._by_replica: Dict[str, Dict[str, int]] = {}
        self.advertised_blocks = 0   # keys newly advertised, cumulative
        self.withdrawals = 0         # replicas withdrawn (flush/retire)
        self.lookups = 0
        self.peer_hits = 0           # lookups that found an adoptable run

    # ----------------------------------------------------------- publish
    def advertise(self, replica: str, keys: Sequence[str],
                  weights_version: int = 0) -> int:
        """Replace ``replica``'s advertised set with ``keys`` at
        ``weights_version``; returns how many keys are NEW (not in its
        previous advertisement) — the advertise-event granularity."""
        old = self._by_replica.get(replica, {})
        new = {str(k): int(weights_version) for k in keys}
        added = sum(1 for k in new if k not in old)
        self._by_replica[replica] = new
        self.advertised_blocks += added
        return added

    def withdraw(self, replica: str) -> int:
        """Drop every advertisement of ``replica`` (store flushed, or the
        replica retired/killed). Returns the number of keys dropped."""
        dropped = len(self._by_replica.pop(replica, {}))
        if dropped:
            self.withdrawals += 1
        return dropped

    # ------------------------------------------------------------ lookup
    def holders(self, key: str,
                weights_version: Optional[int] = None) -> List[str]:
        """Replicas advertising ``key`` (matching the stamp when given),
        sorted by name for determinism."""
        return sorted(
            name for name, keys in self._by_replica.items()
            if key in keys and (weights_version is None
                                or keys[key] == int(weights_version))
        )

    def best_peer(self, keys: Sequence[str], *,
                  weights_version: Optional[int] = None,
                  exclude: Sequence[str] = ()
                  ) -> Tuple[Optional[str], int]:
        """The replica advertising the LONGEST leading run of ``keys``
        at ``weights_version`` (chain keys: a run is only useful from
        block 0), and that run's length. Ties break by replica name.
        ``(None, 0)`` when nobody holds even the first block."""
        self.lookups += 1
        skip = set(exclude)
        best: Tuple[Optional[str], int] = (None, 0)
        for name in sorted(self._by_replica):
            if name in skip:
                continue
            held = self._by_replica[name]
            run = 0
            for k in keys:
                if k not in held or (weights_version is not None
                                     and held[k] != int(weights_version)):
                    break
                run += 1
            if run > best[1]:
                best = (name, run)
        if best[1] > 0:
            self.peer_hits += 1
        return best

    # --------------------------------------------------------- telemetry
    def telemetry(self) -> dict:
        return {
            "replicas_advertising": sum(
                1 for keys in self._by_replica.values() if keys
            ),
            "keys_live": sum(
                len(keys) for keys in self._by_replica.values()
            ),
            "advertised_blocks": self.advertised_blocks,
            "withdrawals": self.withdrawals,
            "lookups": self.lookups,
            "peer_hits": self.peer_hits,
        }
