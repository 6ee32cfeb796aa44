"""Disaggregated serving fleet: router → prefill pool → decode pool.

One :class:`~distributed_tpu_torch.serving.Engine` serves one pool. This
package composes the serving runtime and the fault machinery into a
multi-replica tier, as the JAX package's ``fleet``:

- **Disaggregation** — prefill and decode run on SEPARATE replica pools;
  prompts become first tokens + packed KV blocks on the prefill side and
  are handed to a decode replica (``fleet.handoff``), with re-prefill as
  the fallback when transfer is unavailable.
- **Routing** — an SLO-aware front door (``fleet.router``): bounded
  queues, reject-on-predicted-SLO-breach, weighted per-tenant fair
  queuing.
- **Elasticity** — a queue-depth/SLO autoscaler (``fleet.autoscale``);
  spin-up is a pool allocation, because replicas share one model and its
  dispatches (``fleet.replica.EnginePrograms``).
- **Fault tolerance** — ``FaultInjector(mode="replica_kill",
  replica="decode-1")`` tears a named replica down mid-request; the
  router re-queues its in-flight sequences and surviving replicas finish
  them token-exact under greedy decode.
- **Prefix gossip** — ``fleet.gossip``: replicas advertise their prefix
  stores and a cold replica adopts a peer's blocks instead of
  re-prefilling a shared prefix.

    programs = dtt.fleet.EnginePrograms(model, decode_kernel="fused")
    fleet = dtt.fleet.ServingFleet(model, decode_replicas=4,
                                   prefill_replicas=1, max_slots=4,
                                   block_size=16, max_len=128,
                                   programs=programs)
    outs = fleet.run(requests, arrival_times=times, tenants=tenants)
    fleet.last_run_telemetry  # tokens/s, p50/p99 TTFT (virtual clock)

Every replica's pool lives on the model's device; the fleet's clock is
virtual (``fleet.core``). ``serve_service`` runs the replicas as
processes on wall time.
"""

from .autoscale import QueueAutoscaler
from .core import FleetResult, ServingFleet
from .gossip import PrefixGossipIndex
from .handoff import (
    HandoffIncompatible, KVHandoff, adopt_prefix, install_kv, pack_kv,
    pack_prefix,
)
from .replica import DecodeReplica, EnginePrograms, PrefillReplica
from .router import Admission, Router

__all__ = [
    "ServingFleet",
    "FleetResult",
    "Router",
    "Admission",
    "QueueAutoscaler",
    "EnginePrograms",
    "PrefillReplica",
    "DecodeReplica",
    "KVHandoff",
    "HandoffIncompatible",
    "PrefixGossipIndex",
    "pack_kv",
    "install_kv",
    "pack_prefix",
    "adopt_prefix",
]
