"""Cluster specification and resolution.

Parity target: the reference's ``TF_CONFIG`` env contract
(the reference's README.md:84-89 R form, 322-327 Python form):

    {"cluster": {"worker": ["ip:port", ...]}, "task": {"type": "worker", "index": i}}

set identically on every worker except ``task.index``, before library init.

A copy of the JAX package's ``cluster/config.py``, which imports no JAX:
``ClusterSpec`` keeps the explicit-worker-list form (``resolve()`` order:
explicit arg > DTPU_CONFIG > TF_CONFIG > single-process default). Worker
0's address is the rendezvous of the ``torch.distributed`` process group
(``cluster.initialize``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

ENV_VAR = "DTPU_CONFIG"
TF_ENV_VAR = "TF_CONFIG"  # accepted for migration compatibility


@dataclasses.dataclass
class ClusterSpec:
    """One process's view of the cluster."""

    workers: List[str]  # "host:port" for every process, rank-ordered
    index: int  # this process's rank (reference: task.index)

    @property
    def num_processes(self) -> int:
        return len(self.workers)

    @property
    def coordinator(self) -> str:
        """Rank 0's endpoint — the chief (reference: index 0 is chief,
        the reference's README.md:84-89)."""
        return self.workers[0]

    @property
    def is_chief(self) -> bool:
        return self.index == 0

    # ---------------------------------------------------------------- codecs
    def to_json(self) -> str:
        return json.dumps(
            {
                "cluster": {"worker": list(self.workers)},
                "task": {"type": "worker", "index": self.index},
            }
        )

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        obj = json.loads(text)
        task = obj.get("task", {})
        if task.get("type", "worker") != "worker":
            raise ValueError(
                f"Only 'worker' tasks exist (got {task.get('type')!r}); the "
                "reference likewise has no parameter servers (SURVEY.md §2c)"
            )
        cluster = obj.get("cluster", {})
        if "worker" not in cluster:
            raise ValueError(
                f"Cluster spec must contain a 'worker' job (got jobs "
                f"{sorted(cluster)}); parameter-server / evaluator jobs are "
                "not supported"
            )
        workers = cluster["worker"]
        return cls(workers=list(workers), index=int(task.get("index", 0)))

    def validate(self):
        if not self.workers:
            raise ValueError("Empty worker list")
        if not 0 <= self.index < len(self.workers):
            raise ValueError(
                f"task index {self.index} out of range for {len(self.workers)} workers"
            )
        for w in self.workers:
            if ":" not in w:
                raise ValueError(f"Worker address {w!r} must be host:port")
        return self


def from_env() -> Optional[ClusterSpec]:
    for var in (ENV_VAR, TF_ENV_VAR):
        text = os.environ.get(var)
        if text:
            return ClusterSpec.from_json(text).validate()
    return None


def from_barrier(addresses: List[str], partition: int, base_port: int = 8000) -> ClusterSpec:
    """Build a spec from a barrier-style peer list + own rank, re-porting the
    peers — exactly the reference's Spark-closure construction
    (the reference's README.md:180-183: strip Spark's port, assign 8000+seq)."""
    hosts = [a.rsplit(":", 1)[0] for a in addresses]
    workers = [f"{h}:{base_port + i + 1}" for i, h in enumerate(hosts)]
    return ClusterSpec(workers=workers, index=int(partition)).validate()


def resolve(spec: Optional[ClusterSpec] = None) -> Optional[ClusterSpec]:
    """Resolution order: explicit > env (DTPU_CONFIG/TF_CONFIG) > None
    (meaning: run single-process)."""
    if spec is not None:
        return spec.validate()
    return from_env()
