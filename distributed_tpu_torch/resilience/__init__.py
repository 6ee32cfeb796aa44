"""Resilience: supervised, restartable training runs.

The port's counterpart of the JAX package's ``resilience/``. The
reference's only fault story is "Workers will need to restart training if
any fails"; these pieces make the restart automatic and measured:

- :class:`Supervisor`: launches and monitors worker gangs on the port's
  launchers (heartbeat liveness, exponential-backoff restarts, a restart
  budget, a structured event log).
- :class:`RestartPolicy`: the budget and backoff as a testable value.
- :class:`ElasticPolicy`: re-forms the gang at a new world size on
  permanent worker loss (``DTPU_ELASTIC_WORLD``) instead of burning the
  budget, and grows it back under a capacity probe.
- :class:`PreemptionHandler`: SIGTERM -> final checkpoint -> resume
  marker -> exit :data:`PREEMPTED_EXIT_CODE` (a restart that spends no
  budget).
- :class:`FaultInjector`: kill, hang, slow-heartbeat, slow-steps,
  corrupt-checkpoint and buddy faults, so the machinery above is
  provable.
- :class:`BuddyRedundancy`: the diskless recovery tier behind
  ``ModelCheckpoint(buddy=)``: each rank mirrors its shard into a peer's
  RAM segment, and a re-formed gang restores from the mirrors with zero
  disk reads.

Automatic resume rides the checkpoint contract: workers run with
``ModelCheckpoint(dir, restore=True)`` and a fixed seed; restore skips
corrupt checkpoints and the batch stream continues from the restored
step, so a supervised run ends bit-identical to an uninterrupted one.
"""

from ..utils.events import EventLog, read_events
from .elastic import ElasticPolicy, FailureLedger
from .faults import FaultInjector, corrupt_latest_checkpoint
from .policy import RestartPolicy
from .preemption import (
    PREEMPTED_EXIT_CODE,
    PreemptionHandler,
    clear_resume_marker,
    read_resume_marker,
    write_resume_marker,
)
from .redundancy import (
    BuddyRedundancy,
    BuddyStore,
    mirror_holder,
    mirror_source,
    ram_dir,
    select_restore_tier,
)
from .supervisor import (
    SupervisedResult,
    Supervisor,
    recovery_rows,
    supervise,
)

__all__ = [
    "Supervisor",
    "SupervisedResult",
    "supervise",
    "recovery_rows",
    "RestartPolicy",
    "ElasticPolicy",
    "FailureLedger",
    "PreemptionHandler",
    "PREEMPTED_EXIT_CODE",
    "FaultInjector",
    "corrupt_latest_checkpoint",
    "BuddyRedundancy",
    "BuddyStore",
    "select_restore_tier",
    "mirror_holder",
    "mirror_source",
    "ram_dir",
    "EventLog",
    "read_events",
    "write_resume_marker",
    "read_resume_marker",
    "clear_resume_marker",
]
