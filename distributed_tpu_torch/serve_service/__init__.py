"""The disaggregated fleet as a real multi-process service.

``fleet.ServingFleet`` runs prefill/decode disaggregation, KV handoff,
WFQ and autoscaling inside one process on a virtual clock. This package
runs the same machinery as PROCESSES on wall time, as the JAX package's
``serve_service``:

- :class:`~.service.ServeService` — the router process: listener,
  admission (quotas → bounded queue → SLO → WFQ), placement, streaming
  delivery, death recovery, autoscaled spawn/drain of real workers.
- ``serve_service.worker`` — the replica process entry point
  (``python -m distributed_tpu_torch.serve_service.worker``), which
  builds the model on ``ServeSpec.device`` (None = the card); never
  imported by this package.
- :mod:`~.protocol` — length-prefixed socket framing (JSON header +
  binary blobs) with torn-frame semantics, byte for byte the JAX
  package's frames.
- :mod:`~.transport` — KV payloads as ``.npy`` blocks: /dev/shm
  references same-host, framed blobs cross-host.
- :mod:`~.quotas` — per-tenant token buckets in front of the queue.

    spec = dtt.serve_service.ServeSpec(
        model=dict(vocab_size=32, num_layers=2, d_model=16, num_heads=2,
                   max_len=64), build_len=64, device="cpu")
    with dtt.serve_service.ServeService(spec, decode_replicas=2,
                                        prefill_replicas=1) as svc:
        outs = svc.run(requests)  # svc.run(...).telemetry: wall clock
"""

from .protocol import MAGIC, ProtocolError, recv_exact, recv_frame, send_frame
from .quotas import TenantQuotas, TokenBucket
from .service import ServeService, ServeSpec, ServiceResult, TokenStream
from .transport import (
    ShmTransport, TransportError, decode_payload, encode_payload,
    handoff_to_payload, payload_to_handoff, shm_root,
)

__all__ = [
    "MAGIC", "ProtocolError", "recv_exact", "recv_frame", "send_frame",
    "TenantQuotas", "TokenBucket",
    "ServeService", "ServeSpec", "ServiceResult", "TokenStream",
    "ShmTransport", "TransportError", "decode_payload", "encode_payload",
    "handoff_to_payload", "payload_to_handoff", "shm_root",
]
