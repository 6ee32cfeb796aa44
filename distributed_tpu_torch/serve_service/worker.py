"""Replica worker process: one prefill or decode replica behind a socket.

``python -m distributed_tpu_torch.serve_service.worker`` is what
:class:`~distributed_tpu_torch.serve_service.service.ServeService` spawns per
replica. Configuration arrives the way every other process in this repo
is configured — environment, before library init:

- ``DTPU_CONFIG`` (the ``cluster.ClusterSpec`` contract):
  ``workers=[router_endpoint, own_endpoint]``, ``index=1`` — rank 0 is
  the chief, here the router; the worker dials ``spec.coordinator``.
- ``DTPU_SERVE_SPEC``: one JSON blob naming this worker, its role
  (``prefill``/``decode``), the model/engine spec to build (workers
  REBUILD the model from spec — ``Model.build`` draws from a seeded CPU
  generator, so every process holds byte-identical params and greedy
  decode is token-exact across the fleet), the device, the transport
  mode, and the shm root.
- ``DTPU_EVENT_LOG`` (inherited): events and flight dumps land in the
  service's log, same as supervised training workers.

The worker speaks ``serve_service.protocol`` frames over ONE connection
to the router and is single-threaded around a ``select`` loop: drain control
frames, then — decode role — advance the replica ONE ``step()`` and
stream every token the step produced back to the router immediately
(``{"type": "token", ...}`` per sequence, the ``on_decode_step`` seam
made inter-process). Scheduling semantics inside are EXACTLY
``fleet.replica``'s: handed-off KV installs pre-scatter-gated, stale
trims and incompatibilities fall back to re-prefill and count in the
same ``handoffs_fallback`` counter the in-process fleet pins.

Death paths: a ``kill`` frame dumps the flight recorder and ``os._exit``s
(the ``FaultInjector`` idiom — SIGKILL-abrupt as seen by the router, but
with a postmortem on disk); a vanished router is a clean exit.

It builds the model and runs its dispatches, so the package ``__init__``
never imports it. A copy of the JAX package's ``serve_service/worker.py``
over the port's model and fleet replicas.
"""

from __future__ import annotations

import json
import os
import select
import socket
import sys
import time
from typing import Dict, Optional

import numpy as np

from ..cluster import config as cluster_config
from ..obs import flight
from ..obs.export import prometheus_text
from ..obs.registry import default_registry
from ..utils import event_schema as evs
from ..utils.events import emit
from .protocol import ProtocolError, recv_frame, send_frame
from .service import ENV_SPEC
from .transport import (
    ShmTransport, TransportError, decode_payload, encode_payload,
    handoff_to_payload, payload_to_handoff,
)

DIAL_TIMEOUT_S = 60.0


def _dial(endpoint: str, timeout_s: float = DIAL_TIMEOUT_S) -> socket.socket:
    """Connect to the router, retrying with backoff — the worker may win
    the race against the router's ``listen()`` (same reason the cluster
    gang stack retries its coordinator dial)."""
    host, port = endpoint.rsplit(":", 1)
    deadline = time.monotonic() + timeout_s
    delay = 0.05
    while True:
        try:
            return socket.create_connection((host, int(port)), timeout=10.0)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(delay)
            delay = min(delay * 2, 1.0)


def _build_replica(spec: dict):
    """Model + programs + replica from the serve spec, on the spec's
    device (None = the card)."""
    from .. import models
    from ..fleet.replica import (
        DecodeReplica, EnginePrograms, PrefillReplica,
    )
    from ..training.model import Model

    model = Model(models.transformer_lm(**spec["model"]),
                  device=spec.get("device"))
    model.compile(optimizer=spec.get("optimizer", "sgd"),
                  loss=spec.get("loss", "sparse_categorical_crossentropy"))
    model.build((int(spec["build_len"]),), seed=0)
    programs = EnginePrograms(
        model,
        temperature=float(spec.get("temperature", 0.0)),
        top_k=spec.get("top_k"),
        seed=int(spec.get("seed", 0)),
    )
    eng = spec["engine"]
    if spec["role"] == "decode":
        replica = DecodeReplica(
            spec["name"], programs,
            max_slots=int(eng["max_slots"]),
            block_size=int(eng["block_size"]),
            max_len=int(eng["max_len"]),
            num_blocks=eng.get("num_blocks"),
            prefill_chunk=eng.get("prefill_chunk"),
            eos_id=eng.get("eos_id"),
            prefix_cache=bool(eng.get("prefix_cache", False)),
        )
    else:
        replica = PrefillReplica(
            spec["name"], programs,
            block_size=int(eng["block_size"]),
            max_len=int(eng["max_len"]),
            prefill_chunk=eng.get("prefill_chunk"),
        )
    return replica


def _rebuild_sequence(header: dict):
    """Sequence from a submit frame: prompt + previously generated tokens
    (a requeued sequence arrives with its streamed tokens, so the greedy
    re-prefill recomputes only what was never delivered)."""
    from ..serving.scheduler import Request, Sequence

    req = Request(
        np.asarray(header["prompt"], np.int32),
        int(header["max_new_tokens"]),
        seed=header.get("seed"),
        request_id=int(header["request_id"]),
    )
    seq = Sequence(req)
    for tok in header.get("generated", ()):
        seq.tokens.append(int(tok))
    seq.num_generated = len(header.get("generated", ()))
    return seq


class _Worker:
    def __init__(self, spec: dict, sock: socket.socket):
        self.spec = spec
        self.name = spec["name"]
        self.role = spec["role"]
        self.sock = sock
        self.replica = _build_replica(spec)
        self.transport = spec.get("transport", "none")
        self.store: Optional[ShmTransport] = None
        if self.transport == "shm":
            self.store = ShmTransport(spec["shm_root"], owner=False)
        self.sent: Dict[int, int] = {}  # request_id -> streamed generated
        self.draining = False
        self.reg = default_registry()

    # ----------------------------------------------------------- inbound
    def _resolve_payload(self, header: dict, blobs):
        """Submit-frame payload ref -> ``KVHandoff`` (or None for the
        re-prefill path). Transport failures NEVER fail the request —
        they emit ``transport_fallback`` and degrade to re-prefill, the
        same loud-but-safe contract as ``HandoffIncompatible``."""
        ref = header.get("payload")
        if not ref or self.role != "decode":
            return None
        rid = int(header["request_id"])
        try:
            if ref["kind"] == "shm":
                payload = self.store.get(ref)
                # The mmap stays valid after the unlink (POSIX); deleting
                # now reclaims the tmpfs RAM the moment the scatter ends.
                self.store.delete(ref)
            elif ref["kind"] == "inline":
                payload = decode_payload(ref["meta"], blobs)
            else:
                raise TransportError(f"unknown payload kind {ref['kind']!r}")
            handoff = payload_to_handoff(payload)
        except (TransportError, KeyError, AttributeError) as e:
            emit(evs.TRANSPORT_FALLBACK, request_id=rid,
                 reason=f"fetch: {e}", replica=self.name)
            self.reg.counter("serve.transport_fallback")
            return None
        if handoff.block_size != self.replica.kv.block_size:
            # Detectable before the replica even tries: the install WILL
            # take the pre-scatter HandoffIncompatible path and count a
            # fallback (we still hand the payload over, so the counter
            # moves), but the operator learns why from the event stream,
            # not from a counter diff.
            emit(evs.TRANSPORT_FALLBACK, request_id=rid,
                 reason=f"block_size {handoff.block_size} != "
                        f"{self.replica.kv.block_size}", replica=self.name)
            self.reg.counter("serve.transport_fallback")
        return handoff

    def _handle_submit(self, header: dict, blobs) -> None:
        seq = _rebuild_sequence(header)
        rid = seq.request.request_id
        now = time.monotonic()
        if self.role == "prefill":
            self._prefill(seq, header)
            return
        handoff = self._resolve_payload(header, blobs)
        if handoff is not None and self.replica.kv.prefix is not None:
            from ..fleet.handoff import trim_kv

            handoff, _skipped = trim_kv(handoff, self.replica.kv.prefix)
        self.replica.submit(seq, now, payload=handoff)
        self.sent[rid] = seq.num_generated
        flight.default_recorder().record(
            "serve_submit", replica=self.name, request_id=rid,
            queue=self.replica.queue_depth,
        )

    def _prefill(self, seq, header: dict) -> None:
        rid = seq.request.request_id
        try:
            spent, payload = self.replica.prefill(seq)
        except RuntimeError as e:
            # Context too big for the scratch pool: the decode side
            # re-prefills from scratch (it schedules chunks against its
            # own pool, which admission already sized for).
            send_frame(self.sock, {
                "type": "prefill_failed", "request_id": rid,
                "error": str(e),
            })
            return
        new = [int(t) for t in seq.tokens[seq.prompt_len:]]
        head = {
            "type": "prefilled", "request_id": rid, "tokens": new,
            "spent_s": round(spent, 6),
        }
        blobs = ()
        plain = handoff_to_payload(payload)
        if self.transport == "shm":
            head["payload"] = self.store.put(plain)
        elif self.transport == "inline":
            meta, blobs = encode_payload(plain)
            head["payload"] = {"kind": "inline", "meta": meta}
        send_frame(self.sock, head, tuple(blobs))
        self.reg.counter("serve.prefills")

    def _handle_frame(self, header: dict, blobs) -> bool:
        """Returns False when the worker should exit."""
        kind = header.get("type")
        if kind == "submit":
            self._handle_submit(header, blobs)
        elif kind == "kill":
            # The chaos path: postmortem first, then die as abruptly as
            # the router will observe a real crash (FaultInjector idiom).
            flight.dump(reason="replica_kill", replica=self.name)
            self.sock.close()
            os._exit(1)
        elif kind == "drain":
            self.draining = True
        elif kind == "scrape":
            self._publish_gauges()
            send_frame(self.sock, {
                "type": "scrape_result", "text": prometheus_text(),
            })
        elif kind == "stats":
            send_frame(self.sock, {
                "type": "stats_result", "replica": self.name,
                "role": self.role, **self._stats(),
            })
        elif kind == "shutdown":
            return False
        return True

    # ---------------------------------------------------------- outbound
    def _stream(self, finished) -> None:
        """Ship every not-yet-streamed generated token. Runs after each
        decode step, so a client sees tokens with one-step latency and a
        replica death can only ever cost recompute, never delivered
        tokens."""
        live = list(self.replica.sched.running) + list(finished)
        for seq in live:
            rid = seq.request.request_id
            done = self.sent.get(rid, 0)
            total = min(seq.num_generated, seq.request.max_new_tokens)
            if total > done:
                gen = seq.tokens[seq.prompt_len:]
                send_frame(self.sock, {
                    "type": "token", "request_id": rid, "start": done,
                    "tokens": [int(t) for t in gen[done:total]],
                })
                self.sent[rid] = total
        for seq in finished:
            self.sent.pop(seq.request.request_id, None)
            send_frame(self.sock, {
                "type": "finished",
                "request_id": seq.request.request_id,
                "output": [int(t) for t in seq.output()],
            })
            self.reg.counter("serve.finished")

    def _publish_gauges(self) -> None:
        r = self.replica
        self.reg.gauge("serve.queue_depth", getattr(r, "queue_depth", 0))
        self.reg.gauge("serve.running", getattr(r, "running", 0))
        self.reg.gauge("serve.busy_s", r.busy_s)

    def _stats(self) -> dict:
        r = self.replica
        base = {"busy_s": round(r.busy_s, 6), "pid": os.getpid()}
        if self.role == "decode":
            base.update(
                decode_steps=r.decode_steps,
                prefill_dispatches=r.prefill_dispatches,
                preemptions=r.preemptions,
                handoffs_installed=r.handoffs_installed,
                handoffs_fallback=r.handoffs_fallback,
                handoffs_trim_stale=r.handoffs_trim_stale,
                in_flight=r.in_flight,
            )
        else:
            base.update(prefills=r.prefills)
        return base

    # --------------------------------------------------------------- loop
    def run(self) -> int:
        send_frame(self.sock, {
            "type": "hello", "name": self.name, "role": self.role,
            "pid": os.getpid(),
        })
        decode = self.role == "decode"
        while True:
            busy = decode and self.replica.has_work
            try:
                ready, _, _ = select.select(
                    [self.sock], [], [], 0.0 if busy else 0.2
                )
            except OSError:
                return 0
            if ready:
                try:
                    frame = recv_frame(self.sock)
                except ProtocolError:
                    return 1  # router died mid-frame
                if frame is None:
                    return 0  # router closed: our work is over
                if not self._handle_frame(*frame):
                    return 0
            if decode and self.replica.has_work:
                spent, finished = self.replica.step(time.monotonic())
                flight.default_recorder().record(
                    "serve_step", replica=self.name,
                    running=self.replica.running,
                    queue=self.replica.queue_depth,
                    spent_s=round(spent, 6),
                    steps=self.replica.decode_steps,
                )
                self.reg.counter("serve.decode_steps")
                self.reg.counter("serve.device_s", spent)
                self._stream(finished)
            if self.draining and (not decode or not self.replica.has_work):
                send_frame(self.sock, {"type": "drained",
                                       "replica": self.name})
                return 0


def main() -> int:
    spec = json.loads(os.environ[ENV_SPEC])
    cluster = cluster_config.from_env()
    if cluster is None:
        raise SystemExit(f"{cluster_config.ENV_VAR} must be set for a "
                         "serve worker (rank 0 = router endpoint)")
    sock = _dial(cluster.coordinator)
    try:
        return _Worker(spec, sock).run()
    finally:
        sock.close()


if __name__ == "__main__":
    sys.exit(main())
