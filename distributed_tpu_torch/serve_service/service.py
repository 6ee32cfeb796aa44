"""The serving service: real replica processes behind a streaming router.

``fleet.ServingFleet`` composes prefill/decode replicas in ONE process on
a VIRTUAL clock — makespan there is parallel-composition arithmetic.
:class:`ServeService` is the same fleet made real: every replica is a
separate OS process (``serve_service.worker``) built from one
:class:`ServeSpec`, the router runs here, and every number in the
telemetry is wall time. The pieces are deliberately the ones the repo
already trusts:

- **Process topology.** The service listens on a loopback port; each
  worker gets the cluster contract (``DTPU_CONFIG`` with the service as
  rank 0 — the chief) plus ``DTPU_SERVE_SPEC``, dials in, and says
  ``hello`` once its model is built. Spawn→hello is the measured spin-up.
- **Scheduling.** Admission and ordering are EXACTLY ``fleet.Router``:
  bounded queue, SLO admission, WFQ — plus :class:`~.quotas.TenantQuotas`
  in FRONT of the queue (a flooding tenant throttles itself before it
  can occupy shared space). Placement is ``Router.place`` over worker
  handles (prefix affinity does not apply across processes today, so it
  degrades to the least-loaded + deterministic-tie rule).
- **KV transport.** Prefill→decode payloads move by reference over
  /dev/shm (``transport.ShmTransport``) or inline as ``.npy`` blobs in
  the submit frame — selected by ``transport=``; ``"none"`` disables
  handoff (decode re-prefills), the same degraded mode the in-process
  fleet has.
- **Streaming.** Workers push a ``token`` frame per sequence per decode
  step; :class:`TokenStream` surfaces them as an iterator while the
  service keeps a mirror of every in-flight sequence's tokens — which is
  also the recovery story: when a worker dies (EOF on its socket), its
  sequences are requeued WITH their streamed tokens, so the next replica
  re-prefills and continues, token-exact under greedy, and nothing the
  client saw is ever re-sent differently.
- **Scale.** ``QueueAutoscaler.decide`` runs on wall time and its target
  drives REAL ``spawn``/``drain`` of worker processes.

Single-threaded throughout: one ``select`` loop (``_pump``) owns every
socket. The model exists only in worker processes (on the card unless
``ServeSpec.device`` names another device); this module never sees an
array bigger than a token list.

A copy of the JAX package's ``serve_service/service.py``; the workers are
``python -m distributed_tpu_torch.serve_service.worker``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..cluster.config import ClusterSpec, ENV_VAR as CLUSTER_ENV
from ..fleet.autoscale import QueueAutoscaler
from ..fleet.router import Admission, Router
from ..obs.registry import default_registry
from ..utils import event_schema as evs
from ..utils.events import emit
from .protocol import ProtocolError, recv_frame, send_frame
from .quotas import TenantQuotas
from .transport import shm_root

__all__ = ["ServeSpec", "ServeService", "ServiceResult", "TokenStream"]

#: Env var carrying one worker's JSON blob (``ServeSpec.worker_blob``).
ENV_SPEC = "DTPU_SERVE_SPEC"

HELLO_TIMEOUT_S = 180.0  # torch import, CUDA context, model build


@dataclasses.dataclass
class ServeSpec:
    """Everything a worker needs to rebuild the model and its replica —
    the cross-process twin of handing ``(model, programs)`` to a
    ``ServingFleet``. Workers rebuild from this spec; ``Model.build``
    draws from a seeded CPU generator, so every process holds
    byte-identical params. ``device``: where the workers build the model
    (None = the card, as every entry point of the port)."""

    model: Dict[str, Any]  # transformer_lm(**model) kwargs incl. vocab
    build_len: int  # model.build((build_len,))
    optimizer: str = "sgd"
    loss: str = "sparse_categorical_crossentropy"
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0
    max_slots: int = 2
    block_size: int = 4
    max_len: int = 64
    num_blocks: Optional[int] = None
    prefill_chunk: Optional[int] = None
    eos_id: Optional[int] = None
    prefix_cache: bool = False
    device: Optional[str] = None

    def engine(self, **overrides) -> dict:
        eng = {
            "max_slots": self.max_slots, "block_size": self.block_size,
            "max_len": self.max_len, "num_blocks": self.num_blocks,
            "prefill_chunk": self.prefill_chunk, "eos_id": self.eos_id,
            "prefix_cache": self.prefix_cache,
        }
        eng.update(overrides)
        return eng

    def worker_blob(self, name: str, role: str, *, transport: str,
                    shm_root: Optional[str],
                    engine_overrides: Optional[dict] = None) -> str:
        """The ``DTPU_SERVE_SPEC`` JSON for one worker."""
        return json.dumps({
            "name": name, "role": role, "transport": transport,
            "shm_root": shm_root, "model": self.model,
            "build_len": self.build_len, "optimizer": self.optimizer,
            "loss": self.loss, "temperature": self.temperature,
            "top_k": self.top_k, "seed": self.seed, "device": self.device,
            "engine": self.engine(**(engine_overrides or {})),
        })


class TokenStream:
    """Streaming handle for one accepted request. ``tokens`` grows as
    decode steps land on whatever worker currently runs the request;
    iterating yields each GENERATED token once, pumping the service while
    waiting, and ends when the request completes. ``result()`` drains and
    returns the full prompt+generated row (``Engine.run`` shape)."""

    def __init__(self, service: "ServeService", seq):
        self._service = service
        self.seq = seq
        self.request_id = seq.request.request_id
        self.tokens: List[int] = []  # generated tokens, in stream order
        self.output: Optional[np.ndarray] = None  # set at finish

    @property
    def done(self) -> bool:
        return self.output is not None

    def _feed(self, start: int, toks) -> None:
        """Apply one token frame. A requeued request's new worker streams
        from where delivery stopped, so overlap means a recompute
        diverged — that must fail loudly, it breaks the token-exact
        recovery contract."""
        for i, tok in enumerate(toks, int(start)):
            if i < len(self.tokens):
                if self.tokens[i] != int(tok):
                    raise RuntimeError(
                        f"request {self.request_id}: recompute diverged at "
                        f"generated token {i}: streamed {self.tokens[i]}, "
                        f"got {tok}"
                    )
            elif i == len(self.tokens):
                self.tokens.append(int(tok))
            else:
                raise RuntimeError(
                    f"request {self.request_id}: token gap (have "
                    f"{len(self.tokens)}, frame starts at {i})"
                )

    def __iter__(self):
        cursor = 0
        while True:
            while cursor < len(self.tokens):
                yield self.tokens[cursor]
                cursor += 1
            if self.done:
                return
            self._service._pump(0.05)

    def result(self) -> np.ndarray:
        for _ in self:
            pass
        return self.output


class ServiceResult(list):
    """Per-request outputs in submit order (None for rejected), with the
    run telemetry attached — the ``FleetResult`` shape on wall time."""

    telemetry: dict = {}


class _WorkerHandle:
    """Service-side view of one worker process. Exposes the placement
    signals ``Router.place`` reads (no ``holds_prefix`` — affinity is 0
    across processes, degrading placement to least-loaded)."""

    def __init__(self, name: str, role: str,
                 proc: Optional[subprocess.Popen] = None,
                 spawned_at: Optional[float] = None):
        self.name = name
        self.role = role
        self.proc = proc
        self.spawned_at = spawned_at
        self.sock: Optional[socket.socket] = None
        self.pid: Optional[int] = None
        self.assigned: Dict[int, Any] = {}  # request_id -> Sequence
        self.spinup_s: Optional[float] = None
        self.draining = False
        self.drained = False  # graceful exit acknowledged
        self.stats: Optional[dict] = None

    @property
    def ready(self) -> bool:
        return self.sock is not None

    @property
    def in_flight(self) -> int:
        return len(self.assigned)

    @property
    def queue_depth(self) -> int:
        return len(self.assigned)

    def send(self, header: dict, blobs: Tuple[bytes, ...] = ()) -> bool:
        """False when the worker is already gone (the EOF will surface in
        the next pump and trigger the death path — don't raise here)."""
        try:
            send_frame(self.sock, header, blobs)
            return True
        except OSError:
            return False


class ServeService:
    """See module docstring.

    ``transport``: ``"shm"`` (payload by /dev/shm reference, same-host),
    ``"inline"`` (``.npy`` blobs in the frame — what a cross-host socket
    would carry), or ``"none"`` (no handoff; decode re-prefills).
    ``spawn=False`` starts only the listener — tests dial in stub workers
    over the same protocol."""

    def __init__(self, spec: ServeSpec, *, decode_replicas: int = 1,
                 prefill_replicas: int = 0,
                 router: Optional[Router] = None,
                 quotas: Optional[TenantQuotas] = None,
                 autoscaler: Optional[QueueAutoscaler] = None,
                 transport: str = "shm", spawn: bool = True,
                 respawn: bool = True,
                 dispatch_window: Optional[int] = None,
                 engine_overrides: Optional[Dict[str, dict]] = None,
                 log_dir: Optional[str] = None):
        if transport not in ("shm", "inline", "none"):
            raise ValueError(f"transport must be shm|inline|none, "
                             f"got {transport!r}")
        self.spec = spec
        self.router = router or Router()
        self.quotas = quotas
        self.autoscaler = autoscaler
        self.transport = transport
        self.spawn = bool(spawn)
        self.respawn = bool(respawn)
        # Per-role engine overrides ({"decode": {...}, "prefill": {...}}):
        # heterogeneous pools — also how tests provoke a real cross-
        # process HandoffIncompatible (mismatched block_size).
        self.engine_overrides = dict(engine_overrides or {})
        # How many requests may sit AT a decode worker beyond its slots:
        # small, so the backlog stays in the router where WFQ/SLO/scaling
        # signals can see and reorder it.
        self.dispatch_window = (
            int(dispatch_window) if dispatch_window is not None
            else spec.max_slots + 1
        )
        self._target_decode = int(decode_replicas)
        self._target_prefill = int(prefill_replicas)
        self._handles: Dict[str, _WorkerHandle] = {}
        self._names = {"decode": 0, "prefill": 0}
        self._listener: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._shm_root: Optional[Path] = None
        self.log_dir = Path(log_dir) if log_dir else None
        self._t0 = time.monotonic()
        self._streams: Dict[int, TokenStream] = {}
        self._payloads: Dict[int, tuple] = {}  # rid -> (ref, blobs)
        self._rows: Dict[int, dict] = {}  # per-request lifecycle rows
        self._recent_ttft: deque = deque(maxlen=32)
        self._scrapes: Dict[str, str] = {}
        self.kills = 0
        self.spawns = 0
        self.finished = 0
        self.accepted = 0
        self.queue_depth_peak = 0
        self.reg = default_registry()

    # ----------------------------------------------------------- lifecycle
    def _now(self) -> float:
        return time.monotonic() - self._t0

    def start(self, *, wait: Optional[bool] = None,
              timeout_s: float = HELLO_TIMEOUT_S) -> "ServeService":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        if self.transport == "shm":
            self._shm_root = shm_root()
        if self.log_dir is None:
            self.log_dir = Path(tempfile.mkdtemp(prefix="dtpu-serve-logs-"))
        emit(evs.SERVICE_START, decode_replicas=self._target_decode,
             prefill_replicas=self._target_prefill,
             transport=self.transport, port=self.port)
        if self.spawn:
            for _ in range(self._target_decode):
                self._spawn("decode")
            for _ in range(self._target_prefill):
                self._spawn("prefill")
        if self.spawn if wait is None else wait:
            self.wait_ready(timeout_s=timeout_s)
        return self

    def _spawn(self, role: str,
               engine_overrides: Optional[dict] = None) -> _WorkerHandle:
        name = f"{role}-{self._names[role]}"
        self._names[role] += 1
        env = dict(os.environ)
        env[CLUSTER_ENV] = ClusterSpec(
            workers=[f"127.0.0.1:{self.port}", "127.0.0.1:0"], index=1,
        ).to_json()
        env[ENV_SPEC] = self.spec.worker_blob(
            name, role, transport=self.transport,
            shm_root=str(self._shm_root) if self._shm_root else None,
            engine_overrides=(engine_overrides
                              if engine_overrides is not None
                              else self.engine_overrides.get(role)),
        )
        out = open(self.log_dir / f"{name}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "distributed_tpu_torch.serve_service.worker"],
            env=env, stdout=out, stderr=subprocess.STDOUT,
        )
        out.close()  # the child holds its own fd now
        handle = _WorkerHandle(name, role, proc, spawned_at=self._now())
        self._handles[name] = handle
        self.spawns += 1
        return handle

    def wait_ready(self, *, timeout_s: float = HELLO_TIMEOUT_S) -> None:
        """Pump until every spawned worker said hello (model built, ready
        for traffic)."""
        deadline = time.monotonic() + timeout_s
        while any(not h.ready for h in self._handles.values()):
            if time.monotonic() > deadline:
                missing = [h.name for h in self._handles.values()
                           if not h.ready]
                raise TimeoutError(
                    f"workers never said hello: {missing} (logs under "
                    f"{self.log_dir})"
                )
            self._pump(0.2)

    def stop(self) -> None:
        for h in list(self._handles.values()):
            if h.sock is not None:
                h.send({"type": "shutdown"})
                h.sock.close()
                h.sock = None
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait()
        self._handles.clear()
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        if self._shm_root is not None:
            import shutil

            shutil.rmtree(self._shm_root, ignore_errors=True)
            self._shm_root = None

    def __enter__(self) -> "ServeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission
    def submit(self, request, *, tenant: str = "default",
               now: Optional[float] = None
               ) -> Tuple[Admission, Optional[TokenStream]]:
        """Quota gate, then router admission; accepted requests get a
        :class:`TokenStream`. Rejections carry reason ``"quota"``,
        ``"queue_full"``, or ``"slo"``."""
        t = self._now() if now is None else float(now)
        if self.quotas is not None:
            cost = request.prompt.size + request.max_new_tokens
            ok, retry = self.quotas.admit(tenant, cost, t)
            if not ok:
                emit(evs.QUOTA_REJECT, tenant=tenant,
                     request_id=request.request_id,
                     retry_after_s=round(retry, 4))
                self.reg.counter("serve.quota_rejects")
                return Admission(False, "quota"), None
        adm, seq = self.router.submit(request, tenant=tenant, now=t)
        if not adm.accepted:
            return adm, None
        stream = TokenStream(self, seq)
        self._streams[request.request_id] = stream
        self._rows[request.request_id] = {"tenant": tenant,
                                          "submitted_at": t}
        self.accepted += 1
        emit(evs.STREAM_OPEN, request_id=request.request_id, tenant=tenant)
        return adm, stream

    # ------------------------------------------------------------- routing
    def _pool(self, role: str, *, ready_only: bool = True
              ) -> List[_WorkerHandle]:
        return [h for h in self._handles.values()
                if h.role == role and not h.draining
                and (h.ready or not ready_only)]

    def _dispatch_decode(self, seq) -> None:
        pool = self._pool("decode")
        under = [h for h in pool
                 if h.in_flight < self.spec.max_slots + self.dispatch_window]
        rep = self.router.place(seq, under or pool)
        if rep is None:  # no live decode worker: back to the queue
            self.router.requeue([seq], self._now())
            return
        rid = seq.request.request_id
        head = {
            "type": "submit", "request_id": rid,
            "prompt": [int(t) for t in seq.request.prompt],
            "max_new_tokens": int(seq.request.max_new_tokens),
            "seed": seq.request.seed,
            "generated": [int(t) for t in seq.tokens[seq.prompt_len:]],
        }
        blobs: Tuple[bytes, ...] = ()
        stored = self._payloads.pop(rid, None)
        if stored is not None:
            head["payload"], blobs = stored
        rep.assigned[rid] = seq
        rep.send(head, blobs)

    def _dispatch_prefill(self, h: _WorkerHandle, seq) -> None:
        rid = seq.request.request_id
        h.assigned[rid] = seq
        h.send({
            "type": "submit", "request_id": rid,
            "prompt": [int(t) for t in seq.request.prompt],
            "max_new_tokens": int(seq.request.max_new_tokens),
            "seed": seq.request.seed,
        })

    def _route(self, now: float) -> None:
        self.queue_depth_peak = max(self.queue_depth_peak,
                                    self.router.queue_depth)
        while True:
            seq = self.router.peek()
            if seq is None:
                break
            prefill_pool = self._pool("prefill")
            use_prefill = bool(prefill_pool) and self.transport != "none"
            if seq.num_generated == 0 and use_prefill:
                # Fresh request, prefill pool alive: disaggregation means
                # the WFQ head WAITS for a prefill slot rather than
                # burning decode steps on prompt work. (If the pool dies,
                # use_prefill flips off and decode re-prefills.)
                free = [h for h in prefill_pool if h.in_flight == 0]
                if not free:
                    break
                self.router.next_request()
                self._dispatch_prefill(free[0], seq)
                continue
            decode_room = any(
                h.in_flight < self.spec.max_slots + self.dispatch_window
                for h in self._pool("decode")
            )
            if not decode_room:
                break
            self.router.next_request()
            self._dispatch_decode(seq)

    # -------------------------------------------------------------- frames
    def _on_token(self, seq, start: int, toks, now: float) -> None:
        stream = self._streams.get(seq.request.request_id)
        if stream is not None:
            stream._feed(start, toks)
        # Mirror into the service-side sequence: a requeue after a worker
        # death re-submits exactly the delivered tokens.
        have = len(seq.tokens) - seq.prompt_len
        for i, tok in enumerate(toks, int(start)):
            if i >= have:
                seq.tokens.append(int(tok))
                seq.num_generated += 1
                have += 1
        row = self._rows.get(seq.request.request_id)
        if row is not None and toks and "first_token_at" not in row:
            row["first_token_at"] = now
            seq.first_token_at = now

    def _on_finished(self, h: _WorkerHandle, header: dict,
                     now: float) -> None:
        rid = int(header["request_id"])
        seq = h.assigned.pop(rid, None)
        output = [int(t) for t in header["output"]]
        stream = self._streams.get(rid)
        prompt_len = (stream.seq.prompt_len if stream is not None
                      else (seq.prompt_len if seq is not None
                            else len(output)))
        gen = output[prompt_len:]
        if stream is not None and not stream.done:
            # Feeding the whole generated span from 0 both delivers any
            # tail the per-step stream had not shipped yet AND verifies
            # every already-streamed token against the final output (the
            # byte-identity contract), then seals the stream.
            stream._feed(0, gen)
            stream.output = np.asarray(output, np.int32)
        row = self._rows.get(rid)
        if row is not None:
            row.setdefault("first_token_at", now)
            row["finished_at"] = now
            row["generated"] = len(gen)
            ttft = row["first_token_at"] - row["submitted_at"]
            self._recent_ttft.append(ttft)
        if seq is not None:
            seq.finished_at = now
        self.finished += 1
        self.router.observe_finish(now)
        self.reg.counter("service.finished")

    def _on_prefilled(self, h: _WorkerHandle, header: dict, blobs,
                      now: float) -> None:
        rid = int(header["request_id"])
        seq = h.assigned.pop(rid, None)
        if seq is None:
            return
        toks = header.get("tokens", ())
        self._on_token(seq, 0, toks, now)
        ref = header.get("payload")
        if ref is not None:
            self._payloads[rid] = (ref, tuple(blobs))
        if seq.finished:  # max_new_tokens == 1: prefill was the request
            self._finish_local(seq, now)
        else:
            self._dispatch_decode(seq)

    def _finish_local(self, seq, now: float) -> None:
        """Seal a request that completed without a decode worker."""
        rid = seq.request.request_id
        self._payloads.pop(rid, None)
        stream = self._streams.get(rid)
        if stream is not None:
            stream.output = seq.output()
        row = self._rows.get(rid)
        if row is not None:
            row.setdefault("first_token_at", now)
            row["finished_at"] = now
            row["generated"] = seq.num_generated
            self._recent_ttft.append(
                row["first_token_at"] - row["submitted_at"]
            )
        self.finished += 1
        self.router.observe_finish(now)

    def _on_frame(self, h: _WorkerHandle, header: dict, blobs) -> None:
        kind = header.get("type")
        now = self._now()
        if kind == "token":
            seq = h.assigned.get(int(header["request_id"]))
            if seq is not None:
                self._on_token(seq, int(header["start"]),
                               header["tokens"], now)
        elif kind == "finished":
            self._on_finished(h, header, now)
        elif kind == "prefilled":
            self._on_prefilled(h, header, blobs, now)
        elif kind == "prefill_failed":
            seq = h.assigned.pop(int(header["request_id"]), None)
            if seq is not None:
                emit(evs.TRANSPORT_FALLBACK,
                     request_id=seq.request.request_id,
                     reason=f"prefill_failed: {header.get('error')}",
                     replica=h.name)
                self._dispatch_decode(seq)
        elif kind == "scrape_result":
            self._scrapes[h.name] = header.get("text", "")
        elif kind == "stats_result":
            h.stats = {k: v for k, v in header.items()
                       if k not in ("type",)}
        elif kind == "drained":
            h.drained = True

    # --------------------------------------------------------------- death
    def _on_worker_death(self, h: _WorkerHandle) -> None:
        now = self._now()
        if h.sock is not None:
            h.sock.close()
            h.sock = None
        if h.proc is not None:
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait()
        self._handles.pop(h.name, None)
        if h.drained or h.draining:
            return  # graceful exit, nothing in flight by contract
        seqs = list(h.assigned.values())
        for seq in seqs:
            # The payload (if any) died with the worker's pool; requeued
            # sequences re-prefill their delivered context on the next
            # replica (token-exact under greedy).
            self._payloads.pop(seq.request.request_id, None)
        if seqs:
            self.router.requeue(seqs, now)
        emit(evs.FLEET_REPLICA_KILLED, replica=h.name, requeued=len(seqs))
        self.kills += 1
        self.reg.counter("service.kills")
        target = (self._target_decode if h.role == "decode"
                  else self._target_prefill)
        if self.spawn and self.respawn:
            have = len([x for x in self._handles.values()
                        if x.role == h.role and not x.draining])
            if have < target:
                self._spawn(h.role)

    @property
    def streamed_tokens(self) -> int:
        """Tokens delivered to clients so far, across all open and
        finished streams — the bench kill row uses it to time the kill
        mid-decode instead of guessing a wall delay."""
        return sum(len(s.tokens) for s in self._streams.values())

    def kill_replica(self, name: str) -> None:
        """Chaos switch: the worker dumps its flight recorder and
        ``os._exit``s — the service sees the same abrupt EOF a real crash
        produces, and the postmortem lands on disk."""
        h = self._handles.get(name)
        if h is None or h.sock is None:
            raise KeyError(f"no live worker {name!r}")
        h.send({"type": "kill"})

    # ----------------------------------------------------------- autoscale
    def _autoscale(self, now: float) -> None:
        if self.autoscaler is None or not self.spawn:
            return
        decode = [h for h in self._handles.values()
                  if h.role == "decode" and not h.draining]
        queue = self.router.queue_depth + sum(
            max(0, h.in_flight - self.spec.max_slots) for h in decode
        )
        free = sum(max(0, self.spec.max_slots - h.in_flight)
                   for h in decode if h.ready)
        p99 = (float(np.percentile(list(self._recent_ttft), 99))
               if len(self._recent_ttft) >= 4 else None)
        target = self.autoscaler.decide(
            now, queue_depth=queue, replicas=max(1, len(decode)),
            free_slots=free, slots_per_replica=self.spec.max_slots,
            recent_p99_ttft=p99,
        )
        self._target_decode = target
        while len([h for h in self._handles.values()
                   if h.role == "decode" and not h.draining]) < target:
            self._spawn("decode")
        excess = [h for h in decode if h.ready]
        live = len(excess)
        if live > target:
            # Drain the emptiest replica; it finishes in-flight work,
            # acknowledges, and exits — never a requeue.
            victim = min(excess, key=lambda h: (h.in_flight, h.name))
            victim.draining = True
            victim.send({"type": "drain"})

    # ----------------------------------------------------------------- pump
    def _accept(self) -> None:
        conn, _ = self._listener.accept()
        conn.settimeout(30.0)
        try:
            frame = recv_frame(conn)
        except (ProtocolError, OSError):
            conn.close()
            return
        if frame is None:
            conn.close()
            return
        header, _ = frame
        conn.settimeout(None)
        name = header.get("name", "")
        h = self._handles.get(name)
        if h is None:  # stub workers (spawn=False tests) register here
            h = _WorkerHandle(name, header.get("role", "decode"))
            self._handles[name] = h
        h.sock = conn
        h.pid = header.get("pid")
        if h.spawned_at is not None:
            h.spinup_s = self._now() - h.spawned_at
        emit(evs.REPLICA_SPAWN, replica=name, role=h.role, pid=h.pid,
             spinup_s=round(h.spinup_s, 4) if h.spinup_s else None)

    def _pump(self, timeout: float = 0.05) -> None:
        """One service iteration: route queued work, wait up to
        ``timeout`` for socket activity, apply every readable frame,
        reap deaths, autoscale. All service progress happens here."""
        now = self._now()
        self._route(now)
        socks = [self._listener] if self._listener is not None else []
        by_sock = {}
        for h in self._handles.values():
            if h.sock is not None:
                socks.append(h.sock)
                by_sock[h.sock] = h
        if not socks:
            return
        try:
            ready, _, _ = select.select(socks, [], [], timeout)
        except OSError:
            ready = []
        for s in ready:
            if s is self._listener:
                self._accept()
                continue
            h = by_sock[s]
            try:
                frame = recv_frame(s)
            except (ProtocolError, OSError):
                frame = None
            if frame is None:
                self._on_worker_death(h)
                continue
            self._on_frame(h, *frame)
            if h.drained:
                self._on_worker_death(h)
        # Reap workers that died without a connection (spawn crash).
        for h in list(self._handles.values()):
            if (h.sock is None and h.proc is not None
                    and h.proc.poll() is not None):
                self._on_worker_death(h)
        self._autoscale(self._now())
        self._route(self._now())

    # ------------------------------------------------------------- scraping
    def scrape(self, *, timeout_s: float = 10.0) -> Dict[str, str]:
        """Live Prometheus exposition from every ready worker (the
        ``obs/export.py`` text format, rendered in each replica process)."""
        self._scrapes = {}
        targets = [h for h in self._handles.values() if h.ready]
        for h in targets:
            h.send({"type": "scrape"})
        deadline = time.monotonic() + timeout_s
        while (len(self._scrapes) < len(targets)
               and time.monotonic() < deadline):
            self._pump(0.05)
        return dict(self._scrapes)

    def collect_stats(self, *, timeout_s: float = 10.0
                      ) -> Dict[str, dict]:
        targets = [h for h in self._handles.values() if h.ready]
        for h in targets:
            h.stats = None
            h.send({"type": "stats"})
        deadline = time.monotonic() + timeout_s
        while (any(h.stats is None for h in targets
                   if h.name in self._handles)
               and time.monotonic() < deadline):
            self._pump(0.05)
        return {h.name: h.stats for h in targets if h.stats is not None}

    # ------------------------------------------------------------------ run
    def run(self, requests, *, arrival_times=None, tenants=None,
            deadline_s: float = 300.0, on_pump=None) -> ServiceResult:
        """Open-loop wall-clock run: submit each request at its arrival
        offset (seconds from now; None = all at once), pump until every
        accepted request finishes, return outputs + telemetry.
        ``on_pump(service)``, when given, runs once per loop iteration —
        the seam chaos harnesses use to kill a replica mid-run."""
        n = len(requests)
        arrivals = ([0.0] * n if arrival_times is None
                    else [float(a) for a in arrival_times])
        tenant_of = (["default"] * n if tenants is None else list(tenants))
        order = sorted(range(n), key=lambda i: arrivals[i])
        start = self._now()
        t_start = time.monotonic()
        streams: Dict[int, Optional[TokenStream]] = {}
        admissions: Dict[int, Admission] = {}
        i = 0
        while True:
            now = self._now()
            while i < n and now - start >= arrivals[order[i]]:
                idx = order[i]
                adm, stream = self.submit(requests[idx],
                                          tenant=tenant_of[idx], now=now)
                admissions[idx] = adm
                streams[idx] = stream
                i += 1
                now = self._now()
            open_streams = [s for s in streams.values()
                            if s is not None and not s.done]
            if i >= n and not open_streams:
                break
            if time.monotonic() - t_start > deadline_s:
                raise TimeoutError(
                    f"service run exceeded {deadline_s}s with "
                    f"{len(open_streams)} requests open (logs under "
                    f"{self.log_dir})"
                )
            if on_pump is not None:
                on_pump(self)
            self._pump(0.02 if open_streams else 0.05)
        wall = self._now() - start
        result = ServiceResult(
            streams[idx].output if streams.get(idx) is not None else None
            for idx in range(n)
        )
        result.telemetry = self._finalize_telemetry(wall, admissions)
        return result

    def _finalize_telemetry(self, wall: float,
                            admissions: Dict[int, Admission]) -> dict:
        rows = [r for r in self._rows.values() if "finished_at" in r]
        ttfts = sorted(r["first_token_at"] - r["submitted_at"]
                       for r in rows)
        gen_tokens = sum(r.get("generated", 0) for r in rows)
        rejected = sum(1 for a in admissions.values() if not a.accepted)
        spinups = [h.spinup_s for h in self._handles.values()
                   if h.spinup_s is not None]
        tel = {
            "clock": "wall",
            "wall_s": round(wall, 4),
            "requests": len(admissions) or self.accepted,
            "accepted": self.accepted,
            "rejected": rejected,
            "finished": self.finished,
            "lost_requests": self.accepted - self.finished,
            "generated_tokens": gen_tokens,
            "tokens_per_sec": round(gen_tokens / wall, 4) if wall > 0
            else 0.0,
            "time_to_first_token": {
                "p50_s": round(float(np.percentile(ttfts, 50)), 4)
                if ttfts else None,
                "p99_s": round(float(np.percentile(ttfts, 99)), 4)
                if ttfts else None,
            },
            "decode_pool": {
                "replicas": len([h for h in self._handles.values()
                                 if h.role == "decode"]),
                "kills": self.kills,
                "spawns": self.spawns,
                "spinup_s": [round(s, 4) for s in spinups],
                "events": list(self.autoscaler.events)
                if self.autoscaler else [],
            },
            "transport": self.transport,
            "router": self.router.telemetry(),
            "queue_depth_peak": self.queue_depth_peak,
        }
        by_tenant: Dict[str, list] = {}
        for r in rows:
            by_tenant.setdefault(r.get("tenant", "default"), []).append(
                r["first_token_at"] - r["submitted_at"])
        tel["tenants"] = {
            t: {
                "finished": len(v),
                "ttft_p50_s": round(float(np.percentile(v, 50)), 4),
                "ttft_p99_s": round(float(np.percentile(v, 99)), 4),
            }
            for t, v in sorted(by_tenant.items())
        }
        if self.quotas is not None:
            tel["quotas"] = self.quotas.telemetry()
        self.reg.set_report("service.run", tel)
        return tel
