"""Length-prefixed socket framing for the serving service.

One frame = a small JSON header plus zero or more raw binary blobs::

    b"DTS1" | u32 header_len | header JSON (utf-8)
           | per blob: u64 blob_len | blob bytes

The header is control-plane (message type, request ids, payload
metadata); blobs are data-plane (``.npy``-encoded KV blocks — see
``serve_service.transport``), so a multi-megabyte handoff never passes
through a JSON encoder. The framing is the cross-host twin of the
/dev/shm path: the SAME ``<leaf-path>@<logical-start>@<shape>``-keyed
payload travels, only the medium differs.

Failure semantics mirror the event log's torn-tail discipline
(``utils.events.read_events``), adapted to a stream: a peer closing
BETWEEN frames is a clean end (``recv_frame`` returns ``None``); a
stream ending MID-frame — a killed replica mid-send — raises
:class:`ProtocolError` so the reader treats the connection (and any
in-flight transfer on it) as lost, never as a short-but-plausible
frame. The frames are byte for byte the JAX package's
(``serve_service/protocol.py``), so either package's peer reads them.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Tuple

__all__ = ["MAGIC", "ProtocolError", "recv_exact", "recv_frame",
           "send_frame"]

MAGIC = b"DTS1"

#: Refuse headers beyond this — a corrupt length prefix must fail as a
#: protocol error, not as an attempted multi-gigabyte allocation.
MAX_HEADER_BYTES = 16 * 1024 * 1024


class ProtocolError(ConnectionError):
    """The stream died mid-frame or carried bytes that are not a frame.
    The connection is unusable; the caller must treat the peer as lost
    (the service requeues that replica's in-flight work)."""


def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`ProtocolError` — a short
    read here is a TORN frame (the peer died mid-send), and returning a
    prefix would let a half-shipped KV payload parse as a small one."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"torn frame: peer closed after {got} of {n} bytes"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock, header: dict, blobs: Tuple[bytes, ...] = ()) -> None:
    """Write one frame. ``header`` must be JSON-serializable; the blob
    count rides in the header (``_blobs``) so the reader knows how many
    length-prefixed sections follow."""
    body = dict(header)
    body["_blobs"] = len(blobs)
    enc = json.dumps(body).encode("utf-8")
    parts = [MAGIC, struct.pack(">I", len(enc)), enc]
    for blob in blobs:
        parts.append(struct.pack(">Q", len(blob)))
        parts.append(bytes(blob))
    sock.sendall(b"".join(parts))


def recv_frame(sock) -> Optional[Tuple[dict, List[bytes]]]:
    """Read one frame: ``(header, blobs)``. Returns ``None`` on a clean
    close (EOF exactly at a frame boundary); raises :class:`ProtocolError`
    on a torn frame, a bad magic, or an implausible header length."""
    first = sock.recv(len(MAGIC))
    if not first:
        return None  # clean EOF between frames
    magic = first
    while len(magic) < len(MAGIC):
        chunk = sock.recv(len(MAGIC) - len(magic))
        if not chunk:
            raise ProtocolError(
                f"torn frame: peer closed inside magic ({magic!r})"
            )
        magic += chunk
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    (hlen,) = struct.unpack(">I", recv_exact(sock, 4))
    if hlen > MAX_HEADER_BYTES:
        raise ProtocolError(f"header length {hlen} exceeds "
                            f"{MAX_HEADER_BYTES} — corrupt stream")
    try:
        header = json.loads(recv_exact(sock, hlen).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"unparseable frame header: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError(f"frame header must be an object, got "
                            f"{type(header).__name__}")
    blobs: List[bytes] = []
    for _ in range(int(header.pop("_blobs", 0))):
        (blen,) = struct.unpack(">Q", recv_exact(sock, 8))
        blobs.append(recv_exact(sock, blen))
    return header, blobs
