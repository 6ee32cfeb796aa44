"""KV-handoff transport: ``.npy`` blocks over /dev/shm, or framed bytes.

The in-process fleet hands ``KVHandoff`` payloads between replicas as a
Python dict. Across PROCESSES the payload needs an encoding, and the
repo already has the right one: the ``BuddyStore`` mirror layout
(``resilience/redundancy.py``) — raw ``.npy`` blocks plus a
``manifest.json`` commit marker, written to a tmp sibling and renamed
into place so a reader never sees a torn payload, mmap-read on the
receiving side. This module applies that layout to handoff payloads:

- **shm path** (same host): :class:`ShmTransport` writes each block as
  ``block-<i>.npy`` under a tmpfs directory and ships only a REFERENCE
  (the directory path) over the control socket; the receiver
  ``np.load(..., mmap_mode="r")``'s the blocks — zero copies until the
  scatter reads them.
- **socket path** (cross-host): :func:`encode_payload` renders the same
  blocks to ``.npy`` bytes carried as binary blobs of one
  ``serve_service.protocol`` frame — the identical
  ``<leaf-path>@<logical-start>@<shape>`` keys travel in the header.

Payloads move as PLAIN DICTS here (``handoff_to_payload`` /
``payload_to_handoff`` convert at the ``KVHandoff`` boundary), so this
module needs numpy alone. The suffix-only ``trim_kv`` semantics ride the
encoding untouched: ``prefix_hashes`` and ``skip_blocks`` are part of the
manifest, and the receiver applies the same stale-trim re-prefill guard
as the in-process fleet (``DecodeReplica._admit``).

The encodings are the JAX package's (``serve_service/transport.py``): an
f32 or int8 payload is the same bytes from either package, and either
package's ``ShmTransport.get`` reads the other's directories. A bf16
leaf travels as its 16 bits (``uint16`` blocks) with ``dtype``
``"bfloat16"`` in the manifest (``fleet.handoff``).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "TransportError", "ShmTransport", "encode_payload", "decode_payload",
    "handoff_to_payload", "payload_to_handoff", "shm_root",
]

#: Scalar metadata a payload dict carries next to its ``blocks`` —
#: exactly the ``KVHandoff`` fields (``fleet.handoff``).
#: ``weights_version`` is the gossip staleness stamp (None on the plain
#: prefill→decode path); meta reads use ``.get`` so a manifest written
#: before the stamp existed still decodes.
PAYLOAD_META = ("cached_len", "block_size", "dtype", "prefix_hashes",
                "skip_blocks", "weights_version")

MANIFEST = "manifest.json"


class TransportError(RuntimeError):
    """The payload could not be fetched (missing/uncommitted shm dir,
    corrupt block). The caller falls back to re-prefill — the same loud,
    safe degradation as ``HandoffIncompatible``."""


# ----------------------------------------------------------- conversions
def handoff_to_payload(handoff) -> dict:
    """``KVHandoff`` -> plain payload dict (duck-typed attribute reads)."""
    return {
        "blocks": dict(handoff.blocks),
        "cached_len": int(handoff.cached_len),
        "block_size": int(handoff.block_size),
        "dtype": str(handoff.dtype),
        "prefix_hashes": list(handoff.prefix_hashes),
        "skip_blocks": int(handoff.skip_blocks),
        "weights_version": getattr(handoff, "weights_version", None),
    }


def payload_to_handoff(payload: dict):
    """Plain payload dict -> ``KVHandoff``. Imported lazily: only the
    replica worker, which owns a pool, crosses this boundary."""
    from ..fleet.handoff import KVHandoff

    return KVHandoff(
        blocks=dict(payload["blocks"]),
        cached_len=int(payload["cached_len"]),
        block_size=int(payload["block_size"]),
        dtype=str(payload["dtype"]),
        prefix_hashes=tuple(payload.get("prefix_hashes", ())),
        skip_blocks=int(payload.get("skip_blocks", 0)),
        weights_version=payload.get("weights_version"),
    )


def payload_nbytes(payload: dict) -> int:
    return int(sum(a.nbytes for a in payload["blocks"].values()))


# -------------------------------------------------------- socket framing
def encode_payload(payload: dict) -> Tuple[dict, List[bytes]]:
    """``(meta, blobs)`` for one protocol frame: ``meta["keys"]`` lists
    the block keys in blob order, each blob one ``.npy``-encoded block
    (dtype and shape self-describing — the reader never trusts the
    header for array geometry)."""
    keys = sorted(payload["blocks"])
    blobs: List[bytes] = []
    for key in keys:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(payload["blocks"][key]),
                allow_pickle=False)
        blobs.append(buf.getvalue())
    meta = {k: payload.get(k) for k in PAYLOAD_META}
    meta["keys"] = keys
    return meta, blobs


def decode_payload(meta: dict, blobs: List[bytes]) -> dict:
    keys = list(meta["keys"])
    if len(keys) != len(blobs):
        raise TransportError(
            f"payload meta names {len(keys)} blocks but frame carried "
            f"{len(blobs)} blobs"
        )
    blocks: Dict[str, np.ndarray] = {}
    for key, blob in zip(keys, blobs):
        try:
            blocks[key] = np.load(io.BytesIO(blob), allow_pickle=False)
        except (ValueError, OSError) as e:
            raise TransportError(f"corrupt .npy block {key!r}: {e}") from e
    out = {k: meta.get(k) for k in PAYLOAD_META}
    out["blocks"] = blocks
    return out


# ------------------------------------------------------------- shm store
def shm_root(prefix: str = "dtpu-serve-") -> Path:
    """A fresh RAM-backed directory (tmpfs ``/dev/shm`` when writable,
    else the system temp dir) — the ``resilience.redundancy.ram_dir``
    idiom, re-stated here so the transport needs numpy alone."""
    shm = Path("/dev/shm")
    base = shm if (shm.is_dir() and os.access(shm, os.W_OK)) else None
    return Path(tempfile.mkdtemp(prefix=prefix, dir=base))


class ShmTransport:
    """Same-host payload store over tmpfs.

    ``put`` writes ``payload-<n>.tmp-<pid>/`` (blocks + manifest), then
    renames to ``payload-<n>/`` — the BuddyStore commit idiom, so a
    reader that races a writer sees either nothing or a whole payload.
    ``get`` requires the manifest (the commit marker) and mmap-reads the
    blocks; a missing or uncommitted directory is a
    :class:`TransportError` (the payload died with its sender — the
    receiver re-prefills). ``delete`` reclaims a consumed payload's RAM;
    the owner's ``close`` removes the whole root."""

    def __init__(self, root: Optional[os.PathLike] = None, *,
                 owner: bool = None):
        self.root = Path(root) if root is not None else shm_root()
        # Creating the root implies owning its lifetime unless told
        # otherwise (workers attach to the service's root, owner=False).
        self.owner = bool(root is None) if owner is None else bool(owner)
        self._seq = 0

    def put(self, payload: dict) -> dict:
        """Store ``payload``; returns the reference dict that travels in
        a control frame: ``{"kind": "shm", "path": ...}``."""
        name = f"payload-{os.getpid()}-{self._seq}"
        self._seq += 1
        tmp = self.root / f"{name}.tmp-{os.getpid()}"
        tmp.mkdir(parents=True)
        keys = sorted(payload["blocks"])
        files = []
        for i, key in enumerate(keys):
            fname = f"block-{i}.npy"
            np.save(tmp / fname,
                    np.ascontiguousarray(payload["blocks"][key]),
                    allow_pickle=False)
            files.append(fname)
        manifest = {k: payload.get(k) for k in PAYLOAD_META}
        manifest["keys"] = keys
        manifest["files"] = files
        (tmp / MANIFEST).write_text(json.dumps(manifest))
        final = self.root / name
        os.replace(tmp, final)
        return {"kind": "shm", "path": str(final)}

    def get(self, ref: dict) -> dict:
        path = Path(ref["path"])
        try:
            manifest = json.loads((path / MANIFEST).read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise TransportError(
                f"shm payload at {path} is missing or uncommitted "
                f"(no readable manifest): {e}"
            ) from e
        blocks: Dict[str, np.ndarray] = {}
        for key, fname in zip(manifest["keys"], manifest["files"]):
            try:
                blocks[key] = np.load(path / fname, mmap_mode="r",
                                      allow_pickle=False)
            except (OSError, ValueError) as e:
                raise TransportError(
                    f"corrupt shm block {fname} of {path}: {e}"
                ) from e
        out = {k: manifest.get(k) for k in PAYLOAD_META}
        out["blocks"] = blocks
        return out

    def delete(self, ref: dict) -> None:
        shutil.rmtree(ref["path"], ignore_errors=True)

    def close(self) -> None:
        if self.owner:
            shutil.rmtree(self.root, ignore_errors=True)
