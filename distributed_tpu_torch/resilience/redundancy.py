"""Diskless recovery: peer-redundant state shards with in-memory restore.

The port's copy of the JAX package's ``resilience/redundancy.py``, with
its store layout and mirror encoding, so either package reads the other's
mirror sets. The mirrors hold exactly what the port's sharded save holds
for a rank (``checkpoint.sharded.extract_blocks``: its FSDP and ZeRO
blocks, tensor parallelism's blocks by the first rank of each data line,
the whole replicated leaves on rank 0), as numpy.

Elastic gangs (``elastic.py``) recover exclusively through the disk
checkpoint — at fleet scale that disk round-trip dominates MTTR and
checkpoint bandwidth. This module adds a RECOVERY TIER above the disk:
each worker asynchronously mirrors a peer's model+optimizer state shard in
host RAM, and a re-formed gang restores a lost shard from its buddy with
**zero disk reads**, falling back to the :class:`ShardedCheckpointer` only
when the redundancy itself is lost (buddy-pair failure) or stale
(mid-refresh kill). ZeRO/FSDP shards are 1/N-sized, so holding one peer's
shard costs (1+1/N)x — priced by ``utils.profiler.redundancy_report``
and reported in the fit telemetry's ``redundancy`` entry.

**Buddy assignment** is a ring: worker ``j`` holds the mirror of worker
``(j-1) % N``'s shard (:func:`mirror_source`), equivalently worker ``j``'s
shard is mirrored by worker ``(j+1) % N`` (:func:`mirror_holder`).

**The store** (:class:`BuddyStore`) models each worker's host RAM as a
per-rank *segment* of a RAM-backed directory (tmpfs — ``/dev/shm`` via
:func:`ram_dir`). On a real multi-host fleet the segment IS the peer's
resident memory and the refresh/restore transport is the interconnect;
on the single-box gangs the tests and the restart script run, tmpfs
stands in for both — RAM-speed, zero disk I/O, and per-segment
invalidation mirrors per-host memory loss (the supervisor purges the
segments of ranks that initiated a failure before relaunching: a crashed
worker's RAM did not survive it). Each segment holds two mirrors in the
``ShardedCheckpointer`` block-layout encoding (same keys, same overlap
reassembly — only the medium differs):

- ``self``  — the worker's own shard. Stands in for the live state a
  *surviving* worker keeps resident across a gang re-form; the relaunch
  protocol here restarts every process, so survivors re-load their own
  shard from it at RAM speed.
- ``peer``  — the ring buddy's shard, pushed by the buddy at refresh.
  The ONLY surviving copy of a crashed worker's shard.

**Refresh** rides the ``async_save`` writer-thread idiom: the blocks are
cloned on the card on the training thread (``checkpoint.core.
_device_snapshot``, an event recorded after the clones), then a background
"dtpu-buddy-writer" waits for that event on a stream of its own, copies
the blocks to the host and writes the store; it never reads a tensor the
next step updates in place. A mirror becomes
visible atomically (blocks first, ``manifest.json`` commit marker last,
directory renamed into place); a kill mid-refresh leaves the previous
committed mirror in place and the half-written one invisible — the
consistency decision happens entirely at restore time.

**Restore-tier selection** (:func:`select_restore_tier`): the buddy tier
is usable at step S when every shard source of the saving world is
covered at the SAME step S by a committed, non-invalidated mirror
(``self`` or ``peer``); it wins when S >= the newest disk checkpoint,
otherwise the mirror set is STALE (a mid-refresh kill, or redundancy
disabled for a while) and the disk tier wins; with neither, the run
restarts from scratch. ``ModelCheckpoint(buddy=...)`` wires selection,
refresh cadence, and the recovery telemetry events
(``restore_begin``/``restore_end`` with the tier and disk-read counts).
"""

from __future__ import annotations

import json
import os
import re as _re
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

ENV_VAR = "DTPU_BUDDY_STORE"

_MIRROR_RE = _re.compile(r"^mirror-(\d+)$")

ROLES = ("self", "peer")


def mirror_holder(rank: int, world: int) -> int:
    """The peer that HOLDS ``rank``'s shard mirror (ring: the right
    neighbor)."""
    return (int(rank) + 1) % int(world)


def mirror_source(rank: int, world: int) -> int:
    """The peer whose shard ``rank`` holds (ring: the left neighbor).
    Inverse of :func:`mirror_holder`."""
    return (int(rank) - 1) % int(world)


def ram_dir(prefix: str = "dtpu-buddy-") -> Path:
    """A fresh RAM-backed directory for a buddy store: tmpfs
    (``/dev/shm``) when writable — actual host memory, the honest medium
    for an in-memory tier — else the system temp dir (documented
    fallback; the store still works, the "diskless" claim weakens to
    "no checkpoint-directory reads")."""
    shm = Path("/dev/shm")
    base = shm if (shm.is_dir() and os.access(shm, os.W_OK)) else None
    return Path(tempfile.mkdtemp(prefix=prefix, dir=base))


class BuddyStore:
    """Per-rank RAM segments of committed shard mirrors.

    Layout::

        root/rank-<j>/            # worker j's host-RAM segment
            self/mirror-<step>/   # j's own shard blocks @ step
                block-<i>.npy     # raw, mmap-able — no (de)serialization
                manifest.json     # commit marker (step, source, world,
                                  #   leaves meta, block keys, crc32s, ...)
            peer/mirror-<step>/   # shard of (j-1) % world @ step

    Only a directory matching ``mirror-<step>`` that contains
    ``manifest.json`` is committed; writes happen in a ``.tmp-<pid>``
    sibling renamed into place, so readers never see a torn mirror. Each
    role keeps the ``keep`` newest committed mirrors — ``keep`` is the
    REFRESH-SKEW tolerance: between a worker's death and the launcher's
    gang kill, survivors keep stepping (the host runs ahead of stalled
    device collectives) and keep refreshing, so their newest mirrors end
    up a few refresh periods past the dead worker's last push; a complete
    set only exists at a COMMON step, which must still be retained.
    Restore tolerates up to ``keep - 1`` refresh periods of skew (default
    4: comfortably past the observed 1-3-step run-ahead under the
    supervised gang kill) before the tier degrades to the disk fallback.
    RAM cost scales with it and is priced honestly in ``bytes_held``. The
    store is plain numpy + files — importable on controllers
    (the supervisor invalidates segments without a process group).
    """

    def __init__(self, root, keep: int = 4):
        self.root = Path(root)
        self.keep = max(1, int(keep))

    # ------------------------------------------------------------ layout --
    def segment(self, rank: int) -> Path:
        return self.root / f"rank-{int(rank)}"

    def _role_dir(self, rank: int, role: str) -> Path:
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        return self.segment(rank) / role

    def committed_steps(self, rank: int, role: str) -> List[int]:
        """Steps of every committed mirror in one role dir, ascending."""
        d = self._role_dir(rank, role)
        if not d.is_dir():
            return []
        steps = []
        for p in d.iterdir():
            m = _MIRROR_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def committed_step(self, rank: int, role: str) -> Optional[int]:
        """Step of the latest committed mirror in one role dir, or None."""
        steps = self.committed_steps(rank, role)
        return steps[-1] if steps else None

    def _mirror_dir(self, rank: int, role: str, step: int) -> Path:
        return self._role_dir(rank, role) / f"mirror-{int(step)}"

    def read_manifest(self, rank: int, role: str, step: int) -> Optional[dict]:
        p = self._mirror_dir(rank, role, step) / "manifest.json"
        try:
            return json.loads(p.read_text())
        except (OSError, ValueError):
            return None

    # ------------------------------------------------------------- write --
    def write_mirror(self, holder_rank: int, role: str, step: int,
                     blocks: Dict[str, np.ndarray], manifest: dict) -> Path:
        """Commit one mirror atomically: blocks as raw ``.npy`` files, the
        manifest last, the whole directory renamed into place. ``blocks``
        uses the sharded block-key encoding; ``manifest`` must carry
        step/source/world/leaves (and may carry seed/input_shape/
        data_state). Older committed mirrors of the same role are gc'd."""
        from ..checkpoint.sharded import block_crc

        role_dir = self._role_dir(holder_rank, role)
        role_dir.mkdir(parents=True, exist_ok=True)
        final = role_dir / f"mirror-{int(step)}"
        tmp = role_dir / f"mirror-{int(step)}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        keys: Dict[str, str] = {}
        crcs: Dict[str, int] = {}
        for i, (key, data) in enumerate(sorted(blocks.items())):
            fname = f"block-{i}.npy"
            np.save(tmp / fname, np.ascontiguousarray(data))
            keys[key] = fname
            crcs[key] = block_crc(data)
        record = dict(manifest)
        record.update({"step": int(step), "keys": keys, "crc32": crcs})
        (tmp / "manifest.json").write_text(json.dumps(record))
        if final.exists():  # re-commit of the same step: replace
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        # gc: keep the `keep` newest committed mirrors (async refresh skew
        # tolerance, see class docstring); sweep everything else,
        # including stale .tmp dirs a killed writer left (invisible to
        # readers either way).
        keep_names = {
            f"mirror-{s}" for s in self.committed_steps(holder_rank, role)[-self.keep:]
        }
        for p in role_dir.iterdir():
            if p.name in keep_names:
                continue
            shutil.rmtree(p, ignore_errors=True)
        return final

    # -------------------------------------------------------- invalidation --
    def invalidate_ranks(self, ranks: Iterable[int]) -> List[int]:
        """Drop whole segments: rank ``r``'s host died, so every mirror it
        held (its own shard's ``self`` copy AND its ring buddy's ``peer``
        copy) died with it. Called by the supervisor for ranks that
        INITIATED a failure, before the relaunch. Returns the ranks whose
        segments actually existed."""
        gone = []
        for r in ranks:
            seg = self.segment(r)
            if seg.exists():
                shutil.rmtree(seg, ignore_errors=True)
                gone.append(int(r))
        return gone

    # ----------------------------------------------------------- coverage --
    def _committed(self) -> List[Tuple[int, str, int, dict]]:
        """(holder_rank, role, step, manifest) of every committed mirror."""
        out = []
        if not self.root.is_dir():
            return out
        for seg in self.root.iterdir():
            m = _re.match(r"^rank-(\d+)$", seg.name)
            if not m:
                continue
            rank = int(m.group(1))
            for role in ROLES:
                for step in self.committed_steps(rank, role):
                    manifest = self.read_manifest(rank, role, step)
                    if manifest is not None:
                        out.append((rank, role, step, manifest))
        return out

    def available_step(self) -> Optional[int]:
        """The newest step at which the mirror set is COMPLETE: every
        shard source ``0..world-1`` of that step's saving world is covered
        by a committed mirror (``self`` in its own segment or ``peer`` in
        its holder's). None when no step is complete — a buddy-pair loss
        or a mid-refresh kill leaves partial sets, and a partial set must
        never restore (the disk tier takes over)."""
        committed = self._committed()
        by_step: Dict[int, Dict[int, dict]] = {}
        for _rank, _role, step, manifest in committed:
            src = manifest.get("source")
            world = manifest.get("world")
            if src is None or world is None:
                continue
            by_step.setdefault(step, {})[int(src)] = manifest
        for step in sorted(by_step, reverse=True):
            sources = by_step[step]
            worlds = {int(m["world"]) for m in sources.values()}
            if len(worlds) != 1:
                continue
            world = worlds.pop()
            if set(sources) >= set(range(world)):
                return step
        return None

    # ------------------------------------------------------------ restore --
    def build_index(self, step: int) -> Tuple["_MirrorIndex", dict]:
        """Block index + merged manifest for a complete step (one mirror
        per source, ``self`` preferred). Raises if the step is not
        complete — callers select via :func:`available_step` first."""
        chosen: Dict[int, Tuple[Path, dict]] = {}
        world = None
        for rank, role, step_c, manifest in self._committed():
            if step_c != int(step):
                continue
            src = manifest.get("source")
            if src is None:
                continue
            src = int(src)
            world = int(manifest["world"])
            if src not in chosen or role == "self":
                chosen[src] = (self._mirror_dir(rank, role, step_c), manifest)
        if world is None or set(chosen) < set(range(world)):
            missing = (sorted(set(range(world or 0)) - set(chosen))
                       if world is not None else "all")
            raise FileNotFoundError(
                f"buddy store has no complete mirror set at step {step} "
                f"(missing shard sources: {missing})"
            )
        index = _MirrorIndex([d for d, _ in chosen.values()])
        merged = dict(next(iter(chosen.values()))[1])
        merged["step"] = int(step)
        return index, merged

    def bytes_held(self, rank: int) -> int:
        """Resident bytes of one segment's committed mirrors — what the
        (1+1/N)x redundancy pricing measures for this host."""
        total = 0
        for role in ROLES:
            for step in self.committed_steps(rank, role):
                d = self._mirror_dir(rank, role, step)
                for p in d.glob("block-*.npy"):
                    try:
                        total += p.stat().st_size
                    except OSError:
                        pass
        return total


class _MirrorIndex:
    """In-memory sibling of the disk ``_BlockIndex``: same two-member
    surface (``blocks`` + ``read``) consumed by
    ``checkpoint.sharded.restore_from_index``, backed by mmap'd raw
    ``.npy`` blocks in the RAM store — a read is a page-cache-resident
    memory map, not a disk block, and deliberately never touches
    ``checkpoint.sharded.read_stats`` (the zero-disk-reads proof)."""

    def __init__(self, mirror_dirs: List[Path]):
        from ..checkpoint.sharded import _parse_key

        self.blocks: Dict[str, list] = {}
        self._dirs = list(mirror_dirs)
        for di, d in enumerate(self._dirs):
            manifest = json.loads((d / "manifest.json").read_text())
            for key, fname in manifest.get("keys", {}).items():
                path, starts, shape = _parse_key(key)
                self.blocks.setdefault(path, []).append(
                    (starts, shape, (di, fname), key)
                )

    def read(self, handle, key: str) -> np.ndarray:
        di, fname = handle
        return np.load(self._dirs[di] / fname, mmap_mode="r",
                       allow_pickle=False)

    def close(self):
        pass


# ----------------------------------------------------------- tier choice --
def select_restore_tier(buddy: Optional["BuddyRedundancy"],
                        disk) -> Tuple[str, Optional[int]]:
    """Which tier a recovery should restore from, newest-state-wins:

    - ``("buddy", S)`` — the mirror set is complete at S and S is at
      least as new as the newest disk checkpoint: restore from RAM, zero
      disk reads.
    - ``("disk", D)``  — no complete mirror set, or the mirrors are STALE
      (complete only at a step older than the disk's newest — the
      signature of a kill mid-refresh): the ShardedCheckpointer restores.
    - ``("restart", None)`` — neither tier has state; train from scratch.

    ``disk`` is anything with ``latest_step()`` (a ShardedCheckpointer),
    or None. Pure host arithmetic — multi-process callers agree on the
    answer by broadcasting the chief's (ModelCheckpoint does).
    """
    b = buddy.available_step() if buddy is not None else None
    d = disk.latest_step() if disk is not None else None
    if b is not None and (d is None or b >= d):
        return "buddy", b
    if d is not None:
        return "disk", d
    return "restart", None


class BuddyRedundancy:
    """The buddy-redundancy tier for one worker: refresh + restore.

    ``store`` is a :class:`BuddyStore` or a path to one (RAM-backed —
    :func:`ram_dir`). ``rank``/``world`` default to the live process
    group's (``utils.logging.rank_world``) at first use; tests simulate
    other gang positions by passing them explicitly.
    ``async_refresh=True`` (default) runs the host copy and the writes on a
    background "dtpu-buddy-writer" thread after an on-card snapshot, the
    ``ShardedCheckpointer(async_save=True)`` idiom; a refresh failure
    degrades the TIER (warning + ``buddy_refresh_failed`` event), never
    the training run. A process killed right after a refresh abandons a
    background write: ``async_refresh=False`` commits the mirror before
    ``refresh`` returns.
    """

    def __init__(self, store, *, rank: Optional[int] = None,
                 world: Optional[int] = None, async_refresh: bool = True):
        self.store = store if isinstance(store, BuddyStore) else BuddyStore(store)
        self._rank = rank
        self._world = world
        self.async_refresh = bool(async_refresh)
        self._writer: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        self.last_refresh_step: Optional[int] = None
        self.last_refresh_error: Optional[BaseException] = None

    @classmethod
    def from_env(cls, **kw) -> Optional["BuddyRedundancy"]:
        """Build from ``DTPU_BUDDY_STORE`` (exported by a Supervisor armed
        with ``buddy_store_dir=``); None when unset."""
        root = os.environ.get(ENV_VAR)
        return cls(root, **kw) if root else None

    # --------------------------------------------------------------- gang --
    @property
    def rank(self) -> int:
        if self._rank is None:
            from ..utils.logging import rank_world

            self._rank = rank_world()[0]
        return self._rank

    @property
    def world(self) -> int:
        if self._world is None:
            from ..utils.logging import rank_world

            self._world = rank_world()[1]
        return self._world

    # ------------------------------------------------------------ refresh --
    def refresh(self, model, step: Optional[int] = None) -> None:
        """Mirror this worker's shard: ``self`` copy into its own segment,
        ``peer`` push into its ring holder's — both committed atomically,
        previous refresh waited out first (a newer mirror never races an
        older one). The fault hook ``fire_refresh_kill`` runs MID-REFRESH
        (between the two commits): a kill there leaves exactly the
        torn-redundancy state the stale-mirror fallback exists for. No
        collective: each rank mirrors what it holds."""
        from ..checkpoint.core import (_data_state_of, _device_snapshot,
                                       _map_tree)
        from ..checkpoint.sharded import _to_numpy, extract_blocks

        self.wait()
        step = int(model.step if step is None else step)
        rank, world = self.rank, self.world
        blocks, leaves_meta = extract_blocks(model, rank)
        manifest = {
            "source": rank,
            "world": world,
            "seed": int(model._seed),
            "input_shape": list(model.input_shape or ()),
        }
        dstate = _data_state_of(model, step)
        if dstate is not None:
            manifest["data_state"] = dstate
        manifest["leaves"] = leaves_meta

        def write(host):
            from ..utils import event_schema as evs
            from ..utils import events as events_lib
            from ..utils import logging as dlog
            from . import faults as faults_lib

            try:
                self.store.write_mirror(rank, "self", step, host, manifest)
                # Mid-refresh: the self copy is committed, the peer push
                # is not — the window kill_during_refresh targets.
                faults_lib.fire_refresh_kill(step)
                if world > 1:
                    self.store.write_mirror(
                        mirror_holder(rank, world), "peer", step, host,
                        manifest,
                    )
                self.last_refresh_step = step
                events_lib.emit(evs.BUDDY_REFRESH, step=step, rank=rank,
                                world=world)
            except BaseException as e:
                # Degrade the tier, not the run: recovery falls back to
                # disk while refreshes fail.
                self.last_refresh_error = e
                dlog.warning(
                    f"BuddyRedundancy: refresh at step {step} failed "
                    f"({type(e).__name__}: {e}); the buddy tier is stale "
                    "until a refresh succeeds (disk fallback covers it)"
                )
                events_lib.emit(evs.BUDDY_REFRESH_FAILED, step=step,
                                rank=rank, error=str(e))

        if not self.async_refresh:
            write(_map_tree(_to_numpy, blocks))
            return
        snap, device, event = _device_snapshot(blocks)

        def fetch_and_write():
            if device is not None:
                # The clones are ordered on the training stream; wait for
                # them on a stream of our own before the copy to the host.
                stream = torch.cuda.Stream(device=device)
                with torch.cuda.stream(stream):
                    stream.wait_event(event)
                    host = _map_tree(_to_numpy, snap)
            else:
                host = _map_tree(_to_numpy, snap)
            write(host)

        writer = threading.Thread(target=fetch_and_write,
                                  name="dtpu-buddy-writer", daemon=True)
        with self._writer_lock:
            self._writer = writer
        writer.start()

    def wait(self) -> None:
        """Join the in-flight refresh writer (if any). Refresh errors were
        already downgraded to warnings+events; this is purely the ordering
        barrier (train end, teardown, next refresh)."""
        with self._writer_lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()

    # ------------------------------------------------------------ restore --
    def available_step(self) -> Optional[int]:
        return self.store.available_step()

    def restore_into(self, model, step: Optional[int] = None) -> int:
        """Restore the model from the mirror set (RAM only) at ``step``
        (default: the newest complete one) through the SAME block-overlap
        reassembly a disk restore uses — the mirror encoding is the
        checkpoint block layout, so world size and strategy changes
        reshard on read identically."""
        from ..checkpoint.sharded import restore_from_index

        if step is None:
            step = self.available_step()
        if step is None:
            raise FileNotFoundError(
                f"buddy store {self.store.root} has no complete mirror set"
            )
        index, manifest = self.store.build_index(int(step))
        got, _ = restore_from_index(model, index, manifest)
        return got

    # ---------------------------------------------------------- telemetry --
    def report(self, model) -> dict:
        """The (1+1/N)x pricing, measured not asserted: the bytes of model
        state this rank holds (its blocks where sharded) next to the mirror
        bytes its segment holds (``utils.profiler.redundancy_report``)."""
        from ..utils.profiler import _held_bytes, redundancy_report

        own = sum(_held_bytes(t) for t in (
            model._param_list(), list(model.state.values()),
            model.opt_state))
        return redundancy_report(
            own, self.store.bytes_held(self.rank), world=self.world
        )
