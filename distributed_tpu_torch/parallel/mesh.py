"""Device meshes: the port's ``make_mesh`` over named axes.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with
named axes in a fixed order (``AXES``). The port runs one process per
card, so a device is a rank of the default ``torch.distributed`` group,
and a mesh is an n-D ``DeviceMesh`` over ranks whose dimensions follow
``AXES``: rank r sits at the coordinate device r has in the JAX mesh of
the same sizes (a row-major reshape of the device list, or the
slice-major hybrid layout with ``dcn_axis``). :func:`device_grid` is that
arrangement as a pure function, so it can be compared with JAX's without
starting a process. ``mesh.get_group(axis)`` is the process group of this
rank's line along ``axis`` and ``mesh.get_local_rank(axis)`` its
coordinate there. ``replicated`` and ``batch_sharding`` give the DTensor
placements of the JAX helpers of the same names.

A ``DeviceMesh`` keeps its groups in a registry of its own; the meshes
``make_mesh`` builds are listed (weakly), and :func:`release_groups`
empties their registries when the gang leaves (``cluster.shutdown``), so
no mesh keeps a destroyed group and its worker threads alive.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist

# The JAX package's canonical axis names, in its order.
AXES = ("data", "fsdp", "pipe", "seq", "expert", "model")

_MESHES: "weakref.WeakSet" = weakref.WeakSet()  # what make_mesh built


def _hybrid_grid(ranks, names, sizes, dcn_axis, slice_ids) -> np.ndarray:
    """The JAX ``_hybrid_device_array``: ``dcn_axis`` slice-major, each
    slice a contiguous block of it, every other axis within one slice."""
    groups: Dict[int, list] = {}
    for r, s in zip(ranks, slice_ids):
        groups.setdefault(s, []).append(r)
    n_slices = len(groups)
    dcn_i = names.index(dcn_axis)
    if sizes[dcn_i] % n_slices:
        raise ValueError(
            f"dcn axis {dcn_axis!r} size {sizes[dcn_i]} not divisible by "
            f"{n_slices} slices")
    per = list(sizes)
    per[dcn_i] = sizes[dcn_i] // n_slices
    per_count = int(np.prod(per))
    subs = []
    for s in sorted(groups):
        members = groups[s]
        if len(members) != per_count:
            raise ValueError(
                f"slice {s} has {len(members)} devices; the hybrid mesh "
                f"needs {per_count} per slice")
        subs.append(np.array(members, dtype=np.int64).reshape(per))
    return np.concatenate(subs, axis=dcn_i)


def device_grid(axis_sizes: Optional[Dict[str, int]], ranks: Sequence[int],
                *, dcn_axis: Optional[str] = None,
                slice_ids: Optional[Sequence[int]] = None):
    """``(axis names, rank array)`` of the mesh that ``make_mesh`` builds
    over ``ranks`` (a list of ranks, in the order JAX's ``devices`` would
    list them): the axes in ``AXES`` order, each rank at the coordinate
    its device has in the JAX mesh. Raises the JAX package's
    ``ValueError``s for unknown axes, a wrong device count and a bad
    hybrid layout."""
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    if not axis_sizes:
        axis_sizes = {"data": n}
    names = [a for a in AXES if a in axis_sizes]
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"Unknown mesh axes {sorted(unknown)}; valid: {AXES}")
    sizes = [int(axis_sizes[a]) for a in names]
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(
            f"Mesh axes {dict(zip(names, sizes))} need {total} devices, "
            f"got {n}")
    ids = list(slice_ids) if slice_ids is not None else [0] * n
    if len(ids) != n:
        raise ValueError(f"slice_ids has {len(ids)} entries for {n} devices")
    if dcn_axis is not None and len(set(ids)) > 1:
        if dcn_axis not in names:
            raise ValueError(
                f"dcn_axis {dcn_axis!r} not among mesh axes {names}")
        return tuple(names), _hybrid_grid(ranks, names, sizes, dcn_axis, ids)
    return tuple(names), np.array(ranks, dtype=np.int64).reshape(sizes)


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *,
              device_type: str = "cuda", devices=None, dcn_axis=None,
              slice_ids=None):
    """An n-D ``DeviceMesh`` over ranks of the default process group, on
    ``device_type`` ("cuda", or "cpu" for a gloo group): ``axis_sizes``
    maps axis name -> size (``{"data": N}`` by default), ``devices`` is
    the list of ranks it spans (all by default; a subset gives the
    sub-mesh), and ``dcn_axis`` with ``slice_ids`` (each rank's slice)
    lays that axis slice-major, as in JAX (:func:`device_grid`). Every
    rank of the default group calls it (the mesh forms one group per
    line of each axis)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group "
            "(cluster.initialize() or a DataParallel-family strategy)")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(d) for d in devices])
    names, grid = device_grid(axis_sizes, ranks, dcn_axis=dcn_axis,
                              slice_ids=slice_ids)
    mesh = DeviceMesh(device_type, torch.from_numpy(grid),
                      mesh_dim_names=names)
    _MESHES.add(mesh)
    return mesh


def release_groups() -> None:
    """Drop every group the meshes of :func:`make_mesh` still hold (their
    ``_pg_registry``), after ``destroy_process_group``."""
    for mesh in list(_MESHES):
        registry = getattr(mesh, "_pg_registry", None)
        if isinstance(registry, dict):
            registry.clear()


def replicated(mesh=None):
    """The placement of a leaf every rank holds whole (JAX's
    ``PartitionSpec()``)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def batch_sharding(mesh=None, axis: str = "data"):
    """The placement of a batch split on its leading dimension across the
    mesh's axis (JAX's ``PartitionSpec(axis)``)."""
    from torch.distributed.tensor import Shard

    if mesh is not None and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"Mesh {mesh.mesh_dim_names} has no axis {axis!r}")
    return (Shard(0),)


__all__ = ["AXES", "batch_sharding", "device_grid", "make_mesh",
           "replicated"]
