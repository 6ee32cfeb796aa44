"""Device meshes: the port's ``make_mesh`` for one named axis.

The JAX package's ``parallel/mesh.py`` lays its devices out as a
``jax.sharding.Mesh`` with named axes (``data``, ``fsdp``, ``model``,
...). The port runs one process per card, so a mesh is a 1-D
``torch.distributed`` ``DeviceMesh`` over the default process group: one
axis, whose size is the world size. ``replicated`` and ``batch_sharding``
give the DTensor placements of the JAX helpers of the same names.
Hybrid (multi-slice) and multi-axis meshes come with tensor parallelism
and ``CompositeParallel``, and raise "not yet ported" until then.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist

# The JAX package's axis names, in its order.
AXES = ("data", "fsdp", "seq", "model", "expert", "pipe")


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *,
              device_type: str = "cuda", devices=None, dcn_axis=None,
              slice_ids=None):
    """A 1-D ``DeviceMesh`` over the default process group, its one axis
    named as in ``axis_sizes`` (``{"data": world}`` by default) on
    ``device_type`` ("cuda", or "cpu" for a gloo group). The axis size
    must be the world size. More than one axis, ``devices``,
    ``dcn_axis`` or ``slice_ids`` raise ``NotImplementedError`` (ROADMAP
    1.7); an unknown axis name or a wrong size raises ``ValueError``, as
    in JAX."""
    from torch.distributed.device_mesh import init_device_mesh

    if (axis_sizes is not None and len(axis_sizes) > 1) or \
            devices is not None or dcn_axis is not None or \
            slice_ids is not None:
        raise NotImplementedError(
            "make_mesh with more than one axis, a device subset or a "
            "multi-slice layout: not yet ported (ROADMAP 1.7: tensor "
            "parallelism and CompositeParallel)")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group "
            "(cluster.initialize() or a DataParallel-family strategy)")
    n = dist.get_world_size()
    axis_sizes = dict(axis_sizes or {"data": n})
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"Unknown mesh axes {sorted(unknown)}; valid: {AXES}")
    (axis, size), = axis_sizes.items()
    if int(size) != n:
        raise ValueError(f"Mesh axes {axis_sizes} need {int(size)} devices, "
                         f"got {n}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


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


__all__ = ["AXES", "batch_sharding", "make_mesh", "replicated"]
