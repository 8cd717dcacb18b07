"""Meshes and placements (port of ``cl_multiview_stereo_tpu/parallel/mesh.py``).

The mesh is PyTorch's own ``DeviceMesh`` with the JAX axis names; one rank
owns one device.  A process group must be up first
(``parallel/distributed.initialize_distributed``).
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(n_view: int | None = None, n_disp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ``(view, disp)`` mesh over the world's ranks; ``n_view`` defaults
    to the world size / ``n_disp``."""
    total = dist.get_world_size()
    if n_view is None:
        n_view = total // n_disp
    if n_view * n_disp != total:
        raise ValueError(f"{n_view}x{n_disp} mesh != {total} devices")
    return init_device_mesh(device_type, (n_view, n_disp), mesh_dim_names=("view", "disp"))


def view_sharding(mesh: DeviceMesh, ndim: int) -> tuple:
    """DTensor placements that shard an array's leading (view) axis over the
    mesh's first axis and replicate it over the others (JAX
    ``P("view", None, ...)`` for an array of rank ``ndim``)."""
    if ndim < 1:
        raise ValueError("a view-sharded array has a leading view axis")
    return (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)


def replicated(mesh: DeviceMesh) -> tuple:
    """DTensor placements of an array held whole by every rank."""
    return (Replicate(),) * mesh.ndim


def axis_of(mesh: DeviceMesh, axis: str | tuple[str, ...]) -> tuple[dist.ProcessGroup, int, int]:
    """(process group, this rank's index, size) of mesh axis ``axis``, or
    of several axes flattened in the order named (JAX's ``P(("host",
    "view"))``): the ranks that share this rank's coordinates on the other
    axes, the first named axis major.  The names must follow the mesh's own
    order, so that the flattened index is the rank's index in the group.
    A tuple of two or more names builds its groups with
    ``new_subgroups_by_enumeration``, a collective: every rank of the world
    calls it together."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {a!r}: {mesh.mesh_dim_names}")
    dims = [mesh.mesh_dim_names.index(a) for a in names]
    if len(dims) == 1:
        return mesh.get_group(names[0]), mesh.get_local_rank(names[0]), mesh.size(dims[0])
    if dims != sorted(set(dims)):
        raise ValueError(f"axes {names} must be distinct and in the mesh's order {mesh.mesh_dim_names}")
    others = [d for d in range(mesh.ndim) if d not in dims]
    size = math.prod(mesh.size(d) for d in dims)
    rows = mesh.mesh.permute(*others, *dims).reshape(-1, size).tolist()
    group, _ = dist.new_subgroups_by_enumeration(rows)
    me = dist.get_rank()
    row = next(r for r in rows if me in r)
    if row != sorted(row):
        raise ValueError(f"the flattened axes {names} order the ranks {row}, not ascending")
    return group, row.index(me), size
