"""Meshes and placements (port of ``cl_multiview_stereo_tpu/parallel/mesh.py``).

The mesh is PyTorch's own ``DeviceMesh`` with the JAX axis names; one rank
owns one device.  A process group must be up first
(``parallel/distributed.initialize_distributed``).
"""

from __future__ import annotations

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


def axis_of(mesh: DeviceMesh, axis: str) -> tuple[dist.ProcessGroup, int, int]:
    """(process group, this rank's index, size) of mesh axis ``axis``."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(dim)
