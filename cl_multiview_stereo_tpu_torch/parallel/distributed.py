"""Process groups and the ``(host, view)`` mesh (port of
``cl_multiview_stereo_tpu/parallel/distributed.py``).

JAX brings up its distributed runtime and then sees every host's devices;
here each rank is one process that owns one device, and the ranks meet in
a ``torch.distributed`` process group: NCCL for CUDA tensors, gloo only
when the caller asks for the CPU.  The JAX module's TPU environment
handling has no GPU counterpart.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str = "cuda",
) -> None:
    """Join (or start) the default process group.

    The arguments come first, then torch's ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` environment.  ``coordinator_address`` is
    ``host:port`` or an init-method URL (``tcp://``, ``file://``).  With
    neither, JAX stays single-process; here a world-size-1 group starts on
    an in-memory store, so that every collective of ``parallel/`` still
    goes through the real backend.  On ``cuda`` each rank takes the device
    ``LOCAL_RANK`` (default: its rank modulo the devices it sees)."""
    if device not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}; expected one of {tuple(BACKENDS)}")
    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    backend = BACKENDS[device]
    if addr is None and num_processes is None:
        rank, world = 0, 1
    else:
        if addr is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process group needs an address, a world size and a rank")
        rank, world = process_id, num_processes
    if device == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    if addr is None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        url = addr if "://" in addr else f"tcp://{addr}"
        dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)


def make_host_view_mesh(views_per_host: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A ``(host, view)`` mesh over the world's ranks: the view axis holds
    the ranks of one host (``LOCAL_WORLD_SIZE``, the launcher's count; the
    whole world when unset), so view-axis collectives stay on the host's
    NVLink and the host axis spans processes on other hosts."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host}")
    if views_per_host is None:
        views_per_host = per_host
    if views_per_host != per_host:
        raise ValueError(f"views_per_host {views_per_host} != local device count {per_host}")
    return init_device_mesh(device_type, (world // per_host, per_host), mesh_dim_names=("host", "view"))
