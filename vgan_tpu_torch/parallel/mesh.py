"""Device meshes over a ``torch.distributed`` world (counterpart of
``vgan_tpu.parallel.mesh``).

The port is SPMD the PyTorch way: one process per device, one process group
over them, and a :class:`~torch.distributed.device_mesh.DeviceMesh` with the
dims ``("data", "model")``. Every rank calls the same entry points with the
same arguments; outputs come back replicated on every rank. (The JAX package
drives all devices from one controller instead.)

The backend follows the device: NCCL for ``cuda`` (each rank on the card
``torch.cuda.set_device(LOCAL_RANK)`` selects, so a bare ``cuda`` means this
rank's card), gloo for ``cpu``. A group of the other backend raises: no card
path runs over gloo or on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vgan_tpu_torch._device import resolve_device

AXES = ("data", "model")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _init_world(device: torch.device) -> None:
    """Join (or start) the default process group for ``device``'s backend.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set) the
    group comes from ``env://``; otherwise a world of one, rank 0, over an
    in-process store. An existing group of another backend raises."""
    if device.type not in _BACKENDS:
        raise ValueError(f"no mesh backend for device type {device.type!r} (cuda or cpu)")
    backend = _BACKENDS[device.type]
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if not dist.is_initialized():
        if _under_torchrun():
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    have = str(dist.get_backend())
    if backend not in have:
        raise ValueError(
            f"a {device.type} mesh needs the {backend} backend, but the process group "
            f"runs {have!r}: a {device.type} path does not run over another backend"
        )


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the whole world, one rank a device.

    ``data`` defaults to world // model. ``device`` is the ranks' device type
    (default: the card, as :func:`~vgan_tpu_torch._device.resolve_device`).
    With no process group initialized, a world of one is started (or joined
    from ``torchrun``'s environment), so ``make_mesh()`` works in a plain
    script on one card. The mesh must cover the world exactly: a larger one
    raises ``ValueError`` naming the devices, and so does a smaller one
    (a rank outside the mesh would have nothing to run).
    """
    device = resolve_device(device)
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    # the world this process is in, or will join: checked before joining it
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ["WORLD_SIZE"]) if _under_torchrun() else 1
    if data is None:
        data = world // model
    if data * model > world or data < 1:
        raise ValueError(
            f"mesh data={data} x model={model} needs {data * model} devices "
            f"but only {world} are available"
        )
    if data * model != world:
        raise ValueError(
            f"mesh data={data} x model={model} covers {data * model} of the {world} "
            "devices: one process runs per device, and every one must be in the mesh"
        )
    _init_world(device)
    layout = torch.arange(world, dtype=torch.int64).reshape(data, model)
    return DeviceMesh(device.type, layout, mesh_dim_names=AXES)


def data_sharding(mesh: DeviceMesh, *axes: Optional[str]) -> tuple:
    """``torch.distributed.tensor`` placements, one per mesh dim, of a tensor
    whose dim ``i`` is split over the mesh axis ``axes[i]`` (None:
    replicated), as the JAX package's ``NamedSharding(mesh, PartitionSpec(*axes))``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(axes.index(name)) if name in axes else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor held whole on every rank."""
    return data_sharding(mesh)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's size along ``axis`` ('data' or 'model')."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def check_mesh_device(mesh: Optional[DeviceMesh], device: torch.device) -> None:
    """``TypeError`` unless ``mesh`` is None or a ``DeviceMesh``;
    ``ValueError`` unless it runs on ``device``'s type."""
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= takes a DeviceMesh (vgan_tpu_torch.parallel.make_mesh), not "
            f"{type(mesh).__name__}"
        )
    if mesh.device_type != torch.device(device).type:
        raise ValueError(
            f"the mesh runs on {mesh.device_type!r} but this object on {device}; build the "
            "mesh with make_mesh(device=...) for the device it serves"
        )


def barrier(mesh: DeviceMesh) -> None:
    """Every rank of the mesh's world meets here."""
    if mesh.device_type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def write_on_rank0(mesh: Optional[DeviceMesh], write, *args, **kwargs):
    """``write(*args, **kwargs)``, under a mesh on global rank 0 only, after
    which every rank meets at a barrier (so that what rank 0 wrote is whole
    when any rank goes on). Without a mesh, simply the call. Returns what
    ``write`` returns on the rank that ran it, None on the others."""
    if mesh is None:
        return write(*args, **kwargs)
    try:
        return write(*args, **kwargs) if dist.get_rank() == 0 else None
    finally:
        barrier(mesh)


def is_rank0(mesh: Optional[DeviceMesh]) -> bool:
    """Does this process print and write for the mesh (always, without one)?"""
    return mesh is None or dist.get_rank() == 0
