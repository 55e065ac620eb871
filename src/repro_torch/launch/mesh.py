"""Meshes, as ``repro.launch.mesh``: the process group and the
``DeviceMesh`` the runtime shards over.

A mesh has the reference's axis names (``pod``, ``data``, ``model``, and
``stage`` for a pipeline) and one rank per device: its device count must
equal the world size, or `make_mesh` raises and names both numbers.  The
ranks come from ``torchrun`` (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` / ``LOCAL_RANK``), or from a process
group the caller has already initialised (the tests use a ``FileStore``).
``cuda`` runs use NCCL, one card per rank; ``cpu`` runs use gloo, one
host process per rank.  There is no fallback: a rank that finds no card
on a ``cuda`` run raises.

Functions, not module constants, so importing this module touches no
process group and no device.  `AbstractMesh` is a mesh's shape without
devices, for planning and for checking sharding rules.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names with no devices behind it."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names


def default_axes(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    """The reference's axis names for a mesh of ``len(shape)`` dims."""
    if len(shape) > len(AXES):
        raise ValueError(f"mesh {tuple(shape)}: at most {len(AXES)} dims "
                         f"{AXES}")
    return AXES[-len(shape):]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(device=None) -> Tuple[int, int]:
    """Join the process group -> (rank, world size).

    An initialised group is kept as it is.  Otherwise the group is the one
    ``torchrun`` describes in the environment (``WORLD_SIZE`` set), or a
    group of one process.  NCCL for ``cuda`` (each rank takes card
    ``LOCAL_RANK`` and raises when the host has no such card), gloo for
    ``cpu``."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: local rank {local} needs card {local}, but "
                f"the host has {torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(local)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_rank(), dist.get_world_size()


def check_world(shape: Tuple[int, ...]) -> None:
    """Raise unless the mesh's device count is the world size."""
    n, world = math.prod(shape), world_size()
    if n != world:
        raise ValueError(
            f"mesh {tuple(shape)} has {n} devices but the world size is "
            f"{world}: a mesh needs one process per device (run "
            f"`torchrun --nproc-per-node {n} ...`)")


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              device=None):
    """A ``DeviceMesh`` of ``shape`` over the process group (joined here if
    it is not yet), e.g. ``make_mesh((2, 2))`` -> axes ``data``,
    ``model``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes) if axes is not None else default_axes(shape)
    if len(axes) != len(shape):
        raise ValueError(f"mesh {shape}: {len(axes)} axis names {axes}")
    check_world(shape)
    dev = resolve_device(device)
    init_distributed(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def runtime_mesh(shape: Tuple[int, ...], device=None):
    """The mesh ``train`` and ``serve`` run on: None for the one-device
    path (1x1 and no process group), else `make_mesh` (which raises when
    the mesh's device count is not the world size)."""
    shape = tuple(shape)
    if math.prod(shape) == 1 and not dist.is_initialized():
        return None
    return make_mesh(shape, device=device)


def single_device_mesh(device=None):
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices, or 2x16x16 = 512 over ``pod`` too."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, default_axes(shape), device)


def mesh_devices(mesh) -> int:
    """Devices of a ``DeviceMesh`` or an `AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return math.prod(mesh.sizes)
    return mesh.size()
