"""The port's meshes: the counterpart of ``repro/distributed/meshes.py``,
in two forms (and :class:`MeshShape`, a mesh's axes with no devices, for
partition specs).

Stacked (:class:`StackedMesh`): on one card the K = P * Kr servers of the
('rack', 'server') grid are the leading ``[P, Kr]`` axes of one tensor,
and each all_to_all of the shuffle is a transpose of those axes.  It
carries the grid's axis names and sizes (so ``run_job_distributed`` keeps
its signature and its mesh checks) and the device that holds the stacked
tensors.

Process (:class:`ProcessMesh`): each server is one process of a
``torch.distributed`` world (see :mod:`repro_torch.distributed.launch`),
and each mesh axis is a process group, so an all_to_all over 'rack' or
'server' is a real exchange between processes.  Rank ``r`` sits at the
row-major grid coordinates of ``r``: on a (P, Kr) mesh, ``(i, j) =
divmod(r, Kr)``.
"""
from __future__ import annotations

import dataclasses
from math import prod
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the CUDA card,
    and raises where there is none (the port never falls back to the CPU
    unless the caller asks for it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class StackedMesh:
    """Named grid axes (e.g. ('rack', 'server') of sizes (P, Kr)) laid out
    as the leading axes of tensors on ``device``."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes only: what a sharding policy reads of a mesh.
    It stands in for the dry run's fake devices, so that partition specs
    at 256 or 512 devices can be computed with no ranks."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(shape: tuple, names: tuple,
              device: Optional[DeviceLike] = None) -> StackedMesh:
    """A stacked mesh of the given axis sizes and names on ``device``
    (default: the CUDA card; raises if there is none)."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    return StackedMesh(tuple(str(n) for n in names),
                       tuple(int(s) for s in shape), resolve_device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This rank's view of a grid of processes: the axis names and sizes,
    its rank and grid coordinates, the device its tensors live on, and one
    process group per axis (the ranks that differ from it along that axis
    only, ordered by their coordinate on it)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    device: torch.device
    groups: Dict[str, dist.ProcessGroup]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (``jax.lax.axis_index``)
        — also its rank within :meth:`group` ``(name)``."""
        return self.coords[self.axis_names.index(name)]

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    def group(self, name: str) -> dist.ProcessGroup:
        return self.groups[name]


def make_process_mesh(shape: tuple, names: tuple, *,
                      device: Optional[DeviceLike] = None) -> ProcessMesh:
    """This rank's :class:`ProcessMesh` over the initialised default process
    group, whose world size must equal the grid's size.  Every rank must
    call it, in the same order relative to its other collectives:
    ``dist.new_group`` is collective, so each rank creates EVERY axis group
    of the grid, in one order, and keeps its own.  ``new_group`` orders a
    group's members by global rank, which with the row-major layout is
    their coordinate on the group's axis.  ``device`` defaults to the CUDA
    card and raises where there is none."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs an initialised default "
                           "process group (see repro_torch.distributed"
                           ".launch.run_ranks)")
    sizes = tuple(int(s) for s in shape)
    world = dist.get_world_size()
    if prod(sizes) != world:
        raise ValueError(f"mesh shape {sizes} holds {prod(sizes)} ranks; "
                         f"the world has {world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(sizes)
    groups = {}
    for ax, name in enumerate(names):
        for members in np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax]):
            members = members.tolist()
            g = dist.new_group(members)
            if rank in members:
                groups[str(name)] = g
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    return ProcessMesh(tuple(str(n) for n in names), sizes, rank, coords,
                       dev, groups)
