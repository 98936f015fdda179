"""Production meshes (the port's ``repro/launch/mesh.py``).

Target layout: pods of 16 x 16 = 256 devices, 2 pods = 512 devices for
the multi-pod dry run.  Axes:

  pod    — the slow tier (between pods)  == the paper's 'rack' axis
  data   — data parallel / FSDP within a pod
  model  — tensor/expert parallel within a pod

The ``make_*`` functions build this rank's
:class:`~repro_torch.distributed.meshes.ProcessMesh` over the running
``torch.distributed`` world, and raise, naming the ranks they need, when
the world is another size.  :func:`mesh_shape_by_kind` gives the same axes
as a shape-only :class:`~repro_torch.distributed.meshes.MeshShape`, which
is all a sharding policy reads: specs at 256 or 512 devices need no ranks.
"""
from __future__ import annotations

from math import prod
from typing import Union

import torch.distributed as dist

from ..distributed.meshes import (DeviceLike, MeshShape, ProcessMesh,
                                  make_process_mesh)

MESH_KINDS = {
    "single": dict(multi_pod=False),
    "multi": dict(multi_pod=True),
}
CODED_SHAPE = (4, 8, 16)
AXES3 = ("pod", "data", "model")


def _production(multi_pod: bool):
    return ((2, 16, 16), AXES3) if multi_pod else ((16, 16),
                                                   ("data", "model"))


def _process_mesh(shape: tuple, names: tuple, what: str,
                  device: DeviceLike) -> ProcessMesh:
    need = prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {what} mesh {shape} over {names} needs "
                         f"{need} ranks; the running world has {world} "
                         f"(mesh_shape_by_kind gives its shape alone)")
    return make_process_mesh(shape, names, device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> ProcessMesh:
    shape, names = _production(multi_pod)
    return _process_mesh(shape, names, "multi-pod" if multi_pod
                         else "single-pod", device)


def make_coded_mesh(pods: int = 4, data: int = 8, model: int = 16, *,
                    device: DeviceLike = None) -> ProcessMesh:
    """Mesh for the r < P coded gradient-sync dry runs (P >= 3 pods)."""
    return _process_mesh((pods, data, model), AXES3, "coded", device)


def pod_size(mesh: Union[ProcessMesh, MeshShape]) -> int:
    """Devices per pod (= everything under the 'pod' axis)."""
    return prod(n for name, n in mesh.shape.items() if name != "pod")


def make_mesh_by_kind(kind: str, *,
                      device: DeviceLike = None) -> ProcessMesh:
    if kind in MESH_KINDS:
        return make_production_mesh(**MESH_KINDS[kind], device=device)
    if kind == "coded4":
        return make_coded_mesh(*CODED_SHAPE, device=device)
    raise KeyError(kind)


def parse_mesh(text: str) -> tuple:
    """A launcher's ``--mesh`` value 'D,M' as (D, M): the sizes of a
    ('data', 'model') mesh."""
    try:
        d, m = (int(x) for x in text.split(","))
    except ValueError:
        raise ValueError(f"--mesh takes 'data,model', got {text!r}") from None
    return d, m


def mesh_shape_by_kind(kind: str) -> MeshShape:
    """The axes of :func:`make_mesh_by_kind` ``(kind)``, with no ranks."""
    if kind in MESH_KINDS:
        shape, names = _production(**MESH_KINDS[kind])
        return MeshShape(names, shape)
    if kind == "coded4":
        return MeshShape(AXES3, CODED_SHAPE)
    raise KeyError(kind)
