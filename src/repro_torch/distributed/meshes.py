"""The stacked single-card "mesh": the port's counterpart of
``repro/distributed/meshes.py``.

On one card the K = P * Kr servers of the ('rack', 'server') grid are the
leading ``[P, Kr]`` axes of one tensor, and each all_to_all of the shuffle
is a transpose of those axes.  A :class:`StackedMesh` carries the grid's
axis names and sizes (so ``run_job_distributed`` keeps its signature and
its mesh checks) and the device that holds the stacked tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

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


def make_mesh(shape: tuple, names: tuple,
              device: Optional[DeviceLike] = None) -> StackedMesh:
    """A stacked mesh of the given axis sizes and names on ``device``
    (default: the CUDA card; raises if there is none)."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    return StackedMesh(tuple(str(n) for n in names),
                       tuple(int(s) for s in shape), resolve_device(device))
