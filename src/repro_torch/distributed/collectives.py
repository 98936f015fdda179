"""Hierarchical (rack-aware) collectives over a :class:`ProcessMesh`: the
counterpart of ``repro/distributed/collectives.py``.

The paper's insight is that a two-level network (fast ToR / slow root)
wants shuffles decomposed into a slow-tier stage at 1/r the volume and a
fast-tier stage that absorbs the residual.  With pod = rack:

  * :func:`hierarchical_all_to_all` — MoE expert dispatch in two stages:
    tokens first move to the destination pod's matching slot (one bundled
    slow-axis a2a), then to the destination expert inside the pod (fast
    axis); equal to :func:`flat_all_to_all`.
  * :func:`hierarchical_psum` / :func:`hierarchical_psum_scatter` — the
    SUM-reducible case (gradients): intra-pod reduce-scatter, cross-pod
    all-reduce on 1/Kr shards, intra-pod all-gather.

Where the JAX functions name axes of the enclosing ``shard_map``, these
take the mesh and the axis names.  The named-axis primitives underneath
(:func:`all_to_all`, :func:`all_gather`, :func:`psum_scatter`,
:func:`psum`) are ``jax.lax``'s, each over the axis's process group;
a tuple of all the mesh's axes, in order, is the whole world.  Every one
runs on two ``torch.distributed`` calls only, ``all_to_all_single`` and
``all_gather``: a reduction is an exchange followed by a sum over the
sources in rank order, so its result does not depend on how the backend
orders a reduction, and integer-valued float inputs compare bit for bit
with any other order.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from .meshes import ProcessMesh

Axis = Union[str, Sequence[str]]


def _group(mesh: ProcessMesh, axis: Axis) -> Optional[dist.ProcessGroup]:
    """The process group of ``axis``: one axis's group, or the world (None)
    for all the mesh's axes in order."""
    if isinstance(axis, str):
        return mesh.group(axis)
    axes = tuple(axis)
    if len(axes) == 1:
        return mesh.group(axes[0])
    if axes != mesh.axis_names:
        raise ValueError(f"joint axes {axes} must be the mesh's axes "
                         f"{mesh.axis_names} in order")
    return None


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts[0] + parts[1] + ... in index (rank) order."""
    acc = parts[0].clone()
    for part in parts[1:]:
        acc += part
    return acc


def all_to_all(x: torch.Tensor, mesh: ProcessMesh, axis: Axis,
               dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, dim, dim, tiled=True)``: split ``dim``
    into one block per member of the axis, send block k to member k, and
    return the received blocks ordered by source member."""
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=_group(mesh, axis))
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, mesh: ProcessMesh, axis: Axis,
               dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: every
    member's ``x`` concatenated along ``dim`` in member order."""
    group = _group(mesh, axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def psum_scatter(x: torch.Tensor, mesh: ProcessMesh, axis: Axis,
                 dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    member k gets the sum over members of their k-th block of ``dim``."""
    recvd = all_to_all(x, mesh, axis, dim).movedim(dim, 0)
    n = dist.get_world_size(_group(mesh, axis))
    return _ordered_sum(recvd.unflatten(0, (n, -1))).movedim(0, dim)


def psum(x: torch.Tensor, mesh: ProcessMesh, axis: Axis) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``: the sum of every member's ``x``."""
    return _ordered_sum(all_gather(x[None], mesh, axis))


def hierarchical_psum(x: torch.Tensor, mesh: ProcessMesh, fast_axis: str,
                      slow_axis: str, scatter_dim: int = 0) -> torch.Tensor:
    """All-reduce over (fast x slow) with the slow stage at 1/Kr volume."""
    x = psum_scatter(x, mesh, fast_axis, scatter_dim)
    x = psum(x, mesh, slow_axis)
    return all_gather(x, mesh, fast_axis, scatter_dim)


def hierarchical_psum_scatter(x: torch.Tensor, mesh: ProcessMesh,
                              fast_axis: str, slow_axis: str,
                              scatter_dim: int = 0) -> torch.Tensor:
    """Reduce-scatter over both tiers (result sharded over fast axis)."""
    x = psum_scatter(x, mesh, fast_axis, scatter_dim)
    return psum(x, mesh, slow_axis)


def hierarchical_all_to_all(x: torch.Tensor, mesh: ProcessMesh,
                            fast_axis: str, slow_axis: str, *,
                            split_axis: int = 0,
                            concat_axis: int = 0) -> torch.Tensor:
    """Two-stage all-to-all over a (slow, fast) product of axes.

    x: [..., n_slow * n_fast, ...] along ``split_axis`` — one slice per
    global destination, ordered slow-major (destination pod, then in-pod
    slot, matching the mesh's rank order).

    Stage 1 bundles all slices bound for pod p into ONE slow-axis message
    (the paper's multicast-bundling of the cross-rack stage); stage 2
    delivers within the pod on fast links.  Equal to
    :func:`flat_all_to_all`, but the slow tier carries each byte exactly
    once in 1 bundled flow instead of Kr distinct flows.
    """
    n_slow, n_fast = mesh.axis_size(slow_axis), mesh.axis_size(fast_axis)
    split_axis %= x.dim()
    n = x.shape[split_axis]
    if n != n_slow * n_fast:
        raise ValueError(f"split axis has {n} slices; the ({slow_axis}, "
                         f"{fast_axis}) grid has {n_slow} x {n_fast}")
    xs = x.unflatten(split_axis, (n_slow, n_fast))
    # stage 1: cross-pod exchange of pod bundles (slow tier)
    xs = all_to_all(xs, mesh, slow_axis, split_axis)
    # stage 2: the in-pod slot axis is still the destination slot
    xs = all_to_all(xs, mesh, fast_axis, split_axis + 1)
    out = xs.flatten(split_axis, split_axis + 1)
    return out.movedim(split_axis, concat_axis)


def flat_all_to_all(x: torch.Tensor, mesh: ProcessMesh, fast_axis: str,
                    slow_axis: str, *, split_axis: int = 0,
                    concat_axis: int = 0) -> torch.Tensor:
    """Baseline: single all_to_all over the joint (slow, fast) axis."""
    out = all_to_all(x, mesh, (slow_axis, fast_axis), split_axis)
    return out.movedim(split_axis, concat_axis)


def coded_cross_pod_allreduce(chunk_grads: torch.Tensor, mesh: ProcessMesh,
                              slow_axis: str, P_: int,
                              failed: Optional[int] = None) -> torch.Tensor:
    """The r=2 coded reduce-scatter + all-gather over the slow axis (see
    :mod:`repro_torch.core.gradient_sync` for the scheme)."""
    from ..core.gradient_sync import coded_reduce_scatter_r2
    shard = coded_reduce_scatter_r2(chunk_grads, mesh, slow_axis, P_,
                                    failed=failed)
    return all_gather(shard, mesh, slow_axis)
