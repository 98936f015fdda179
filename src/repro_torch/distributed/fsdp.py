"""ZeRO-3 on a process mesh: the FSDP overlay of the port's sharding
layer, executed.

The JAX package trains its large models with ``param_pspecs(...,
fsdp=True)``: each parameter of at least 2^16 elements has its largest
still-replicated dim split over the ``fsdp`` rule's mesh axis (``'data'``),
its AdamW moments likewise, and ``_grad_constraint`` pins each gradient to
that spec, so GSPMD gathers a weight before its use and reduce-scatters its
gradient.  The port runs the same layout with explicit collectives:

* :class:`Zero3` reads the overlaid specs and cuts each leaf, after the
  tensor-parallel cut of :mod:`.tensor_parallel`, along the dim the
  overlay chose (``'dim'``), or by whole layers where the overlay chose a
  stack's ``layers`` dim (``'layers'``: the device at data coordinate k
  holds layers ``[k L/n, (k+1) L/n)`` of that leaf and an empty tensor,
  leading dim 0, for the others).  Leaves the overlay leaves alone stay
  replicated (``'rep'``).
* :class:`_GatherData` gathers a leaf before its use: an all-gather over
  the axis forward and a ``psum_scatter`` backward, the reduce-scatter of
  ``_grad_constraint``.  :mod:`repro_torch.models.lm` applies it inside
  each layer's (checkpointed) function, so a remat recompute gathers again
  and no gathered weight outlives its layer, and to the top-level leaves
  at each use (a tied embedding gathers twice, and its two gradients add).
  A leaf split by layers is gathered once a stack, ``[L, ...]``, and
  indexed by layer.

The gradients a step gets are therefore summed over the axis; the trainer
divides them by its size (:mod:`repro_torch.train.trainer`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import collectives as col
from .meshes import ProcessMesh
from .sharding import (ShardingPolicy, active_policy, axes_size,
                       map_with_path, param_pspecs)


class _GatherData(torch.autograd.Function):
    """All-gather over the FSDP axis along ``dim`` forward;
    ``psum_scatter`` back to this rank's block backward."""
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return col.all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (col.psum_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _set(tree, path: str, value) -> None:
    *head, last = path.split("/")
    node = _get(tree, "/".join(head)) if head else tree
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def active_axis(policy: Optional[ShardingPolicy]) -> Optional[str]:
    """The FSDP axis of ``policy`` where it splits anything: the ``fsdp``
    rule's mesh axis when the mesh has it at a size above 1, else None."""
    if policy is None:
        return None
    axis = policy.rules.get("fsdp")
    if axis is None or axis not in policy.mesh.shape:
        return None
    return axis if axes_size(policy.mesh, axis) > 1 else None


class Zero3:
    """Where each leaf of a parameter tree of ``template``'s structure
    splits over the FSDP axis of ``policy`` (see the module docstring).
    ``plan[path]`` is ('rep', None), ('dim', d) or ('layers', owner), for
    a leaf's path as :func:`~.sharding.map_with_path` names it."""

    def __init__(self, template: Dict, policy: ShardingPolicy):
        self.mesh = policy.mesh
        self.axis = policy.rules["fsdp"]
        self.size = axes_size(self.mesh, self.axis)
        self.plan: Dict[str, Tuple[str, Optional[int]]] = {}
        # stack name -> inner path -> stack length, for leaves split by
        # whole layers
        self.stacked: Dict[str, Dict[str, int]] = {}
        map_with_path(self._plan_leaf,
                      param_pspecs(template, policy, fsdp=True))

    def _plan_leaf(self, path: str, spec, stack) -> None:
        layers = getattr(spec, "layers", None)
        if layers is not None:
            if layers != self.axis:
                raise NotImplementedError(
                    f"{path}: its stack split over {layers!r} (only the "
                    f"FSDP axis {self.axis!r} splits layers)")
            self.plan[path] = ("layers", spec.owner(self.size))
            name, _, inner = path.split("/", 2)
            self.stacked.setdefault(name, {})[inner] = spec.stack
        elif self.axis in spec:
            self.plan[path] = ("dim", spec.index(self.axis))
        else:
            self.plan[path] = ("rep", None)

    def rank(self, data_rank: Optional[int] = None) -> int:
        if data_rank is not None:
            return data_rank
        if not isinstance(self.mesh, ProcessMesh):
            raise ValueError("a shape-only mesh has no rank: pass "
                             "data_rank")
        return self.mesh.axis_index(self.axis)

    # -- cutting and gathering whole trees (no autograd) -----------------
    def shard_leaf(self, path: str, x: torch.Tensor,
                   data_rank: Optional[int] = None) -> torch.Tensor:
        """This rank's block of ``x``, a leaf already cut for the model
        axis: a view of it (an empty one for a layer held elsewhere)."""
        kind, arg = self.plan[path]
        if kind == "rep":
            return x
        k = self.rank(data_rank)
        if kind == "dim":
            n = x.shape[arg] // self.size
            return x.narrow(arg, k * n, n)
        return x if arg == k else x.narrow(0, 0, 0)

    def _block(self, layers: list, inner: str) -> torch.Tensor:
        """This rank's layers of a leaf split by layers, stacked: the
        owned leaves, in order (the others are empty)."""
        per = len(layers) // self.size
        owned = _get(layers[self.rank() * per], inner)
        flat = torch.cat([_get(layer, inner).reshape(-1)
                          for layer in layers])
        return flat.reshape((per,) + tuple(owned.shape))

    def gather_tree(self, local):
        """The tree of ``local``'s structure with every split leaf whole
        (each leaf cut for the model axis only); every rank of the axis
        calls it."""
        def gather(path, x, stack):
            kind, arg = self.plan[path]
            if kind == "dim":
                return col.all_gather(x, self.mesh, self.axis, arg)
            return x
        out = map_with_path(gather, local)
        for name, inners in self.stacked.items():
            for inner in inners:
                full = col.all_gather(self._block(local[name], inner),
                                      self.mesh, self.axis, 0)
                for j in range(full.shape[0]):
                    _set(out, f"{name}/{j}/{inner}", full[j].clone())
        return out

    # -- gather before use (autograd) -------------------------------------
    def leaf(self, path: str, x: torch.Tensor) -> torch.Tensor:
        kind, arg = self.plan[path]
        if kind == "dim":
            return _GatherData.apply(x, self.mesh, self.axis, arg)
        if kind == "layers":
            raise ValueError(f"{path} is split by layers: gather its stack "
                             f"(stack_blocks)")
        return x

    def tree(self, path: str, sub):
        """A top-level subtree (``embed``, ``final_norm``, ...) with each
        split leaf gathered."""
        return map_with_path(lambda p, x, stack: self.leaf(p, x), sub, path)

    def stack_blocks(self, name: str, layers: list) -> Dict[str, torch.Tensor]:
        """The whole ``[L, ...]`` of each leaf of stack ``name`` that is
        split by layers: one gather a stack."""
        return {inner: _GatherData.apply(self._block(layers, inner),
                                         self.mesh, self.axis, 0)
                for inner in self.stacked.get(name, ())}

    def layer(self, name: str, li: int, p: Dict,
              blocks: Dict[str, torch.Tensor]) -> Dict:
        """Layer ``li`` of stack ``name`` with its split leaves gathered
        (``blocks`` from :meth:`stack_blocks`)."""
        def use(path, x, stack):
            kind, arg = self.plan[f"{name}/{li}/{path}"]
            return blocks[path][li] if kind == "layers" else self.leaf(
                f"{name}/{li}/{path}", x)
        return map_with_path(use, p)


def for_call(cfg) -> Optional[Zero3]:
    """The ZeRO-3 layout a model call runs under: None without an active
    policy or where its FSDP axis splits nothing."""
    pol = active_policy()
    if active_axis(pol) is None:
        return None
    if not isinstance(pol.mesh, ProcessMesh):
        raise ValueError("running ZeRO-3 needs a ProcessMesh; a shape-only "
                         "mesh gives specs only")
    from .tensor_parallel import layout
    return layout(cfg, pol).zero3


__all__ = ["Zero3", "for_call", "active_axis"]
