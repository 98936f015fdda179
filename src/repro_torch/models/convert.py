"""Carry the JAX package's LM parameters into the port.

The JAX tree (``repro.models.lm.init_params``, as numpy arrays) holds each
layer stack as ``group<i>`` (and an enc-dec model's encoder as
``encoder``) with a leading ``[L]`` axis on every leaf; the port holds a
list of L per-layer dicts.  Weights stay ``[d_in, d_out]`` and
are used as ``x @ W`` on both sides, so nothing is transposed.  MoE
expert stacks ``[L, E, ...]`` split on the layer axis only.  Every leaf
takes the requested dtype but the MoE router and the SSM's ``log_a``,
which stay float32 as the JAX package keeps them (``FP32_LEAVES``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed.meshes import DeviceLike, resolve_device
from .lm import layer_groups

FP32_LEAVES = frozenset({"router", "log_a"})


def _tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)        # numpy has no native bfloat16
    # a copy: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _convert(tree, device, dtype):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device,
                            torch.float32 if k in FP32_LEAVES else dtype)
                for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(np_params: Mapping[str, Any], cfg: ArchConfig,
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32, *,
                    policy=None) -> Dict:
    """The port's parameters from a JAX parameter tree of numpy arrays, on
    ``device`` (default: the CUDA card; raises without one) in ``dtype``
    (``FP32_LEAVES`` in float32).  Under a sharding ``policy`` that splits
    anything (a model axis larger than 1, or an FSDP axis: ZeRO-3), this
    rank's shards of them
    (:func:`repro_torch.distributed.tensor_parallel.shard_params`)."""
    from ..distributed.fsdp import active_axis
    if policy is not None and (policy.mesh.shape.get("model", 1) > 1
                               or active_axis(policy) is not None):
        from ..distributed.tensor_parallel import shard_params
        full = params_from_jax(np_params, cfg, "cpu", dtype)
        local = shard_params(full, cfg, policy)
        dev = resolve_device(device)
        return _to(local, dev)
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    groups = {f"group{gi}": g.count
              for gi, g in enumerate(layer_groups(cfg))}
    if cfg.family == "encdec":
        groups["encoder"] = cfg.encoder_layers
    for name, sub in np_params.items():
        if name in groups:
            out[name] = [_convert(_layer(sub, i), dev, dtype)
                         for i in range(groups[name])]
        else:
            out[name] = _convert(sub, dev, dtype)
    return out


def _to(tree, dev: torch.device):
    """A tree's tensors as copies on ``dev`` (views of a larger tensor
    become tensors of their own)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev, copy=True).contiguous()


def _np_dtype(a) -> torch.dtype:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), a.dtype)).dtype


def _stacked_groups(cfg: ArchConfig) -> Dict[str, int]:
    groups = {f"group{gi}": g.count
              for gi, g in enumerate(layer_groups(cfg))}
    if cfg.family == "encdec":
        groups["encoder"] = cfg.encoder_layers
    return groups


def _split_like_params(np_tree: Mapping[str, Any], cfg: ArchConfig,
                       dev: torch.device) -> Dict:
    """A params-shaped tree (AdamW's m or v) in each leaf's own dtype,
    layer stacks split on their leading [L] axis."""
    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, dev, _np_dtype(tree))
    groups = _stacked_groups(cfg)
    return {name: ([conv(_layer(sub, i)) for i in range(groups[name])]
                   if name in groups else conv(sub))
            for name, sub in np_tree.items()}


def train_state_from_jax(np_state: Mapping[str, Any], cfg: ArchConfig,
                         device: DeviceLike = None,
                         dtype: torch.dtype = torch.float32) -> Dict:
    """The port's train state ({"params", "opt", "step"}, as
    :func:`repro_torch.train.trainer.init_train_state` makes it) from a
    JAX train state of numpy arrays: params as :func:`params_from_jax`
    carries them (in ``dtype``), AdamW's m and v split per layer in their
    own dtype, Adafactor's vr / vc / v as stacked fp32 tensors, ``count``
    and ``step`` as int32 scalars; on ``device`` (default: the CUDA card;
    raises without one)."""
    dev = resolve_device(device)
    scalar = lambda x: torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                                    device=dev)
    opt = np_state["opt"]
    if "v" in opt:                                        # AdamW
        new_opt = {"m": _split_like_params(opt["m"], cfg, dev),
                   "v": _split_like_params(opt["v"], cfg, dev)}
    else:                                                 # Adafactor
        new_opt = {"m": _convert(opt["m"], dev, torch.float32)}
    new_opt["count"] = scalar(opt["count"])
    return {"params": params_from_jax(np_state["params"], cfg, dev, dtype),
            "opt": new_opt, "step": scalar(np_state["step"])}
