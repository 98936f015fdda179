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
                    dtype: torch.dtype = torch.float32) -> Dict:
    """The port's parameters from a JAX parameter tree of numpy arrays, on
    ``device`` (default: the CUDA card; raises without one) in ``dtype``
    (``FP32_LEAVES`` in float32)."""
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
