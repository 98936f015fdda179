"""Sharded npz checkpoints with a JSON manifest: save / restore / resume
(the port of ``repro/train/checkpoint.py``, the same on-disk format).

Layout (one step):
    <dir>/step_000123/
        manifest.json     leaf keys by path, shapes, dtypes, shard map
        shard_00000.npz   leaf arrays (chunked so no file exceeds ~2 GB)

A leaf's key is its path in the tree, dict keys and list indices joined by
``/`` (dicts in sorted key order, as the JAX package flattens them).  The
port's layer stacks are lists of per-layer dicts, so its keys name a layer
(``params/group0/3/attn/wq``) where the JAX package's name a stacked leaf.
numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits and the
manifest records ``"bfloat16"``, so a restore gives back the same bits.

Writes are atomic (tmp dir + rename), so a preemption mid-save never
corrupts the latest checkpoint; ``keep_last`` prunes old steps.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .optimizer import tree_unflatten

_MAX_SHARD_BYTES = 2 << 30


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the tree's leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(state: Any, ckpt_dir: str, step: int,
                    keep_last: Optional[int] = 3) -> str:
    """Write ``state`` (a tree of tensors) atomically; returns the final
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        manifest: Dict[str, Any] = {"step": step, "leaves": {}, "shards": []}
        shard_idx, shard_bytes, shard_data = 0, 0, {}
        for key, leaf in _leaf_paths(state):
            arr, dtype = _to_numpy(leaf)
            nb = arr.nbytes
            if shard_bytes and shard_bytes + nb > _MAX_SHARD_BYTES:
                _flush(tmp, shard_idx, shard_data, manifest)
                shard_idx, shard_bytes, shard_data = shard_idx + 1, 0, {}
            safe = f"a{len(manifest['leaves'])}"
            shard_data[safe] = arr
            shard_bytes += nb
            manifest["leaves"][key] = {
                "shard": shard_idx, "name": safe,
                "shape": list(arr.shape), "dtype": dtype}
        _flush(tmp, shard_idx, shard_data, manifest)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep_last is not None:
        for old in sorted(list_steps(ckpt_dir))[:-keep_last]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                          ignore_errors=True)
    return final


def _flush(tmp: str, idx: int, data: Dict[str, np.ndarray],
           manifest: Dict) -> None:
    path = os.path.join(tmp, f"shard_{idx:05d}.npz")
    np.savez(path, **data)
    manifest["shards"].append(os.path.basename(path))


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.startswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(like: Any, ckpt_dir: str,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors: each
    restored leaf takes its like's device, and its dtype from the
    manifest).  Returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards = {i: np.load(os.path.join(path, s))
              for i, s in enumerate(manifest["shards"])}
    like_leaves = _leaf_paths(like)
    missing = [k for k, _ in like_leaves if k not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    restored = []
    for key, leaf in like_leaves:
        meta = manifest["leaves"][key]
        arr = shards[meta["shard"]][meta["name"]]
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {arr.shape} != {want}")
        t = torch.from_numpy(np.array(arr))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        restored.append(t.to(dev))
    return tree_unflatten(like, restored), step
