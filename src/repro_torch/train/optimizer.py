"""AdamW and Adafactor with a warmup-cosine schedule: the port of
``repro/train/optimizer.py``.

Parameters, gradients and optimizer state are trees of tensors (nested
dicts and lists, as :func:`repro_torch.models.lm.init_params` makes them);
the updates are plain functions that return new trees.  Every update is
computed in fp32 and cast back to each leaf's dtype, so ``moment_dtype=
torch.bfloat16`` keeps AdamW's m and v in bf16 (half the optimizer memory)
while the arithmetic stays fp32.  Global-norm clipping is fused into the
update.

Under a sharded layout (``tp``, a
:class:`repro_torch.distributed.tensor_parallel.TensorParallel`: the model
axis, ZeRO-3's FSDP axis, or both) the trees hold this rank's shards.
AdamW is elementwise, so it runs on them as they are, and the global norm
counts each element of the unsharded model once
(``TensorParallel.sum_squares``), so clipping is the unsharded step's.
Adafactor's state is the factored state of the local shards; its row and
column means, the mean of its row statistic and its update-clip RMS are
means over the unsharded leaf (``TensorParallel.full_mean``: partial sums
summed over the axis that splits the averaged dim, over the full size),
so its update is the unsharded one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"                 # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: Any = torch.float32   # bf16 halves optimizer memory


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure: dicts and lists are rebuilt, anything else
    (a tensor, a tuple) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree, dicts in sorted key order (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr`` (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init_opt_state(params: Any, cfg: OptimizerConfig) -> Dict:
    if cfg.kind == "adafactor":
        return init_adafactor_state(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any, tp=None) -> torch.Tensor:
    """The l2 norm of every leaf; of the unsharded tree under ``tp``."""
    if tp is not None:
        return torch.sqrt(tp.sum_squares(tree))
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(cfg: OptimizerConfig, gnorm: torch.Tensor) -> torch.Tensor:
    if cfg.clip_norm is None:
        return torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def adamw_update(grads: Any, opt_state: Dict, params: Any,
                 cfg: OptimizerConfig, tp=None,
                 ) -> Tuple[Any, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_opt_state, metrics)."""
    count = opt_state["count"] + 1
    lr = lr_at(cfg, count).to(count.device)
    gnorm = global_norm(grads, tp)
    scale = _clip_scale(cfg, gnorm)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        newp = p.float() - lr * step
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    flat = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda t: t[i], flat)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, metrics


# ---------------------------------------------------------------------------
# Adafactor (factored second moment over the two trailing dims, no first
# moment): optimizer state of about rows + cols a matrix instead of 2x its
# parameters.  The JAX package factors its layer-stacked leaves ([L, ...]):
# a stacked 2-D weight per layer, and also a stacked 1-D leaf (a norm, a
# bias), whose [L, d] it factors over (layer, d).  The port keeps each layer
# stack (a list of per-layer dicts) stacked for Adafactor: its state holds
# one stacked entry a leaf of the stack, and the update runs on the stacked
# leaves, so it equals the JAX package's.
# ---------------------------------------------------------------------------

def _held(xs) -> list:
    """The per-layer leaves of one leaf of a stack that this rank holds:
    all of them, or, where ZeRO-3 splits the stack by whole layers, the
    non-empty ones (the others have a leading dim of 0)."""
    if all(x.shape == xs[0].shape for x in xs):
        return list(xs)
    return [x for x in xs if x.numel()]


def _stack(layers: list):
    """A list of same-structure per-layer trees as one tree of [L, ...]
    tensors (of the layers this rank holds, see :func:`_held`)."""
    return tree_map(lambda *xs: torch.stack(_held(xs)), layers[0],
                    *layers[1:])


def _unstack(stacked, layers: list) -> list:
    """The inverse of :func:`_stack`: the per-layer trees of ``stacked``
    (a layer held elsewhere keeps its empty leaf from ``layers``)."""
    def split(s, *xs):
        rows = iter(s)
        return tuple(next(rows) if x.numel() or len(_held(xs)) == len(xs)
                     else x for x in xs)
    parts = tree_map(split, stacked, *layers)
    return [tree_map(lambda t: t[i], parts) for i in range(len(layers))]


def _factored_state(shape: tuple, device) -> Dict:
    f32 = dict(dtype=torch.float32, device=device)
    if len(shape) >= 2:
        # factor over the two trailing dims (stacked layers keep lead)
        return {"vr": torch.zeros(shape[:-1], **f32),
                "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
    return {"v": torch.zeros(shape, **f32)}


def _init_factored(tree):
    if isinstance(tree, dict):
        return {k: _init_factored(v) for k, v in tree.items()}
    if isinstance(tree, list):          # a layer stack: stacked state
        return tree_map(lambda *xs: _factored_state(
            (len(_held(xs)),) + tuple(_held(xs)[0].shape), xs[0].device),
            tree[0], *tree[1:])
    return _factored_state(tuple(tree.shape), tree.device)


def init_adafactor_state(params: Any) -> Dict:
    dev = tree_leaves(params)[0].device
    return {"m": _init_factored(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adafactor_update(grads: Any, opt_state: Dict, params: Any,
                     cfg: OptimizerConfig, tp=None,
                     ) -> Tuple[Any, Dict, Dict[str, torch.Tensor]]:
    count = opt_state["count"] + 1
    lr = lr_at(cfg, count).to(count.device)
    gnorm = global_norm(grads, tp)
    scale = _clip_scale(cfg, gnorm)
    c = count.to(torch.float32)
    b2 = 1.0 - c ** -0.8                      # Adafactor's decay schedule
    eps = 1e-30

    def mean(x, tags, dim=None):
        """The mean over ``dim`` (default: all) of the unsharded tensor
        of which ``x`` is this rank's block (split as ``tags`` say)."""
        if tp is None:
            return torch.mean(x) if dim is None else x.mean(dim=dim)
        return tp.full_mean(x, tags, None if dim is None else (dim,))

    def upd(p, g, st, tags):
        g = g.float() * scale
        g2 = g * g + eps
        if p.ndim >= 2:
            vr = b2 * st["vr"] + (1 - b2) * mean(g2, tags, -1)
            vc = b2 * st["vc"] + (1 - b2) * mean(g2, tags, -2)
            row = mean(vr, None if tags is None else tags[:-1], -1)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(row[..., None, None], min=eps))
            u = g * torch.rsqrt(denom + eps)
            new_st = {"vr": vr, "vc": vc}
        else:
            v = b2 * st["v"] + (1 - b2) * g2
            u = g * torch.rsqrt(v + eps)
            new_st = {"v": v}
        # update clipping (RMS <= 1) + decoupled weight decay
        rms = torch.sqrt(mean(u * u, tags) + eps)
        u = u / torch.clamp(rms, min=1.0)
        newp = p.float() * (1 - lr * cfg.weight_decay) - lr * u
        return newp.to(p.dtype), new_st

    def walk(p, g, st, path, stack=None):
        """(new params, new state) of a subtree at ``path`` (inside layer
        stack ``stack``: the path below it); a layer stack is updated as
        its stacked leaves and split again."""
        join = (lambda k: f"{path}/{k}") if path else str
        if isinstance(p, dict):
            out = {k: walk(p[k], g[k], st[k], join(k), stack) for k in p}
            return ({k: v[0] for k, v in out.items()},
                    {k: v[1] for k, v in out.items()})
        if isinstance(p, list):
            newp, new_st = walk(_stack(p), _stack(g), st, "", path)
            return _unstack(newp, p), new_st
        if isinstance(st, dict) and ("vr" in st or "v" in st):
            tags = (None if tp is None else tp.tags(path) if stack is None
                    else tp.stacked_tags(stack, path))
            return upd(p, g, st, tags)
        raise ValueError(f"adafactor: state {type(st)} does not fit a "
                         f"parameter leaf")

    new_params, new_m = walk(params, grads, opt_state["m"], "")
    return (new_params, {"m": new_m, "count": count},
            {"grad_norm": gnorm, "lr": lr})


def optimizer_update(grads: Any, opt_state: Dict, params: Any,
                     cfg: OptimizerConfig, tp=None):
    if cfg.kind == "adafactor":
        return adafactor_update(grads, opt_state, params, cfg, tp)
    return adamw_update(grads, opt_state, params, cfg, tp)
