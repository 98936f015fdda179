"""Logical-axis sharding: per-arch partition specs for parameters, batches
and caches (the port's ``repro/distributed/sharding.py``).

A :class:`ShardingPolicy` maps *logical* axis names (batch, embed, ffn,
heads, kv_heads, vocab, experts, ...) to mesh axes, and
:func:`param_pspecs` walks the parameter tree and assigns logical axes by
leaf path (t5x-style path rules, the JAX package's ``_PARAM_RULES``
verbatim), so the port computes the same specs as the JAX package.

Default production policy (16 x 16 per pod):
  batch   -> ('pod', 'data')   [dp_flat]  or  ('data',)  [dp_hybrid: the
             paper's map-replication across pods]
  heads / kv_heads / ffn / experts / vocab / qkv -> 'model'   (TP / EP)
  embed   -> None (replicated) or 'data' under FSDP overlay (ZeRO-3)

What differs from the JAX package:

* A spec is this module's :class:`PartitionSpec`, a tuple of entries that
  are ``None``, a mesh-axis name or a tuple of names (the content of
  ``jax.sharding.PartitionSpec``).
* The policy reads only ``mesh.shape``: the mesh is a
  :class:`~.meshes.ProcessMesh` (ranks that run) or a shape-only
  :class:`~.meshes.MeshShape`, which stands in for the dry run's fake
  devices so that specs at 256 or 512 devices need no ranks.
* The port's parameter tree holds each layer stack as a list of per-layer
  dicts (``group0/3/attn/wq``): a leaf under ``group<i>/<j>/`` or
  ``encoder/<j>/`` gets the spec of the JAX package's stacked leaf
  ``[L, ...]`` without its leading ``layers`` entry, the spec that
  :mod:`repro_torch.models.convert` carries across.  That entry is kept on
  the spec (a :class:`LayerSpec`): where the FSDP overlay puts a mesh axis
  on the stacked ``layers`` dim, the device at coordinate k on that axis
  holds layers ``[k L/n, (k+1) L/n)`` whole and no other, and
  :func:`local_shape` counts layer j so.  Caches keep the plain spec.
* GSPMD's activation hints (``shard_acts``, ``sp_gather``, ``sp_scatter``)
  have no counterpart here: the port runs tensor parallelism as explicit
  collectives (:mod:`.tensor_parallel`), at the points where the JAX model
  code places the hints.  ``named_sharding_tree`` has no counterpart.
"""
from __future__ import annotations

import contextlib
import functools
import re
import threading
from math import prod
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh-axis
    name, or a tuple of names (sharded over their product).  As in
    ``jax.sharding.PartitionSpec``, a tuple of one name is that name and
    an empty tuple is None."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, (canon(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _layer_spec(layers, pos: int, stack: int, entries: tuple):
    return LayerSpec(layers, pos, stack, *entries)


class LayerSpec(PartitionSpec):
    """The spec of layer ``pos`` of a stack of ``stack`` layers: the
    stacked leaf's spec without its leading entry, which is kept as
    ``layers`` (None, or the mesh axis that splits the stack by whole
    layers).  It compares as the tuple of the remaining entries."""

    def __new__(cls, layers, pos: int, stack: int, *entries):
        self = super().__new__(cls, *entries)
        self.layers = PartitionSpec(layers)[0]
        self.pos, self.stack = pos, stack
        return self

    def __reduce__(self):
        return _layer_spec, (self.layers, self.pos, self.stack, tuple(self))

    def __repr__(self) -> str:
        return (f"LayerSpec(layers={self.layers!r}, {self.pos}/"
                f"{self.stack}, {tuple.__repr__(self)})")

    def owner(self, n: int) -> int:
        """The coordinate, on an axis of ``n`` devices that splits the
        stack by whole layers, of the device that holds this layer."""
        return self.pos // (self.stack // n)


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

class ShardingPolicy:
    """rules: logical axis -> mesh axis (str | tuple | None).  ``mesh`` is
    anything with a ``shape`` dict of axis sizes."""

    def __init__(self, mesh, rules: Dict[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)


def default_rules(multi_pod: bool, dp_mode: str = "dp_flat",
                  fsdp: bool = True) -> Dict[str, Any]:
    """Mesh-axis assignment for the production mesh.

    dp_mode='dp_hybrid' replicates the batch over 'pod' — the paper's map
    replication with r = n_pods: every pod computes every chunk, so the
    cross-pod gradient collective vanishes (L_cro -> 0 at r = P corner).
    """
    batch = (("pod", "data") if (multi_pod and dp_mode == "dp_flat")
             else ("data",))
    return {
        "batch": batch,
        "embed": None,
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "qkv": "model",
        "vocab": "model",
        "experts": "model",
        "fsdp": "data" if fsdp else None,
        "seq": None,
        "cache_batch": batch,          # KV-cache batch dim
        "cache_feature": "model",      # KV-cache feature dim
        # Megatron-style sequence parallelism: residual-stream boundaries
        # sharded over the TP axis (bytes-neutral; boundary memory / TP)
        "seq_tp": None,
    }


def with_sequence_tp(rules: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(rules)
    out["seq_tp"] = "model"
    return out


def serve_tp2d_rules(multi_pod: bool) -> Dict[str, Any]:
    """2D tensor-parallel SERVING policy: weights statically sharded over
    the whole mesh (('data','model') on their parallel dim) so decode
    moves activations instead of weight shards; the KV cache stays
    batch-sharded over the data tier."""
    rules = default_rules(multi_pod, fsdp=False)
    tp2 = (("pod", "data", "model") if multi_pod else ("data", "model"))
    for k in ("qkv", "ffn", "heads", "kv_heads", "vocab", "experts"):
        rules[k] = tp2
    rules["batch"] = None
    rules["cache_batch"] = (("pod", "data") if multi_pod else ("data",))
    rules["cache_feature"] = "model"
    return rules


def sequence_parallel_rules(multi_pod: bool, dp_mode: str = "dp_flat",
                            fsdp: bool = True) -> Dict[str, Any]:
    """Long-context variant: shard the sequence axis of activations over
    'data' (batch too small to fill the mesh, e.g. long_500k B=1)."""
    rules = default_rules(multi_pod, dp_mode, fsdp)
    rules["seq"] = "data"
    rules["batch"] = None
    return rules


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    """Make ``policy`` the active one in this thread for the block."""
    prev = getattr(_STATE, "policy", None)
    _STATE.policy = policy
    try:
        yield policy
    finally:
        _STATE.policy = prev


def active_policy() -> Optional[ShardingPolicy]:
    return getattr(_STATE, "policy", None)


def axes_size(mesh, m) -> int:
    """Devices along mesh axis ``m`` (a name, a tuple of names, or None)."""
    if m is None:
        return 1
    axes = m if isinstance(m, tuple) else (m,)
    return prod(mesh.shape[a] for a in axes)


# ---------------------------------------------------------------------------
# Parameter logical axes by leaf path
# ---------------------------------------------------------------------------

# (path regex, logical axes WITHOUT the stacked-layer axis). Checked in order.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / head
    (r"embed$", ("vocab", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    # attention projections (fused head dims)
    (r"attn/(wq|wk|wv)$|xattn/(wq|wk|wv)$", ("embed", "qkv")),
    (r"attn/(bq|bk|bv)$|xattn/(bq|bk|bv)$", ("qkv",)),
    (r"attn/wo$|xattn/wo$", ("qkv", "embed")),
    # MLA
    (r"attn/w_dkv$", ("embed", None)),
    (r"attn/kv_norm$", (None,)),
    (r"attn/w_uk$|attn/w_uv$", (None, "qkv")),
    # MoE (experts on the model axis = expert parallelism; when the expert
    # count doesn't divide the axis — grok's 8 experts on TP16 — the spec
    # resolver falls through to sharding the expert FFN dim instead)
    (r"moe/router$", ("embed", None)),
    (r"moe/w1$|moe/w3$", ("experts", "embed", "ffn")),
    (r"moe/w2$", ("experts", "ffn", "embed")),
    (r"moe/shared_w1$|moe/shared_w3$", ("embed", "ffn")),
    (r"moe/shared_w2$", ("ffn", "embed")),
    # dense MLPs (swiglu + whisper gelu)
    (r"mlp/w1$|mlp/w3$", ("embed", "ffn")),
    (r"mlp/b1$", ("ffn",)),
    (r"mlp/w2$", ("ffn", "embed")),
    (r"mlp/b2$", ("embed",)),
    # RWKV time-mix / channel-mix
    (r"tmix/(wr|wk|wv|wg)$", ("embed", "qkv")),
    (r"tmix/wo$", ("qkv", "embed")),
    (r"tmix/maa_w1$", ("embed", None)),
    (r"tmix/maa_w2$", (None, None, "embed")),
    (r"tmix/w_lora_a$", ("embed", None)),
    (r"tmix/w_lora_b$", (None, "embed")),
    (r"tmix/u$", ("heads", None)),
    (r"tmix/(mu_x|w0|gn_w|gn_b)$", ("embed",)),
    (r"tmix/mu$", (None, "embed")),
    (r"cmix/wk$", ("embed", "ffn")),
    (r"cmix/wv$", ("ffn", "embed")),
    (r"cmix/wr$", ("embed", "qkv")),
    (r"cmix/(mu_k|mu_r)$", ("embed",)),
    # Hymba SSM branch
    (r"ssm/(w_in|w_gate)$", ("embed", "qkv")),
    (r"ssm/conv$", (None, "qkv")),
    (r"ssm/conv_b$", ("qkv",)),
    (r"ssm/(w_B|w_C)$", ("qkv", None)),
    (r"ssm/w_dt$", ("qkv", "heads")),
    (r"ssm/dt_bias$", ("heads",)),
    (r"ssm/log_a$", ("heads", None)),
    (r"ssm/d_skip$", ("heads", None)),
    (r"ssm/w_out$", ("qkv", "embed")),
    # norms / everything 1-2D that falls through
    (r"(ln\d*|final_norm|enc_norm|in_norm)(/(w|b))?$", ("embed",)),
    (r"bn_a$|bn_s$", ("embed",)),
)

# a per-layer leaf of the port's tree: group<i>/<j>/... or encoder/<j>/...
_LAYER = re.compile(r"(group\d+|encoder)/\d+/")


@functools.lru_cache(maxsize=None)
def _rule_axes(path: str, base_ndim: int) -> Tuple[Optional[str], ...]:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            if len(axes) != base_ndim:
                raise ValueError(
                    f"rule {pat} gives {len(axes)} axes for {path} "
                    f"of base rank {base_ndim}")
            return tuple(axes)
    raise ValueError(f"no sharding rule for param {path!r} "
                     f"(rank {base_ndim})")


def map_with_path(fn: Callable, tree, path: str = "",
                  stack: Optional[int] = None):
    """``fn(path, leaf, stack)`` over a tree of dicts and lists: ``path``
    joins the keys and indices with '/', and ``stack`` is the length of
    the layer list a per-layer leaf sits in (None elsewhere)."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k), stack)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, join(i), len(tree))
                for i, v in enumerate(tree)]
    return fn(path, tree, stack if _LAYER.match(path) else None)


def _rule_path(path: str) -> str:
    """The path with its layer index dropped (the rules' view of it)."""
    return _LAYER.sub(lambda m: m.group(1) + "/", path, count=1)


def param_logical_axes(params: Any) -> Any:
    """Tree of logical-axis tuples mirroring ``params`` (a per-layer leaf
    carries no 'layers' axis: it is one layer of the JAX stacked leaf)."""
    return map_with_path(
        lambda path, leaf, stack: _rule_axes(_rule_path(path), leaf.ndim),
        params)


def _fsdp_overlay(spec: Tuple, shape: Tuple[int, ...], mesh,
                  axis: str = "data", min_size: int = 2 ** 16) -> Tuple:
    """Shard the largest still-replicated dim over the FSDP axis (ZeRO-3).
    Skips tiny params and dims not divisible by the axis size."""
    if prod(shape) < min_size or axis not in mesh.shape:
        return spec
    n = mesh.shape[axis]
    # pick the largest unsharded, divisible dim
    cands = [(d, i) for i, (d, s) in enumerate(zip(shape, spec))
             if s is None and d % n == 0]
    if not cands:
        return spec
    _, i = max(cands)
    out = list(spec)
    out[i] = axis
    return tuple(out)


def _resolve(leaf_axes, shape, policy: ShardingPolicy, fsdp: bool
             ) -> Tuple:
    """The JAX package's spec of a leaf of ``shape`` with ``leaf_axes``:
    dims must divide their mesh-axis product, and a mesh axis may be
    consumed at most once per leaf (first logical axis wins)."""
    resolved = [None if a in (None, "layers") else policy.rules.get(a)
                for a in leaf_axes]
    out, used = [], set()
    for dim, m in zip(shape, resolved):
        if m is None:
            out.append(None)
            continue
        axes = m if isinstance(m, tuple) else (m,)
        if dim % axes_size(policy.mesh, m) == 0 and not (set(axes) & used):
            out.append(m)
            used.update(axes)
        else:
            out.append(None)
    fsdp_axis = policy.rules.get("fsdp")
    if fsdp and fsdp_axis:
        out = list(_fsdp_overlay(tuple(out), tuple(shape), policy.mesh,
                                 fsdp_axis))
    return tuple(out)


def param_pspecs(params: Any, policy: ShardingPolicy,
                 fsdp: bool = False) -> Any:
    """PartitionSpec tree for the parameters under ``policy``.

    fsdp=True additionally shards each large parameter's largest replicated
    dim over the 'fsdp' rule axis (ZeRO-3 parameter/optimizer sharding).
    A per-layer leaf gets the stacked ``[L, ...]`` leaf's spec (the overlay
    too sees the stacked shape) as a :class:`LayerSpec`: the entries after
    the leading one, which it keeps as ``layers``."""
    def spec(path, leaf, stack):
        axes = _rule_axes(_rule_path(path), leaf.ndim)
        if stack is None:
            return P(*_resolve(axes, tuple(leaf.shape), policy, fsdp))
        full = _resolve(("layers",) + axes, (stack,) + tuple(leaf.shape),
                        policy, fsdp)
        return LayerSpec(full[0], int(path.split("/")[1]), stack, *full[1:])
    return map_with_path(spec, params)


def batch_pspecs(policy: ShardingPolicy, batch: Any) -> Any:
    """PartitionSpecs for a training/serving batch dict (batch axis 0;
    axes that don't divide the dim fall back to replication)."""
    b = policy.rules.get("batch")
    n = axes_size(policy.mesh, b)

    def spec(path, leaf, stack):
        if leaf.ndim == 0 or leaf.shape[0] % n != 0 or n == 1:
            return P(*([None] * leaf.ndim))
        return P(b, *([None] * (leaf.ndim - 1)))
    return map_with_path(spec, batch)


def cache_pspecs(policy: ShardingPolicy, cache: Any) -> Any:
    """PartitionSpecs for decode caches.

    The JAX package's leaves carry a leading stacked-layer axis (None),
    then [B, S, ...]; a per-layer leaf here gets that spec without it.
    Strategy: shard the batch dim over the cache_batch rule; shard ONE
    feature dim over cache_feature — the last one the model axis divides
    (the kv-head dim or, when heads don't divide, head_dim / latent /
    channel dims)."""
    b = policy.rules.get("cache_batch", policy.rules.get("batch"))
    m = policy.rules.get("cache_feature", policy.rules.get("heads"))
    nb = axes_size(policy.mesh, b)
    nm = axes_size(policy.mesh, m)

    def stacked(dims):
        out = [None] * len(dims)
        if len(dims) < 2:
            return out
        # dims[0] = stacked layer axis, dims[1] = batch
        if nb > 1 and dims[1] % nb == 0:
            out[1] = b
        # pick the LAST dim divisible by the model axis (feature-most)
        if nm > 1:
            for i in range(len(dims) - 1, 1, -1):
                if dims[i] % nm == 0:
                    out[i] = m
                    break
        return out

    def spec(path, leaf, stack):
        if stack is None:
            return P(*stacked(list(leaf.shape)))
        return P(*stacked([stack] + list(leaf.shape))[1:])
    return map_with_path(spec, cache)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in the order of
    :func:`repro_torch.train.optimizer.tree_leaves` (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in spec_leaves(v)]
    return [tree]


def _axes_coord(mesh, m, coords: Optional[Dict[str, int]] = None) -> int:
    """A device's coordinate on mesh axis ``m`` (a name or a tuple of
    names, row-major): from ``coords`` (axis -> index), else the mesh's own
    rank's where it has one, else 0."""
    axes = m if isinstance(m, tuple) else (m,)
    at = lambda a: (coords[a] if coords is not None
                    else mesh.axis_index(a) if hasattr(mesh, "axis_index")
                    else 0)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + at(a)
    return idx


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh,
                coords: Optional[Dict[str, int]] = None) -> Tuple[int, ...]:
    """The shape of one device's block of a leaf of ``shape`` under
    ``spec``: for a layer that its stack's split leaves to another device
    (:class:`LayerSpec`), an empty block (leading dim 0).  The device is
    the one at ``coords`` (see :func:`_axes_coord`)."""
    out = tuple(d // axes_size(mesh, m) for d, m in zip(shape, spec))
    lay = getattr(spec, "layers", None)
    if lay is not None and (_axes_coord(mesh, lay, coords)
                            != spec.owner(axes_size(mesh, lay))):
        out = (0,) + out[1:]
    return out


def tree_local_bytes(tree: Any, spec_tree: Any, mesh,
                     coords: Optional[Dict[str, int]] = None) -> int:
    """Per-device bytes of a sharded tree of tensors (exact, from the
    specs): the dry run's ``tree_local_bytes``, for the device at
    ``coords`` (see :func:`_axes_coord`; the same on every device)."""
    from ..train.optimizer import tree_leaves
    return sum(prod(local_shape(leaf.shape, spec, mesh, coords))
               * leaf.element_size()
               for leaf, spec in zip(tree_leaves(tree),
                                     spec_leaves(spec_tree)))
