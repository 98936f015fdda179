"""Tensor parallelism of the LM on a process mesh: the collective side of
the port's sharding layer.

The JAX package gives its sharding rules to GSPMD and marks activations
with ``shard_acts``; the compiler inserts the collectives.  The port's
kernels are ``ctypes`` launches on plain tensors, so it runs the same
rules as explicit tensor parallelism over the ``model`` axis of a
:class:`~.meshes.ProcessMesh`, with the named-axis collectives of
:mod:`.collectives` (which sum in rank order, so every rank of the model
axis holds the same bits):

* the Megatron pair :func:`copy_to_model` (identity forward, ``psum``
  backward) and :func:`reduce_from_model` (``psum`` forward, identity
  backward) around each attention, MLP and MoE block;
* the sequence-TP pair :func:`sp_gather` (all-gather on the sequence
  forward, ``psum_scatter`` backward) and :func:`sp_scatter`
  (``psum_scatter`` forward, all-gather backward), the counterparts of the
  JAX package's ``custom_vjp`` pair, used when the policy maps ``seq_tp``
  to ``model``: the residual stream between blocks is then split over the
  model axis along the sequence (as JAX's ``shard_acts``, only when the
  axis divides the sequence; a decode step runs plain TP);
* a vocab-parallel embedding (ids outside this rank's rows masked, a
  local lookup, :func:`reduce_from_model`), a column-parallel head
  (``lm_head``, or ``embed.T`` where tied) and a vocab-parallel
  cross-entropy (max, sum of exponentials and the target logit reduced
  over ``model``); a vocabulary that the axis does not divide stays
  replicated, as its spec says;
* greedy decoding reads logits all-gathered over ``model``, so every rank
  samples the same token.

Layout (:func:`shard_params`) is head-aligned where the heads split
whole.  Each rank holds a contiguous block of H/tp query heads, and KV/tp
kv heads where tp divides KV: there the layout is the spec's exactly.
Where tp is a multiple of KV (qwen2-72b's 8 kv heads at model 16, the
reduced configs' KV 2 at model 4), each rank holds the whole kv head its
query heads read, duplicated over the tp/KV ranks that share it, and the
gradients of the duplicated shards are summed over those ranks (inside
autograd, so every sharing rank holds the kv head's full gradient).  The
JAX spec splits such a head inside (``cache_pspecs`` shards the head
dim): the port keeps whole heads, tp/KV times the spec's bytes for those
leaves, a deliberate difference of layout.  Norms stay replicated; under
sequence TP their weights enter through :func:`copy_to_model`, whose
backward sums the per-shard gradients.

Heads that do not split whole split inside, as GSPMD partitions the JAX
specs (every family but MLA's latent, where the specs cut both column
widths: qwen2-1.5b's 12 query heads on 2 kv heads of 128, llava-next-34b's
56 on 8, whisper-large-v3's 20, rwkv6-3b's 40 WKV heads of 64, all at
model 16; Hymba always).  A rank holds columns [c0, c1) of the query and
kv widths, as the specs cut them (:class:`HeadBlock`), so its weight bytes
are the spec's.  It all-gathers q, k and v along the feature dim
(:meth:`TensorParallel.gather_heads`), runs attention over the query heads
its columns touch (qwen2-1.5b: 1-2 a rank at model 16) and the kv heads
those read (one, at G = 1-2; :meth:`HeadBlock.kv_segments` splits a block
whose query heads straddle kv heads unevenly into one GQA call a kv head),
keeps its columns of the output and multiplies them by its rows of
``wo``; a boundary head is computed on both ranks that share it, and the
gather's backward (a reduce-scatter) sums its gradient.  What the port
keeps whole where the specs cut inside a head, a deliberate difference of
layout (``ROADMAP.md``, queue 3, item 4): the decode caches hold the kv
heads a rank's query heads read, whole (qwen2-1.5b's decode cache 8 x
the spec's bytes at model 16, llava-next-34b's 2 x, whisper-large-v3's
self and cross caches 1.6 x), and RWKV's WKV state the heads a rank's
columns touch (3 of 64 x 64 at model 16, 1.2 x the spec's).  Whisper's
cross attention gathers its query the same way and its cache holds the
encoder's k and v at those kv heads.  RWKV's time mix gathers r, k, v and
the decay (:meth:`TensorParallel.touched_heads`), scans the touched heads
whole with ``u`` (whole on every rank, its gradient summed over
``model``) at those heads and GroupNorms them whole, keeps its columns,
and multiplies them by silu(g) at its columns and its rows of ``wo``.
Hymba keeps its own form: k and v expanded to the query heads (G = 1)
and its ring cache so.

The MoE family (DeepSeek-V2-Lite, Grok-1) runs as GSPMD partitions the
JAX program.  The tokens entering a MoE block are whole on every rank of
``model`` (the block input is gathered as any other's), so there is no
expert all-to-all: every rank routes and places the whole group alike,
runs its block of experts ``[r E/tp, (r+1) E/tp)`` on their slots (or,
where tp does not divide E, every expert on its block of the expert FFN
dim, as the spec resolver falls through to ``ffn``), the shared experts
on its FFN block, and its partial output is summed over ``model``.  MLA
splits ``wq``, ``w_uk`` and ``w_uv`` by whole heads and ``wo`` by rows;
its latent (``w_dkv``, ``kv_norm``) is computed whole on every rank and
its cache holds the whole latent (:mod:`repro_torch.models.mla`).  A
replicated weight that feeds a model-split computation (the router, MLA's
``w_dkv`` and ``kv_norm``) enters through :meth:`TensorParallel.
shared_weight`, whose backward sums its partial gradients over
``model``; the load-balance loss, computed whole and alike on every rank,
reads the block input through :meth:`TensorParallel.replicated`, so its
gradient is counted once.

Hymba (the ``hybrid`` family) splits inside its heads at any model axis:
25 query heads on 5 kv heads of 64 do not split
whole over 4 ranks, but the specs cut ``wq``, ``wk``, ``wv`` and the SSM's
``w_in``, ``w_gate`` and ``conv`` by columns and ``wo``, ``w_B``, ``w_C``,
``w_dt`` and ``w_out`` by rows all the same.  A rank holds columns
[c0, c1) of the inner width (:class:`HeadBlock`); it all-gathers q, k and
v along the feature dim (:meth:`TensorParallel.gather_heads`, a
``psum_scatter`` backward, so the two ranks that share a boundary head sum
its gradient), runs attention over the query heads its columns touch with
each kv head expanded to its query heads (G = 1), keeps its columns of the
output and multiplies them by its rows of ``wo``.  The SSM runs on its
columns in sub-heads of g = gcd(hd, inner/tp) columns: the recurrence is
independent along v's columns once q, k and the decay are whole, and those
come from the row-split ``w_B``, ``w_C`` and ``w_dt`` summed over
``model`` forward and backward (:meth:`TensorParallel.sum_partials`).

RWKV (:mod:`repro_torch.models.rwkv`) splits its time-mix by whole WKV
heads where they split whole (the state a rank holds is its heads; the
JAX ``cache_pspecs`` splits the head dim instead), else inside them as
above, and its channel-mix FFN by columns and rows;
its DDLerp, decay LoRA and GroupNorm stay whole and enter through
:meth:`TensorParallel.shared_weight` or, read at this rank's columns,
:func:`split_to_model` (its backward all-gathers the blocks' gradients).
The channel-mix value is a partial sum that multiplies the receptance, so
it is reduce-scattered to this rank's columns and the product all-gathered
(:meth:`TensorParallel.scatter_columns`,
:meth:`TensorParallel.gather_columns`).  The enc-dec family splits the
encoder's and both attentions' heads and the GELU MLP; its encoder output
is whole on every rank and its cross cache holds this rank's heads.

Execution covers the spec entries ``None`` and ``'model'``, and the
FSDP overlay's ``'data'`` (ZeRO-3, :mod:`.fsdp`): :class:`TensorParallel`
is the whole parameter layout of a policy, the model-axis cut here (at
model 1, none) and then the overlay's cut of :class:`.fsdp.Zero3`, for
every family at model 1 and for the families of ``TP_FAMILIES`` (all of
them) above it.  :meth:`TensorParallel.sum_squares` and
:meth:`TensorParallel.full_mean` give the optimizers sums and means of
the unsharded leaves.  2D serving weights (``serve_tp2d_rules``),
sequence sharding over ``data``, a geometry whose query or kv width the
model axis does not divide (heads that split neither whole nor inside)
and MLA heads that do not split whole raise ``NotImplementedError``
(``ROADMAP.md`` queues them).

Every ``psum`` under these collectives (:func:`.collectives.psum`) is a
reduce-scatter then an all-gather, as an all-reduce runs.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from . import collectives as col
from .meshes import DeviceLike, ProcessMesh
from .sharding import (ShardingPolicy, active_policy, axes_size,
                       map_with_path, param_pspecs)

MODEL = "model"
TP_FAMILIES = ("dense", "vlm", "moe", "ssm", "encdec", "hybrid")
_KV_LEAVES = ("wk", "wv", "bk", "bv")
# leaves whose spec must split over a model axis above 1 (attention, MLP,
# MoE; RWKV's projections, receptances and bonus; the GELU MLP's b1;
# Hymba's SSM projections, conv and output)
_SPLIT_LEAVES = ("wq", "wo", "bq", "w1", "w2", "w3", "w_uk", "w_uv",
                 "shared_w1", "shared_w2", "shared_w3", "wr", "wg", "u",
                 "b1", "w_in", "w_gate", "conv", "conv_b", "w_B", "w_C",
                 "w_dt", "w_out") + _KV_LEAVES
# per-head leaves that a layout inside heads reads whole where their spec
# leaves them whole (RWKV's bonus ``u`` at 40 heads over 16)
_HEAD_LEAVES = ("u",)


def _todo(what: str, where: str = " under a model axis > 1"
          ) -> NotImplementedError:
    return NotImplementedError(f"{what}{where} is not ported yet (see "
                               f"ROADMAP.md, queue 1)")


# ---------------------------------------------------------------------------
# Collectives with their transposes (torch.autograd.Function)
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return col.psum(g, ctx.mesh, MODEL), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return col.psum(x, mesh, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return col.all_gather(x, mesh, MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        return col.psum_scatter(g, ctx.mesh, MODEL, ctx.dim), None, None


class _SpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return col.psum_scatter(x, mesh, MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        return col.all_gather(g, ctx.mesh, MODEL, ctx.dim), None, None


def _block(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.axis_size(MODEL)
    return x.narrow(dim, mesh.axis_index(MODEL) * n, n)


class _GatherFromModel(torch.autograd.Function):
    """All-gather forward; backward keeps this rank's block (every rank
    holds the same full cotangent)."""
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return col.all_gather(x, mesh, MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.dim).contiguous(), None, None


class _SplitToModel(torch.autograd.Function):
    """This rank's block forward (the input is the same on every rank);
    all-gather backward."""
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _block(x, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return col.all_gather(g, ctx.mesh, MODEL, ctx.dim), None, None


class _SharedKV(torch.autograd.Function):
    """A kv shard duplicated over ``rep`` neighbouring ranks: identity
    forward; backward sums the gradient over the ranks that share it (in
    rank order, so they all hold the same bits)."""
    @staticmethod
    def forward(ctx, w, mesh, rep):
        ctx.mesh, ctx.rep = mesh, rep
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        parts = col.all_gather(g[None], ctx.mesh, MODEL)
        j = ctx.mesh.axis_index(MODEL) // ctx.rep
        return _ordered_sum(parts[j * ctx.rep:(j + 1) * ctx.rep]), None, None


class _Replicated(torch.autograd.Function):
    """``h`` forward (a whole block input, the same on every rank);
    backward hands its cotangent, the same on every rank, to ``local``, the
    block input before its gather (its block of the sequence under
    sequence TP), with no sum over ``model``."""
    @staticmethod
    def forward(ctx, h, local, mesh, seq):
        ctx.mesh, ctx.seq = mesh, seq
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        if ctx.seq:
            g = _block(g, ctx.mesh, 1).contiguous()
        return None, g, None, None


class _SumPartials(torch.autograd.Function):
    """``psum`` over ``model`` forward and backward: a partial sum that
    every rank reads at different entries, so each rank's cotangent is a
    part of the sum's."""
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return col.psum(x, mesh, MODEL)

    @staticmethod
    def backward(ctx, g):
        return col.psum(g, ctx.mesh, MODEL), None


def _ordered_sum(parts) -> torch.Tensor:
    acc = parts[0].clone()
    for part in parts[1:]:
        acc += part
    return acc


def copy_to_model(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """Identity forward, ``psum`` over ``model`` backward."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``psum`` over ``model`` forward, identity backward."""
    return _ReduceFromModel.apply(x, mesh)


def sp_gather(x: torch.Tensor, mesh: ProcessMesh,
              dim: int = 1) -> torch.Tensor:
    """Boundary [B, S/tp, ...] -> full sequence for the sublayer's math;
    the cotangent is reduce-scattered back."""
    return _SpGather.apply(x, mesh, dim)


def sp_scatter(x: torch.Tensor, mesh: ProcessMesh,
               dim: int = 1) -> torch.Tensor:
    """Sublayer partial output [B, S, ...] -> boundary, reduce-scattered
    over ``model`` (along ``dim``: this rank's block of the sum); the
    cotangent is all-gathered once."""
    return _SpScatter.apply(x, mesh, dim)


def gather_from_model(x: torch.Tensor, mesh: ProcessMesh,
                      dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim)


def split_to_model(x: torch.Tensor, mesh: ProcessMesh,
                   dim: int) -> torch.Tensor:
    return _SplitToModel.apply(x, mesh, dim)


# ---------------------------------------------------------------------------
# The layout of one config under one policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadBlock:
    """One rank's block of a layer whose heads split inside (Hymba):
    columns [c0, c1) of the inner width (q's and the SSM stream's), the
    query heads [h0, h1) those columns touch (a boundary head is computed
    on both ranks that share it), the kv heads [kv0, kv1) those heads read,
    and the SSM's sub-heads of ``g`` columns."""
    c0: int
    c1: int
    h0: int
    h1: int
    kv0: int
    kv1: int
    g: int
    hd: int
    group: int          # query heads a kv head

    @property
    def n_heads(self) -> int:
        return self.h1 - self.h0

    @property
    def n_sub(self) -> int:
        return (self.c1 - self.c0) // self.g

    def kv_of_heads(self) -> Tuple[int, ...]:
        """The kv head each of the block's query heads reads."""
        return tuple(h // self.group for h in range(self.h0, self.h1))

    def sub_heads(self) -> Tuple[int, ...]:
        """The head each of the block's SSM sub-heads lies in."""
        return tuple((self.c0 + j * self.g) // self.hd
                     for j in range(self.n_sub))

    def kv_segments(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """The block's query heads as GQA calls over its kv heads: (q0,
        q1, k0, k1), block-local, query heads q0:q1 reading kv heads k0:k1
        at G = (q1 - q0) / (k1 - k0).  One call where every kv head of the
        block is read by as many of its query heads (all of them at model
        16: one kv head a rank), else one a kv head."""
        kvs = self.kv_of_heads()
        counts = [kvs.count(j) for j in range(self.kv0, self.kv1)]
        if len(set(counts)) == 1:
            return ((0, self.n_heads, 0, self.kv1 - self.kv0),)
        out, q = [], 0
        for i, c in enumerate(counts):
            out.append((q, q + c, i, i + 1))
            q += c
        return tuple(out)


def _template(cfg: ArchConfig) -> Dict:
    from ..models import lm
    return lm.init_params(0, cfg, device="meta")


class TensorParallel:
    """How ``cfg``'s parameters split over the model axis of
    ``policy.mesh`` and, where the policy's FSDP axis splits anything,
    over that axis too (``zero3``, a :class:`.fsdp.Zero3`, else None), and
    the collectives the model runs on the model axis.  ``mesh`` may be a
    shape-only mesh (shapes and specs); running needs a
    :class:`ProcessMesh`.  ``model_rank`` and ``data_rank`` pick the rank
    whose shards :meth:`shard_leaf` cuts (default: this process's
    coordinates)."""

    def __init__(self, cfg: ArchConfig, policy: ShardingPolicy):
        from .fsdp import Zero3, active_axis
        self.mesh = policy.mesh
        self.size = self.mesh.shape.get(MODEL, 1)
        rules = policy.rules
        if rules.get("seq") is not None:
            raise _todo("sequence sharding over "
                        f"{rules['seq']!r} (sequence_parallel_rules)", "")
        if self.size > 1 and cfg.family not in TP_FAMILIES:
            raise _todo(f"{cfg.name} ({cfg.family} family)")
        if rules.get("seq_tp") not in (None, MODEL):
            raise _todo(f"seq_tp on {rules['seq_tp']!r}")
        batch = rules.get("batch")
        if MODEL in ((batch,) if isinstance(batch, str) else batch or ()):
            raise _todo("a batch split over 'model'")
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg.mla:         # one latent head, whole on every rank
            KV = H
        whole = not (H % self.size or (KV % self.size and self.size % KV))
        # Hymba splits inside its heads, as its specs cut the columns;
        # the other families (MLA's latent aside) where their heads do not
        # split whole
        self.inside = self.size > 1 and (
            cfg.family == "hybrid" or (not whole and not cfg.mla))
        # a layout inside heads expands k and v to the query heads (Hymba's
        # ring, G = 1) or keeps the kv heads its query heads read (GQA)
        self.expand = self.inside and cfg.family == "hybrid"
        if self.inside:
            if (H * hd) % self.size or (KV * hd) % self.size:
                raise _todo(f"{H * hd} query / {KV * hd} kv columns at "
                            f"model {self.size} (columns the specs do not "
                            f"split)")
        elif not whole:
            raise _todo(f"{H} query / {KV} kv heads at model {self.size} "
                        f"(heads that do not split whole)")
        self.kv_rep = (self.size // KV if self.size > KV and not self.inside
                       else 1)
        self.local_kv_heads = KV // self.size if self.kv_rep == 1 else 1
        self.hd = hd
        self.cfg = cfg
        self._index: Dict[Tuple, torch.Tensor] = {}  # block_index's
        self.seq_rule = rules.get("seq_tp") == MODEL
        self.seq = False        # this call's residual split over the seq
        self.template = _template(cfg)
        self.specs = param_pspecs(self.template, policy, fsdp=False)
        # path -> (kind, dim): kind 'model' (split on dim), 'dup' (one kv
        # head, shared by kv_rep ranks) or 'rep' (whole on every rank)
        self.plan: Dict[str, Tuple[str, Optional[int]]] = {}
        map_with_path(self._plan_leaf, self.template)
        if self.size == 1:                      # no model-axis cut
            self.plan = dict.fromkeys(self.plan, ("rep", None))
        self.vocab = self.plan["embed"][0] == "model"
        # expert parallelism: the routed experts split by whole experts
        self.experts = any(path.endswith("moe/w1") and kd == ("model", 0)
                           for path, kd in self.plan.items())
        self.zero3 = (Zero3(self.template, policy)
                      if active_axis(policy) is not None else None)
        if self.zero3 is not None:
            for path, (kind, dim) in self.zero3.plan.items():
                if kind == "dim" and self.plan[path][1] == dim:
                    raise _todo(f"{path}: the FSDP overlay on the dim the "
                                f"model axis splits", "")
        from ..train.optimizer import tree_leaves
        # each leaf's kinds in tree_leaves order (sorted dict keys)
        self.kinds = tree_leaves(map_with_path(
            lambda path, leaf, stack: self.plan[path][0], self.template))
        self.zkinds = tree_leaves(map_with_path(
            lambda path, leaf, stack: (
                "rep" if self.zero3 is None
                else self.zero3.plan[path][0]), self.template))
        self.ndim = {}
        map_with_path(lambda path, leaf, stack: self.ndim.__setitem__(
            path, leaf.ndim), self.template)

    def _plan_leaf(self, path: str, leaf, stack) -> None:
        spec = self._spec_at(path)
        for m in spec:
            if m not in (None, MODEL):
                raise _todo(f"the spec {spec} of {path} (a weight split "
                            f"over {m!r}: 2D weights are specs only)", "")
        name = path.rsplit("/", 1)[-1]
        if "/attn/" in f"/{path}" and name in _KV_LEAVES \
                and self.kv_rep > 1:
            self.plan[path] = ("dup", leaf.ndim - 1)
            return
        if MODEL in spec:
            self.plan[path] = ("model", spec.index(MODEL))
            return
        if name in _SPLIT_LEAVES and not (self.inside
                                          and name in _HEAD_LEAVES):
            raise _todo(f"{path} {tuple(leaf.shape)} unsplit at model "
                        f"{self.size}")
        self.plan[path] = ("rep", None)

    def _spec_at(self, path: str):
        node = self.specs
        for part in path.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        return node

    # -- shards ---------------------------------------------------------
    def rank(self, model_rank: Optional[int] = None) -> int:
        if model_rank is not None:
            return model_rank
        if not isinstance(self.mesh, ProcessMesh):
            raise ValueError("a shape-only mesh has no rank: pass "
                             "model_rank")
        return self.mesh.axis_index(MODEL)

    def shard_leaf(self, path: str, x: torch.Tensor,
                   model_rank: Optional[int] = None,
                   data_rank: Optional[int] = None) -> torch.Tensor:
        """This rank's block of the full leaf ``x`` at ``path``: its
        model-axis block, then its block of that over the FSDP axis."""
        kind, dim = self.plan[path]
        if kind != "rep":
            r = self.rank(model_rank)
            if kind == "dup":
                x = x.narrow(dim, (r // self.kv_rep) * self.hd, self.hd)
            else:
                n = x.shape[dim] // self.size
                x = x.narrow(dim, r * n, n)
        if self.zero3 is not None:
            x = self.zero3.shard_leaf(path, x, data_rank)
        return x

    # -- the model's collectives (a ProcessMesh) ------------------------
    def at_length(self, S: Optional[int]) -> "TensorParallel":
        """This layout for a call of S positions: sequence TP when the
        rule maps ``seq_tp`` to ``model`` and the axis divides S (JAX's
        ``shard_acts`` drops an axis that does not divide its dim)."""
        out = copy.copy(self)
        out.seq = (S is not None and self.seq_rule
                   and S % self.size == 0)
        return out

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              prefix: Optional[torch.Tensor]) -> torch.Tensor:
        """The residual stream's first value: a vocab-parallel (or plain)
        lookup, the prefix before it, split over the sequence under
        sequence TP."""
        if self.vocab:
            n = table.shape[0]
            local = tokens.long() - self.mesh.axis_index(MODEL) * n
            hit = (local >= 0) & (local < n)
            x = table[local.clamp(0, n - 1)]
            x = torch.where(hit[..., None], x, torch.zeros_like(x))
            x = reduce_from_model(x, self.mesh)
        else:
            x = table[tokens]
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return split_to_model(x, self.mesh, 1) if self.seq else x

    def norm_weight(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight applied to the residual stream (a norm's
        weight or bias, the GELU MLP's output bias): applied to a sequence
        shard, it sums its gradient over ``model``."""
        return copy_to_model(w, self.mesh) if self.seq else w

    def seq_block(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block along ``dim`` of an input that is whole on
        every rank and takes no gradient (the sinusoidal positions,
        Whisper's frames), under sequence TP."""
        return _block(x, self.mesh, dim) if self.seq else x

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """A block's input, on every rank whole."""
        return (sp_gather(h, self.mesh) if self.seq
                else copy_to_model(h, self.mesh))

    def exit(self, a: torch.Tensor) -> torch.Tensor:
        """A block's partial output summed over ``model``."""
        return (sp_scatter(a, self.mesh) if self.seq
                else reduce_from_model(a, self.mesh))

    def scatter_columns(self, a: torch.Tensor) -> torch.Tensor:
        """A partial sum [..., D] reduce-scattered over ``model`` along its
        last dim: this rank's columns of the sum (RWKV's channel-mix
        value, multiplied by this rank's columns of its receptance)."""
        return sp_scatter(a, self.mesh, a.dim() - 1)

    def gather_columns(self, y: torch.Tensor) -> torch.Tensor:
        """A block's output held as this rank's columns [B, S, D/tp],
        all-gathered into the whole output on every rank (under sequence
        TP, this rank's block of the sequence): the residual's cotangent
        is the same on every rank, so the backward keeps this rank's
        columns."""
        y = gather_from_model(y, self.mesh, y.dim() - 1)
        return split_to_model(y, self.mesh, 1) if self.seq else y

    def shared_weight(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight that feeds a model-split computation whole
        (the router, MLA's latent projection, RWKV's DDLerp, its decay
        LoRA's input projection and its channel-mix lerps): its partial
        gradients are summed over ``model``."""
        return copy_to_model(w, self.mesh)

    def replicated(self, h: torch.Tensor, local: torch.Tensor
                   ) -> torch.Tensor:
        """``h``, :meth:`enter` of ``local``, for a term that every rank of
        ``model`` computes whole and alike (the MoE load-balance loss):
        its cotangent, the same on every rank, reaches ``local`` once, not
        through :meth:`enter`'s sum over ``model``."""
        return _Replicated.apply(h.detach(), local, self.mesh, self.seq)

    def first_expert(self, n_local: int) -> int:
        """The first of this rank's ``n_local`` routed experts (0 where the
        experts are whole on every rank: unsplit, or split by their FFN
        dim)."""
        return self.mesh.axis_index(MODEL) * n_local if self.experts else 0

    def head_block(self, model_rank: Optional[int] = None) -> HeadBlock:
        """This rank's :class:`HeadBlock` (a layout that splits inside
        heads): the inner H hd columns cut in ``size`` equal blocks."""
        H, hd = self.cfg.n_heads, self.hd
        n = H * hd // self.size
        c0 = self.rank(model_rank) * n
        h0, h1 = c0 // hd, -(-(c0 + n) // hd)
        group = H // self.cfg.n_kv_heads
        return HeadBlock(c0, c0 + n, h0, h1, h0 // group,
                         (h1 - 1) // group + 1, math.gcd(hd, n), hd, group)

    def block_index(self, which: str, device) -> torch.Tensor:
        """This rank's :class:`HeadBlock` ``kv_of_heads`` or ``sub_heads``
        as an index tensor on ``device``, made once (a host-to-card copy
        a call would stall the stream), outside inference mode so that a
        later training call may save it for its backward."""
        key = (which, str(device), self.rank())
        if key not in self._index:
            with torch.inference_mode(False):
                self._index[key] = torch.tensor(
                    getattr(self.head_block(), which)(), device=device)
        return self._index[key]

    def gather_to_heads(self, *xs: torch.Tensor) -> Tuple[torch.Tensor,
                                                          ...]:
        """This rank's columns ``[B, S, n]`` of each of ``xs`` (widths that
        heads of hd cut, one dtype) -> each whole, as heads ``[B, S, width
        / hd, hd]``.  One all-gather of them all along the feature dim; its
        backward reduce-scatters, so a head two ranks compute gets the sum
        of both ranks' gradients."""
        B, S = xs[0].shape[:2]
        widths = [x.shape[-1] for x in xs]
        full = sp_gather(torch.cat(xs, -1) if len(xs) > 1 else xs[0],
                         self.mesh, -1)
        full = full.reshape(B, S, self.size, sum(widths))
        out, lo = [], 0
        for n in widths:
            out.append(full[..., lo:lo + n].reshape(
                B, S, self.size * n // self.hd, self.hd))
            lo += n
        return tuple(out)

    def gather_heads(self, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """This rank's columns of q, k and v ``[B, S, n]`` -> the query
        heads its columns touch ``[B, S, h1 - h0, hd]``, and k and v at the
        kv heads they read: expanded to one a query head (G = 1, Hymba's
        ring) or the block's kv heads [kv0, kv1) (read as
        :meth:`HeadBlock.kv_segments` says).  One all-gather of the three
        (:meth:`gather_to_heads`)."""
        blk = self.head_block()
        q, k, v = self.gather_to_heads(q, k, v)
        q = q[:, :, blk.h0:blk.h1]
        if not self.expand:
            return q, k[:, :, blk.kv0:blk.kv1], v[:, :, blk.kv0:blk.kv1]
        idx = self.block_index("kv_of_heads", q.device)
        return q, k.index_select(2, idx), v.index_select(2, idx)

    def gather_kv(self, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's columns of a cross attention's k and v -> the kv
        heads [kv0, kv1) its query heads read ``[B, Sk, kv1 - kv0, hd]``."""
        blk = self.head_block()
        k, v = self.gather_to_heads(k, v)
        return k[:, :, blk.kv0:blk.kv1], v[:, :, blk.kv0:blk.kv1]

    def touched_heads(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """This rank's columns of streams of the query width ``[B, S, n]``
        (a cross attention's q; RWKV's r, k, v and decay) -> the heads its
        columns touch ``[B, S, h1 - h0, hd]``: one all-gather a dtype (RWKV:
        r, k and v in the model's, the decay in fp32)."""
        blk, out = self.head_block(), {}
        for dt in dict.fromkeys(x.dtype for x in xs):
            idx = [i for i, x in enumerate(xs) if x.dtype == dt]
            for i, h in zip(idx, self.gather_to_heads(*(xs[i]
                                                         for i in idx))):
                out[i] = h[:, :, blk.h0:blk.h1]
        return tuple(out[i] for i in range(len(xs)))

    def keep_columns(self, out: torch.Tensor) -> torch.Tensor:
        """Attention's output over the block's heads ``[B, S, (h1 - h0)
        hd]`` -> this rank's columns [c0, c1), ready for its rows of
        ``wo``."""
        blk = self.head_block()
        return out.narrow(-1, blk.c0 - blk.h0 * self.hd, blk.c1 - blk.c0)

    def sum_partials(self, x: torch.Tensor) -> torch.Tensor:
        """A row-split product's partial sum, summed over ``model``, that
        every rank reads at its own entries (Hymba's B, C and dt at its
        sub-heads): its cotangent is summed over ``model`` too."""
        return _SumPartials.apply(x, self.mesh)

    def kv_weight(self, w: torch.Tensor) -> torch.Tensor:
        return (_SharedKV.apply(w, self.mesh, self.kv_rep)
                if self.kv_rep > 1 else w)

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm's output, ready for the (local) head."""
        if self.vocab:
            return self.enter(x)
        return gather_from_model(x, self.mesh, 1) if self.seq else x

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return (gather_from_model(logits, self.mesh, logits.dim() - 1)
                if self.vocab else logits)

    def last_position(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream's last position [B, D] on every rank: under
        sequence TP the last model rank holds it, and only each rank's
        last row is gathered."""
        if not self.seq:
            return x[:, -1]
        return gather_from_model(x[:, -1:].contiguous(), self.mesh, 1)[:, -1]

    def lse_and_target(self, logits: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vocab-parallel log-sum-exp and target logit of fp32 logits
        [B, S, V/tp]."""
        mesh, n = self.mesh, logits.shape[-1]
        m = col.all_gather(logits.detach().amax(-1)[None], mesh,
                           MODEL).amax(0)
        se = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1),
                               mesh)
        local = targets.long() - mesh.axis_index(MODEL) * n
        hit = (local >= 0) & (local < n)
        t = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        tgt = reduce_from_model(torch.where(hit, t, torch.zeros_like(t)),
                                mesh)
        return m + torch.log(se), tgt

    def sum_squares(self, tree) -> torch.Tensor:
        """Sum of squares of a tree of local shards of the parameters'
        shape (gradients), each element of the unsharded tree counted
        once: the FSDP-split leaves (by a dim or by layers) summed over
        the FSDP axis, then the model-split leaves over ``model``, a
        duplicated kv head once a head, replicated leaves once; the same
        on every rank."""
        from ..train.optimizer import tree_leaves
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.kinds):
            raise ValueError(f"{len(leaves)} leaves for a layout of "
                             f"{len(self.kinds)}")
        kinds = ("rep", "model", "dup")
        sq = {(k, z): torch.zeros((), dtype=torch.float32,
                                  device=leaves[0].device)
              for k in kinds for z in (False, True)}
        for x, kind, zk in zip(leaves, self.kinds, self.zkinds):
            key = (kind, zk != "rep")
            sq[key] = sq[key] + torch.sum(torch.square(x.float()))
        by_kind = {k: sq[(k, False)] for k in kinds}
        if self.zero3 is not None:
            z = self.zero3
            parts = col.all_gather(torch.stack(
                [sq[(k, True)] for k in kinds])[None], z.mesh, z.axis)
            summed = _ordered_sum(parts)
            by_kind = {k: by_kind[k] + summed[i]
                       for i, k in enumerate(kinds)}
        if self.size == 1:
            return by_kind["rep"]
        parts = col.all_gather(torch.stack([by_kind["model"],
                                            by_kind["dup"]])[None],
                               self.mesh, MODEL)
        return (by_kind["rep"] + _ordered_sum(parts[:, 0])
                + _ordered_sum(parts[::self.kv_rep, 1]))

    # -- sums over the unsharded leaf (Adafactor) --------------------------
    def tags(self, path: str) -> Tuple[Optional[str], ...]:
        """Per dim of the local leaf at ``path``: None, 'model' (split over
        the model axis), 'dup' (one kv head, duplicated over kv_rep ranks)
        or 'data' (split over the FSDP axis)."""
        out = [None] * self.ndim[path]
        kind, dim = self.plan[path]
        if kind != "rep":
            out[dim] = kind
        if self.zero3 is not None:
            zk, zd = self.zero3.plan[path]
            if zk == "dim":
                out[zd] = "data"
        return tuple(out)

    def stacked_tags(self, stack: str, inner: str
                     ) -> Tuple[Optional[str], ...]:
        """:meth:`tags` of a stack's leaf stacked ``[L, ...]`` (the
        layers this rank holds, where the stack is split by layers)."""
        path = f"{stack}/0/{inner}"
        lead = (self.zero3 is not None
                and self.zero3.plan[path][0] == "layers")
        return ("data" if lead else None,) + self.tags(path)

    def full_mean(self, x: torch.Tensor, tags: Tuple[Optional[str], ...],
                  dims: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """The mean over ``dims`` (default: all) of the unsharded tensor
        whose local block ``x`` is split as ``tags`` say: this rank's
        block of the result, the same bits on every rank that holds it."""
        dims = tuple(sorted(d % x.dim() for d in (
            range(x.dim()) if dims is None else dims)))
        s = x.sum(dim=dims)
        count = 1
        for d in dims:
            count *= x.shape[d] * {None: 1, "model": self.size,
                                   "dup": self.size // self.kv_rep,
                                   "data": getattr(self.zero3, "size", 1)
                                   }[tags[d]]
        split = {tags[d] for d in dims}
        if "data" in split:
            s = _ordered_sum(col.all_gather(s[None], self.zero3.mesh,
                                            self.zero3.axis))
        if "model" in split:
            s = _ordered_sum(col.all_gather(s[None], self.mesh, MODEL))
        if "dup" in split:
            s = _ordered_sum(col.all_gather(s[None], self.mesh,
                                            MODEL)[::self.kv_rep])
        return s / count


@functools.lru_cache(maxsize=32)
def _layout(cfg: ArchConfig, mesh, rules: Tuple) -> TensorParallel:
    return TensorParallel(cfg, ShardingPolicy(mesh, dict(rules)))


def layout(cfg: ArchConfig, policy: ShardingPolicy) -> TensorParallel:
    """The (cached) :class:`TensorParallel` of ``cfg`` under ``policy``."""
    return _layout(cfg, policy.mesh, tuple(sorted(policy.rules.items())))


def for_update(cfg: ArchConfig) -> Optional[TensorParallel]:
    """The layout an optimizer step under the active policy runs on:
    None where the policy shards nothing (no policy, model 1 and no FSDP
    axis above size 1)."""
    from .fsdp import active_axis
    pol = active_policy()
    if pol is None or (pol.mesh.shape.get(MODEL, 1) == 1
                       and active_axis(pol) is None):
        return None
    return layout(cfg, pol)


def for_call(cfg: ArchConfig, S: Optional[int] = None
             ) -> Optional[TensorParallel]:
    """The layout a model call of S positions runs under: None without an
    active policy or with a model axis of size 1 (the unsharded code, bit
    for bit)."""
    pol = active_policy()
    if pol is None or pol.mesh.shape.get(MODEL, 1) == 1:
        return None
    tp = layout(cfg, pol)
    if not isinstance(pol.mesh, ProcessMesh):
        raise ValueError("running under a model axis needs a ProcessMesh; "
                         "a shape-only mesh gives specs only")
    return tp.at_length(S)


# ---------------------------------------------------------------------------
# Parameters and batches
# ---------------------------------------------------------------------------

def shard_params(params: Dict, cfg: ArchConfig, policy: ShardingPolicy, *,
                 model_rank: Optional[int] = None,
                 data_rank: Optional[int] = None) -> Dict:
    """This rank's shards of the full parameter tree (views of it): the
    model-axis cut, then the FSDP overlay's (ZeRO-3)."""
    tp = layout(cfg, policy)
    return map_with_path(
        lambda path, x, stack: tp.shard_leaf(path, x, model_rank,
                                             data_rank), params)


def gather_params(local: Dict, cfg: ArchConfig,
                  policy: ShardingPolicy) -> Dict:
    """The full parameter tree from every rank's shards (collective over
    ``model`` and the FSDP axis: every rank of the mesh calls it); inverse
    of :func:`shard_params`, bit for bit."""
    tp = layout(cfg, policy)
    mesh = policy.mesh
    if tp.zero3 is not None:
        local = tp.zero3.gather_tree(local)

    def gather(path, x, stack):
        kind, dim = tp.plan[path]
        if kind == "rep":
            return x
        if kind == "model":
            return col.all_gather(x, mesh, MODEL, dim)
        heads = col.all_gather(x[None], mesh, MODEL)[::tp.kv_rep]
        return torch.cat(list(heads), dim)
    return map_with_path(gather, local)


def init_shard_params(seed: int, cfg: ArchConfig, policy: ShardingPolicy,
                      dtype=torch.float32, *, device: DeviceLike = None,
                      model_rank: Optional[int] = None,
                      data_rank: Optional[int] = None) -> Dict:
    """This rank's shards of ``lm.init_params(seed, cfg, dtype)``, bit for
    bit: ``init_params`` cuts each leaf as it draws it, so one full leaf
    is alive at a time."""
    from ..models import lm
    tp = layout(cfg, policy)

    def cut(path, leaf):
        part = tp.shard_leaf(path, leaf, model_rank, data_rank)
        return leaf if part is leaf else part.clone()   # free the full leaf
    return lm.init_params(seed, cfg, dtype, device=device, cut=cut)


def _batch_axes(policy: ShardingPolicy) -> Tuple[str, ...]:
    b = policy.rules.get("batch")
    return () if b is None else ((b,) if isinstance(b, str) else tuple(b))


def batch_split(policy: ShardingPolicy, n_rows: int) -> Tuple[int, int]:
    """(ways, this rank's index) of the batch split: 1 way when the batch
    axes do not divide ``n_rows`` (``batch_pspecs``' fall-back)."""
    axes = _batch_axes(policy)
    n = axes_size(policy.mesh, axes) if axes else 1
    if n == 1 or n_rows % n:
        return 1, 0
    mesh = policy.mesh
    idx = int(np.ravel_multi_index([mesh.axis_index(a) for a in axes],
                                   [mesh.axis_size(a) for a in axes]))
    return n, idx


def local_rows(policy: ShardingPolicy, batch: Dict) -> Dict:
    """This rank's rows of a batch dict, as ``batch_pspecs`` splits it."""
    rows = {k: v.shape[0] for k, v in batch.items() if v.dim()}
    B = next(iter(rows.values()))
    n, idx = batch_split(policy, B)
    if n == 1:
        return dict(batch)
    return {k: (v[idx * (B // n):(idx + 1) * (B // n)]
                if v.dim() and v.shape[0] == B else v)
            for k, v in batch.items()}


def gather_rows(policy: ShardingPolicy, x: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """Every rank's rows of a batch of ``n_rows`` concatenated in batch
    order (the inverse of :func:`local_rows`)."""
    n, _ = batch_split(policy, n_rows)
    if n == 1:
        return x
    for a in reversed(_batch_axes(policy)):      # minor axis first
        x = col.all_gather(x, policy.mesh, a, 0)
    return x


_ROWS = threading.local()


class _PsumAxis(torch.autograd.Function):
    """``psum`` over one axis, forward and backward (its transpose)."""
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return col.psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return col.psum(g, ctx.mesh, ctx.axis), None, None


@contextlib.contextmanager
def split_rows(policy: ShardingPolicy, n_rows: int):
    """Within the block, the model runs on this rank's rows of a global
    batch of ``n_rows`` (:func:`local_rows`): a statistic over the batch
    (the MoE load-balance loss) sums its parts over the batch axes
    (:func:`psum_rows` of :func:`rows_policy`), as the JAX package's one
    program over the global batch computes it.  The setting is this
    thread's: a layer stack reads it once, in the forward, and hands it to
    its layers (a remat recompute may run on autograd's device thread)."""
    n, _ = batch_split(policy, n_rows)
    prev = getattr(_ROWS, "policy", None)
    _ROWS.policy = policy if n > 1 else None
    try:
        yield
    finally:
        _ROWS.policy = prev


def rows_policy() -> Optional[ShardingPolicy]:
    """The policy whose batch axes split this call's rows (inside
    :func:`split_rows`), else None."""
    return getattr(_ROWS, "policy", None)


def psum_rows(x: torch.Tensor, pol: Optional[ShardingPolicy]
              ) -> torch.Tensor:
    """``x`` summed over the batch axes of ``pol`` (a
    :func:`rows_policy`; None: ``x``), its gradient summed back."""
    if pol is None:
        return x
    for a in _batch_axes(pol):
        x = _PsumAxis.apply(x, pol.mesh, a)
    return x


def mean_over_batch(policy: ShardingPolicy, x: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """The mean over the ranks that split a batch of ``n_rows``."""
    n, _ = batch_split(policy, n_rows)
    if n == 1:
        return x
    for a in _batch_axes(policy):
        x = col.psum(x, policy.mesh, a)
    return x / n


def local_bytes(params: Dict) -> int:
    """Bytes of a tree of tensors."""
    from ..train.optimizer import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


__all__ = ["TensorParallel", "HeadBlock", "layout", "for_call",
           "for_update", "shard_params",
           "gather_params", "init_shard_params", "copy_to_model",
           "reduce_from_model", "sp_gather", "sp_scatter",
           "gather_from_model", "split_to_model", "local_rows",
           "gather_rows", "mean_over_batch", "batch_split", "local_bytes",
           "split_rows", "rows_policy", "psum_rows"]
