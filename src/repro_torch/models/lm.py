"""The LM of the port (``repro/models/lm.py``), all of the JAX package's
families:

  family   mixer                       ffn
  ------   -----                       ---
  dense    GQA attention (+rope)       swiglu       qwen2, granite, llama3
  vlm      GQA attention               swiglu       patch-embedding prefix
  moe      GQA or MLA attention        MoE (+dense leading layers)
  ssm      RWKV6 time-mix              RWKV6 channel-mix (attn-free)
  hybrid   parallel GQA + SSM heads    swiglu       hymba (sliding window)
  encdec   bidirectional enc + causal dec w/ cross-attn, gelu mlp   whisper

Parameters are a dict: ``embed``, ``group<i>`` (a list of per-layer dicts,
one per layer of the stack, applied in a Python loop: no scan),
the final norm (plus ``in_norm`` for RWKV, ``encoder`` and ``enc_norm``
for enc-dec) and ``lm_head`` when the embedding is not tied.  Weights are
``[d_in, d_out]`` and used as ``x @ W``, as the JAX package lays them out,
so :mod:`.convert` carries JAX parameters over without a transpose.

Sharding: where the JAX package calls its activation-sharding hints
(``shard_acts``, ``sp_gather``, ``sp_scatter``), the port runs the explicit
tensor-parallel collectives of :mod:`repro_torch.distributed.tensor_parallel`
when a policy with a model axis larger than 1 is active
(:func:`repro_torch.distributed.sharding.use_policy`): the parameters are
then this rank's shards (``tensor_parallel.shard_params``), head counts
come from the weights' widths, a cache holds the local kv heads, and the
batch is this rank's rows.  Where the heads do not split whole they split
inside, as the specs cut the columns (``TensorParallel.inside``): q, k and
v are gathered to the heads a rank's columns touch, attention runs over
the kv heads those read (:func:`_attend`), the cache holds those kv heads,
and the rank's columns of the output meet its rows of ``wo``.
:func:`forward`, :func:`prefill` and
:func:`decode_step` return logits gathered over the model axis (the same
on every rank); :func:`lm_loss` runs a vocab-parallel cross-entropy.  The
dense family, the VLM's dense trunk, the MoE family (expert parallelism,
MLA's head split), RWKV (its heads split, the channel-mix product on
reduced columns: :mod:`.rwkv`) and the enc-dec family (the encoder's and
both attentions' heads split, the cross cache of this rank's heads, the
GELU MLP's output bias added after the sum) and Hymba (its attention and
SSM split inside heads as its specs cut the columns: q, k and v gathered
along the feature dim, the SSM in sub-heads of this rank's columns,
:mod:`.ssm`) run so.

ZeRO-3: where the policy's FSDP axis (``'data'``) splits the parameters
(:mod:`repro_torch.distributed.fsdp`, every family), each layer gathers
its split leaves inside its own (checkpointed) function, so a remat
recompute gathers them again and no gathered weight outlives its layer;
a leaf split by whole layers is gathered once a stack; the embedding, the
head and the top-level norms are gathered at each use.  Their gradients
come back reduce-scattered over the axis.  With no policy, or a policy
that splits nothing, every function is the unsharded code.

Frontends are stubs, as in the JAX package (:mod:`.frontends`): a VLM
takes ``prefix_embeds [B, n_front, D]`` prepended to the token embeddings
(positions count the prefix), an enc-dec model ``enc_frames [B, S_enc,
D]`` for its encoder.  Hymba's attention keeps a ring cache of
``min(max_seq, window)`` slots: a prefill attends over its own windowed
sequence and writes the last keys into the ring, a decode step reads the
ring (:func:`.attention.ring_cache_attention` on the CPU,
:func:`.attention.ring_decode_attention` on the card).

Caches are updated in place (the dense KV and MLA latent caches are
written with a slice assignment, the ring with ``index_copy_``; RWKV and
SSM states and the enc-dec cross keys are replaced in the cache dict), so
a cache passed to :func:`prefill` or :func:`decode_step` is the one
returned.  :func:`forward` returns the MoE load-balance loss summed over
layers; :func:`prefill` and :func:`decode_step` do not compute it (the
JAX package discards it there).

Training: :func:`lm_loss` is the next-token cross-entropy of the JAX
package.  ``forward(remat=True)`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant: a layer's activations are
recomputed in the backward pass, and on the card its kernels launch again);
``remat_blocks=n`` adds the JAX package's second level, a checkpoint around
each block of ``L / n`` layers.  ``scan_layers`` and ``unroll_scans`` are
accepted for the JAX signature and have no effect: the layers already run
in a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed import fsdp
from ..distributed import tensor_parallel as tpl
from ..distributed.meshes import DeviceLike, resolve_device
from ..distributed.sharding import map_with_path
from ..kernels._card import on_card
from .attention import (blockwise_attention, ring_cache_attention,
                        ring_decode_attention)
from .layers import (apply_rope, dense_init, embed_init, gelu_mlp,
                     layer_norm, rms_norm, sinusoidal_at,
                     sinusoidal_positions, swiglu)
from .mla import init_mla_cache, init_mla_params, mla_attention
from .moe import aux_load_balance_loss, init_moe_params, moe_ffn
from .rwkv import (cmix_forward, init_cmix_params, init_tmix_params,
                   init_tmix_state, tmix_forward)
from .ssm import init_ssm_params, init_ssm_state, ssm_forward

Positions = Union[int, torch.Tensor]

# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str          # attn_mlp | attn_moe | rwkv | hymba | enc | dec
    count: int


def layer_groups(cfg: ArchConfig) -> List[LayerGroup]:
    """Homogeneous layer stacks of the decoder trunk (the enc-dec encoder
    is the separate ``encoder`` stack)."""
    if cfg.family in ("dense", "vlm"):
        return [LayerGroup("attn_mlp", cfg.n_layers)]
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        groups = [LayerGroup("attn_mlp", fd)] if fd else []
        return groups + [LayerGroup("attn_moe", cfg.n_layers - fd)]
    if cfg.family == "ssm":
        return [LayerGroup("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [LayerGroup("hymba", cfg.n_layers)]
    if cfg.family == "encdec":
        return [LayerGroup("dec", cfg.n_layers)]
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Attention sub-module (GQA, optional bias/rope; self or cross)
# ---------------------------------------------------------------------------

# A cut ``put(name, leaf) -> leaf`` is applied to each leaf as it is drawn
# (``init_params(cut=)``: a rank keeps its shard before the next leaf is
# drawn); ``_under`` gives the cut of a sub-dict's leaves.
Cut = Callable[[str, torch.Tensor], torch.Tensor]


def _keep(name: str, leaf: torch.Tensor) -> torch.Tensor:
    return leaf


def _under(put: Cut, at: str) -> Cut:
    return _keep if put is _keep else (
        lambda name, leaf: put(f"{at}/{name}", leaf))


def _cut_all(put: Cut, tree, at: str = ""):
    """``put`` applied to every leaf of a drawn tree (path from ``at``)."""
    if put is _keep:
        return tree
    return map_with_path(lambda path, leaf, _: put(path, leaf), tree, at)


def init_attn_params(gen, cfg: ArchConfig, dtype, device,
                     put: Cut = _keep) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    p = {name: put(name, dense_init(gen, *shape, dtype, device))
         for name, shape in shapes.items()}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = put(name, torch.zeros((n,), dtype=dtype,
                                            device=device))
    return p


def _qkv(p: Dict, cfg: ArchConfig, xq: torch.Tensor, xkv: torch.Tensor,
         tp: Optional[tpl.TensorParallel] = None,
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    hd = cfg.head_dim
    H, KV = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd   # local heads
    kvw = (lambda w: w) if tp is None else tp.kv_weight
    q = xq @ p["wq"]
    k = xkv @ kvw(p["wk"])
    v = xkv @ kvw(p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + kvw(p["bk"]), v + kvw(p["bv"])
    if tp is not None and tp.inside:      # this rank's columns -> its heads
        return tp.gather_heads(q, k, v)
    B, Sq = xq.shape[:2]
    Sk = xkv.shape[1]
    return (q.reshape(B, Sq, H, hd), k.reshape(B, Sk, KV, hd),
            v.reshape(B, Sk, KV, hd))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, tp: Optional[tpl.TensorParallel],
            **kw) -> torch.Tensor:
    """``blockwise_attention`` of q over k and v; where heads split inside
    without the kv expansion, one call a GQA segment of the block
    (:meth:`~repro_torch.distributed.tensor_parallel.HeadBlock.
    kv_segments`), the outputs in head order."""
    if tp is None or not tp.inside or tp.expand:
        return blockwise_attention(q, k, v, positions, **kw)
    segs = tp.head_block().kv_segments()
    outs = [blockwise_attention(q[:, :, q0:q1], k[:, :, k0:k1],
                                v[:, :, k0:k1], positions, **kw)
            for q0, q1, k0, k1 in segs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 2)


def attn_forward(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 rope: bool = True, window: Optional[int] = None,
                 cache: Optional[Dict] = None,
                 cache_index: Optional[int] = None,
                 tp: Optional[tpl.TensorParallel] = None,
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention with optional RoPE and KV cache.  A dense cache:
    prefill writes ``[cache_index, cache_index + S)``, decode reads the
    valid prefix.  A ring cache (``kpos`` in it): the last ``Wc`` keys go
    to slots ``position % Wc``; a prefill (S > 1) attends over its own
    windowed sequence, a decode step over the ring.  Under ``tp`` the
    weights, heads and cache are this rank's and the output is its
    partial sum (where heads split inside, the output's columns this rank
    holds times its rows of ``wo``)."""
    B, S, D = x.shape
    q, k, v = _qkv(p, cfg, x, x, tp)
    wo = ((lambda o: o.reshape(B, S, -1) @ p["wo"])
          if tp is None or not tp.inside else
          (lambda o: tp.keep_columns(o.reshape(B, S, -1)) @ p["wo"]))
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    valid = None
    if cache is not None and "kpos" in cache:
        Wc = cache["k"].shape[1]
        # only the last Wc keys can matter; one write a slot
        kw, vw, pw = k[:, -Wc:], v[:, -Wc:], positions[-Wc:]
        slot = pw % Wc
        cache["k"].index_copy_(1, slot, kw.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, vw.to(cache["v"].dtype))
        cache["kpos"].index_copy_(0, slot, pw.to(cache["kpos"].dtype))
        if S > 1:
            out = blockwise_attention(q, k, v, positions, causal=causal,
                                      window=window)
        elif on_card(x):
            out = ring_decode_attention(q, cache["k"], cache["v"],
                                        cache_index)
        else:
            out = ring_cache_attention(q, cache["k"], cache["v"],
                                       cache["kpos"], positions,
                                       window=window)
        return wo(out), cache
    if cache is not None:
        i = int(cache_index)
        cache["k"][:, i:i + S] = k.to(cache["k"].dtype)
        cache["v"][:, i:i + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        valid = i + S
    out = _attend(q, k, v, positions, tp, kv_valid_len=valid,
                  causal=causal, window=window,
                  kv_block=min(512, max(k.shape[1], 1)))
    return wo(out), cache


def cross_attn_forward(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                       kv_cache: Dict,
                       tp: Optional[tpl.TensorParallel] = None
                       ) -> torch.Tensor:
    """Cross-attention reading precomputed (k, v) of the encoder output:
    bidirectional, every query at position 0.  The heads are the weights'
    (under a model axis this rank's, the output its partial sum; where
    heads split inside, q gathered to the heads this rank's columns touch,
    the cache at the kv heads they read, and the output's columns this
    rank holds times its rows of ``wo``)."""
    B, S, D = x.shape
    hd = cfg.head_dim
    H = p["wq"].shape[1] // hd
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    inside = tp is not None and tp.inside
    q = tp.touched_heads(q)[0] if inside else q.reshape(B, S, H, hd)
    zeros = torch.zeros((S,), dtype=torch.int64, device=x.device)
    out = _attend(q, kv_cache["k"], kv_cache["v"], zeros, tp,
                  causal=False).reshape(B, S, -1)
    return (tp.keep_columns(out) if inside else out) @ p["wo"]


def encode_cross_kv(p: Dict, cfg: ArchConfig, enc_out: torch.Tensor,
                    tp: Optional[tpl.TensorParallel] = None) -> Dict:
    """The cross keys and values of the encoder output, of the weights'
    kv heads (under a model axis this rank's: ``enc_out`` is whole on
    every rank; where heads split inside, the kv heads this rank's query
    heads read, gathered from every rank's columns)."""
    B, Sk = enc_out.shape[:2]
    hd = cfg.head_dim
    KV = p["wk"].shape[1] // hd
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if tp is not None and tp.inside:
        k, v = tp.gather_kv(k, v)
        return {"k": k, "v": v}
    return {"k": k.reshape(B, Sk, KV, hd), "v": v.reshape(B, Sk, KV, hd)}


# ---------------------------------------------------------------------------
# Per-kind layer parameters and application
# ---------------------------------------------------------------------------

def _init_mlp(gen, cfg: ArchConfig, dtype, device,
              put: Cut = _keep) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    shapes = {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
    return {name: put(name, dense_init(gen, *shape, dtype, device))
            for name, shape in shapes.items()}


def _init_gelu_mlp(gen, cfg: ArchConfig, dtype, device) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, d, ff, dtype, device),
            "b1": torch.zeros((ff,), dtype=dtype, device=device),
            "w2": dense_init(gen, ff, d, dtype, device),
            "b2": torch.zeros((d,), dtype=dtype, device=device)}


def _ln(d: int, dtype, device) -> Dict:
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def init_layer_params(gen, kind: str, cfg: ArchConfig, dtype,
                      device, put: Cut = _keep) -> Dict:
    """One layer's parameters; ``put`` cuts each leaf of a dense block as
    it is drawn, and the other kinds' leaves once the layer is drawn."""
    d = cfg.d_model
    if put is not _keep and (kind != "attn_mlp" or cfg.mla):
        return _cut_all(put, init_layer_params(gen, kind, cfg, dtype,
                                               device))
    if kind in ("attn_mlp", "attn_moe"):
        p = {"ln1": put("ln1", torch.ones((d,), dtype=dtype, device=device)),
             "attn": (init_mla_params(gen, cfg, dtype, device) if cfg.mla
                      else init_attn_params(gen, cfg, dtype, device,
                                            _under(put, "attn"))),
             "ln2": put("ln2", torch.ones((d,), dtype=dtype, device=device))}
        if kind == "attn_mlp":
            p["mlp"] = _init_mlp(gen, cfg, dtype, device, _under(put, "mlp"))
        else:
            p["moe"] = init_moe_params(gen, cfg, dtype, device)
        return p
    if kind == "rwkv":
        return {"ln1": _ln(d, dtype, device),
                "tmix": init_tmix_params(gen, cfg, dtype, device),
                "ln2": _ln(d, dtype, device),
                "cmix": init_cmix_params(gen, cfg, dtype, device)}
    ones = lambda: torch.ones((d,), dtype=dtype, device=device)
    if kind == "hymba":
        return {"ln1": ones(),
                "attn": init_attn_params(gen, cfg, dtype, device),
                "ssm": init_ssm_params(gen, cfg, dtype, device),
                "bn_a": ones(), "bn_s": ones(),   # per-branch output norms
                "ln2": ones(),
                "mlp": _init_mlp(gen, cfg, dtype, device)}
    if kind == "enc":
        return {"ln1": _ln(d, dtype, device),
                "attn": init_attn_params(gen, cfg, dtype, device),
                "ln2": _ln(d, dtype, device),
                "mlp": _init_gelu_mlp(gen, cfg, dtype, device)}
    if kind == "dec":
        return {"ln1": _ln(d, dtype, device),
                "attn": init_attn_params(gen, cfg, dtype, device),
                "ln2": _ln(d, dtype, device),
                "xattn": init_attn_params(gen, cfg, dtype, device),
                "ln3": _ln(d, dtype, device),
                "mlp": _init_gelu_mlp(gen, cfg, dtype, device)}
    raise ValueError(f"unknown layer kind {kind!r}")


def _norm(x: torch.Tensor, w, eps: float,
          tp: Optional[tpl.TensorParallel]) -> torch.Tensor:
    """RMS norm of a weight, or layer norm of a ``{"w", "b"}`` dict (RWKV,
    enc-dec); under sequence TP the weights sum their gradients over
    ``model``."""
    nw = (lambda t: t) if tp is None else tp.norm_weight
    if isinstance(w, dict):
        return layer_norm(x, nw(w["w"]), nw(w["b"]), eps)
    return rms_norm(x, nw(w), eps)


def _block_input(x: torch.Tensor, w, eps: float,
                 tp: Optional[tpl.TensorParallel]) -> torch.Tensor:
    h = _norm(x, w, eps, tp)
    return h if tp is None else tp.enter(h)


def _block_output(a: torch.Tensor,
                  tp: Optional[tpl.TensorParallel]) -> torch.Tensor:
    return a if tp is None else tp.exit(a)


def apply_layer(kind: str, p: Dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Optional[Dict] = None,
                cache_index: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None,
                mixer_chunk: int = 64, dense_moe: bool = False,
                moe_groups: int = 1, with_aux: bool = True,
                tp: Optional[tpl.TensorParallel] = None, rows=None,
                ) -> Tuple[torch.Tensor, Optional[Dict],
                           Optional[torch.Tensor]]:
    """One block. Returns (x, new_cache, moe_aux_loss): the aux loss is
    None for a layer without MoE, or when ``with_aux`` is false.  Under
    ``tp`` (attention, MLA, MLP and MoE blocks) each block's input is made
    whole on every rank and its partial output summed over the model axis
    (the JAX package's ``sp_gather`` / ``sp_scatter`` points).  ``rows``:
    the policy whose batch axes split the rows
    (``tensor_parallel.rows_policy``), over which the MoE load-balance
    statistics are summed."""
    eps = cfg.norm_eps
    if kind in ("attn_mlp", "attn_moe"):
        h = _block_input(x, p["ln1"], eps, tp)
        if cfg.mla:
            a, cache = mla_attention(p["attn"], cfg, h, positions,
                                     cache=cache, cache_index=cache_index,
                                     tp=tp)
        else:
            a, cache = attn_forward(p["attn"], cfg, h, positions,
                                    cache=cache, cache_index=cache_index,
                                    window=cfg.sliding_window, tp=tp)
        x = x + _block_output(a, tp)
        if kind == "attn_mlp":
            h = _block_input(x, p["ln2"], eps, tp)
            return x + _block_output(swiglu(h, **p["mlp"]), tp), cache, None
        hn = _norm(x, p["ln2"], eps, tp)
        h = hn if tp is None else tp.enter(hn)
        # the balance loss is whole and alike on every rank of 'model': its
        # gradient reaches the block input once (tp.replicated)
        hb = h if tp is None else tp.replicated(h, hn)
        aux = (aux_load_balance_loss(p["moe"]["router"],
                                     hb.reshape(-1, hb.shape[-1]),
                                     cfg.moe.top_k, rows)
               if with_aux else None)
        x = x + _block_output(moe_ffn(p["moe"], cfg.moe, h,
                                      dense_dispatch=dense_moe,
                                      n_groups=moe_groups, tp=tp), tp)
        return x, cache, aux
    if kind == "rwkv":
        # under sequence TP the block input is gathered after its norm, so
        # the token shift and the scan see whole rows
        h = _block_input(x, p["ln1"], eps, tp)
        t_state = cache["tmix"] if cache is not None else None
        a, t_new = tmix_forward(p["tmix"], cfg, h, t_state,
                                chunk=mixer_chunk, tp=tp)
        x = x + _block_output(a, tp)
        h = _block_input(x, p["ln2"], eps, tp)
        c_prev = cache["cmix_shift"] if cache is not None else None
        c, c_shift = cmix_forward(p["cmix"], h, c_prev, tp=tp)
        x = x + c                   # whole (or this rank's block) already
        if cache is not None:
            cache["tmix"], cache["cmix_shift"] = t_new, c_shift
        return x, cache, None
    if kind == "hymba":
        # each branch's partial output is summed over the model axis
        # before its norm reads it (under sequence TP, this rank's block)
        h = _block_input(x, p["ln1"], eps, tp)
        a, _ = attn_forward(p["attn"], cfg, h, positions,
                            cache=cache["attn"] if cache is not None
                            else None,
                            cache_index=cache_index,
                            window=cfg.sliding_window, tp=tp)
        s, s_new = ssm_forward(p["ssm"], cfg, h,
                               cache["ssm"] if cache is not None else None,
                               chunk=mixer_chunk, tp=tp)
        a = _norm(_block_output(a, tp), p["bn_a"], eps, tp)
        s = _norm(_block_output(s, tp), p["bn_s"], eps, tp)
        x = x + 0.5 * (a + s)
        h = _block_input(x, p["ln2"], eps, tp)
        x = x + _block_output(swiglu(h, **p["mlp"]), tp)
        if cache is not None:
            cache["ssm"] = s_new
        return x, cache, None
    if kind == "enc":
        h = _block_input(x, p["ln1"], eps, tp)
        a, _ = attn_forward(p["attn"], cfg, h, positions, causal=False,
                            rope=False, tp=tp)
        x = x + _block_output(a, tp)
        h = _block_input(x, p["ln2"], eps, tp)
        return x + gelu_mlp(h, **p["mlp"], tp=tp), None, None
    if kind == "dec":
        h = _block_input(x, p["ln1"], eps, tp)
        a, _ = attn_forward(p["attn"], cfg, h, positions, rope=False,
                            cache=cache["self"] if cache is not None
                            else None,
                            cache_index=cache_index, tp=tp)
        x = x + _block_output(a, tp)
        h = _block_input(x, p["ln2"], eps, tp)
        # enc_out is whole on every rank (encode's last step)
        xkv = (cache["cross"] if cache is not None
               else encode_cross_kv(p["xattn"], cfg, enc_out, tp))
        x = x + _block_output(cross_attn_forward(p["xattn"], cfg, h, xkv,
                                                 tp), tp)
        h = _block_input(x, p["ln3"], eps, tp)
        return x + gelu_mlp(h, **p["mlp"], tp=tp), cache, None
    raise ValueError(f"unknown layer kind {kind!r}")


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ArchConfig, dtype=torch.float32, *,
                device: DeviceLike = None, cut: Optional[Cut] = None) -> Dict:
    """Model parameters drawn from ``seed`` with a :class:`torch.Generator`
    on ``device`` (default: the CUDA card; raises without one).  The
    distributions are the JAX package's; the numbers are not (use
    :func:`.convert.params_from_jax` for the JAX package's weights).  On the
    ``meta`` device: shapes only.  ``cut(path, leaf)`` replaces each leaf
    (path as :func:`~repro_torch.distributed.sharding.map_with_path`
    names it) as soon as it is drawn, before the next draw: a rank keeps
    its shard of a model no card holds (``tensor_parallel.
    init_shard_params``) with one full leaf alive at a time (a dense
    block's; the other kinds hold one layer)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    put = cut or _keep
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": put("embed", embed_init(gen, cfg.vocab_size, d, dtype, dev))}
    for gi, g in enumerate(layer_groups(cfg)):
        p[f"group{gi}"] = [init_layer_params(gen, g.kind, cfg, dtype, dev,
                                             _under(put, f"group{gi}/{j}"))
                           for j in range(g.count)]
    if cfg.family == "encdec":
        p["encoder"] = [init_layer_params(gen, "enc", cfg, dtype, dev,
                                          _under(put, f"encoder/{j}"))
                        for j in range(cfg.encoder_layers)]
        p["enc_norm"] = _ln(d, dtype, dev)
        p["final_norm"] = _ln(d, dtype, dev)
    elif cfg.family == "ssm":
        p["in_norm"] = _ln(d, dtype, dev)                 # RWKV ln0
        p["final_norm"] = _ln(d, dtype, dev)
    else:
        p["final_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    for name in ("enc_norm", "in_norm", "final_norm"):     # no draws
        if name in p:
            p[name] = _cut_all(put, p[name], name)
    if not cfg.tie_embeddings:
        p["lm_head"] = put("lm_head",
                           dense_init(gen, d, cfg.vocab_size, dtype, dev))
    return p


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in leaves(item)]


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count from a shape-only (``meta``) init;
    ``active_only`` leaves out the routed experts a token does not reach
    (n_routed - top_k a MoE layer)."""
    total = sum(t.numel() for t in leaves(init_params(0, cfg,
                                                       device="meta")))
    if active_only and cfg.moe:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        n_moe_layers = cfg.n_layers - m.first_dense_layers
        total -= n_moe_layers * (m.n_routed - m.top_k) * per_expert
    return total


def count_embedding_params(cfg: ArchConfig) -> int:
    """The embedding's parameters, and the head's where it is not tied."""
    n = cfg.vocab_size * cfg.d_model
    return n if cfg.tie_embeddings else 2 * n


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def _top(params: Dict, name: str, z: Optional[fsdp.Zero3]):
    """The top-level entry ``name`` of ``params``, its split leaves
    gathered under ZeRO-3."""
    return params[name] if z is None else z.tree(name, params[name])


def encode(params: Dict, cfg: ArchConfig, enc_frames: torch.Tensor, *,
           remat: bool = False, remat_blocks: int = 1) -> torch.Tensor:
    """Whisper encoder: frame embeddings [B, S_enc, D] -> enc_out.  The
    frames are cast to the weights' dtype first (JAX would promote the
    weights instead; the same where the dtypes agree).  Under a model
    axis the frames are whole on every rank (under sequence TP the
    encoder's residual is split over the frames, as the decoder's over
    its tokens), and so is ``enc_out``: every decoder layer's cross keys
    read it at this rank's heads, and its gradient is summed over the
    axis once."""
    z = fsdp.for_call(cfg)
    x = enc_frames.to(params["embed"].dtype)
    Senc = x.shape[1]
    tp = tpl.for_call(cfg, Senc)
    x = x + sinusoidal_positions(Senc, cfg.d_model, x.device).to(x.dtype)
    if tp is not None:
        x = tp.seq_block(x, 1)
    pos = torch.arange(Senc, device=x.device)
    x, _ = _apply_stack(params["encoder"], "enc", cfg, x, pos,
                        remat=remat, remat_blocks=remat_blocks, tp=tp,
                        name="encoder", z=z)
    x = _norm(x, _top(params, "enc_norm", z), cfg.norm_eps, tp)
    return x if tp is None else tp.enter(x)


def _apply_stack(layers: List[Dict], kind: str, cfg: ArchConfig,
                 x: torch.Tensor, positions: torch.Tensor, *,
                 caches: Optional[List[Dict]] = None,
                 cache_index: Optional[int] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 mixer_chunk: int = 64, dense_moe: bool = False,
                 moe_groups: int = 1, with_aux: bool = False,
                 remat: bool = False, remat_blocks: int = 1,
                 tp: Optional[tpl.TensorParallel] = None,
                 name: str = "", z: Optional[fsdp.Zero3] = None,
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One homogeneous stack of layers: (x, the MoE aux loss summed over
    its layers, or None).  ``remat`` checkpoints each layer (no cache);
    with ``remat_blocks`` > 1 dividing the layer count, each block of
    layers is checkpointed around its checkpointed layers, the JAX
    package's two-level remat (``lm.py``'s outer scan over layer blocks).
    Under ZeRO-3 (``z``) the stack is ``params[name]``: each layer gathers
    its split leaves inside its function."""
    blocks = None if z is None else z.stack_blocks(name, layers)
    rows = tpl.rows_policy()        # read here: a recompute runs elsewhere

    def layer(li: int, x: torch.Tensor):
        p = layers[li] if z is None else z.layer(name, li, layers[li],
                                                 blocks)
        x, _, a = apply_layer(kind, p, cfg, x, positions,
                              cache=caches[li] if caches else None,
                              cache_index=cache_index, enc_out=enc_out,
                              mixer_chunk=mixer_chunk, dense_moe=dense_moe,
                              moe_groups=moe_groups, with_aux=with_aux,
                              tp=tp, rows=rows)
        return x, a

    def run(lis, x):
        aux = None
        for li in lis:
            x, a = (checkpoint(layer, li, x, use_reentrant=False) if remat
                    else layer(li, x))
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    n = len(layers)
    if remat and caches:
        raise ValueError("remat runs without a cache (training forward)")
    if not (remat and remat_blocks > 1 and n % remat_blocks == 0):
        return run(range(n), x)
    inner, aux = n // remat_blocks, None
    for blk in range(remat_blocks):
        x, a = checkpoint(run, range(blk * inner, (blk + 1) * inner), x,
                          use_reentrant=False)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _trunk(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], cache: Optional[Dict],
           cache_index: Optional[int], mixer_chunk: int, *,
           prefix_embeds: Optional[torch.Tensor] = None,
           enc_out: Optional[torch.Tensor] = None,
           dense_moe: bool = False, moe_groups: int = 1,
           with_aux: bool = False, remat: bool = False,
           remat_blocks: int = 1, tp: Optional[tpl.TensorParallel] = None,
           z: Optional[fsdp.Zero3] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding (after the prefix, if any), every layer and the final
    norm: [B, S] -> ([B, n_front + S, D], the MoE aux loss summed over
    layers, 0 unless ``with_aux``).  Under sequence TP the output is this
    rank's block of the sequence."""
    embed = _top(params, "embed", z)
    if tp is None:
        x = embed[tokens]
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    else:
        x = tp.embed(embed, tokens, prefix_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    S = tokens.shape[1] + (0 if prefix_embeds is None
                           else prefix_embeds.shape[1])
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.family == "ssm":
        x = _norm(x, _top(params, "in_norm", z), cfg.norm_eps, tp)
    if cfg.family == "encdec":
        pe = sinusoidal_at(positions, cfg.d_model).to(x.dtype)
        x = x + (pe if tp is None else tp.seq_block(pe))
    for gi, g in enumerate(layer_groups(cfg)):
        x, a = _apply_stack(params[f"group{gi}"], g.kind, cfg, x, positions,
                            caches=(cache[f"group{gi}"] if cache is not None
                                    else None),
                            cache_index=cache_index, enc_out=enc_out,
                            mixer_chunk=mixer_chunk, dense_moe=dense_moe,
                            moe_groups=moe_groups, with_aux=with_aux,
                            remat=remat, remat_blocks=remat_blocks, tp=tp,
                            name=f"group{gi}", z=z)
        if a is not None:
            aux = aux + a
    return _norm(x, _top(params, "final_norm", z), cfg.norm_eps, tp), aux


def _head(params: Dict, cfg: ArchConfig, x: torch.Tensor,
          logits_f32: bool = False,
          tp: Optional[tpl.TensorParallel] = None,
          z: Optional[fsdp.Zero3] = None) -> torch.Tensor:
    """Logits of the final norm's output; under ``tp`` this rank's block of
    the vocabulary (column-parallel head) when the vocabulary is split.
    Under ZeRO-3 the head gathers its weight (a tied embedding's second
    gather)."""
    head = (_top(params, "embed", z).T if cfg.tie_embeddings
            else _top(params, "lm_head", z))
    if tp is not None:
        x = tp.head_input(x)
    if logits_f32:
        return x.float() @ head.float()
    return x @ head


def _need_frames(cfg: ArchConfig, enc_frames) -> None:
    if cfg.family == "encdec" and enc_frames is None:
        raise ValueError(f"{cfg.name}: an enc-dec model needs enc_frames "
                         f"[B, S_enc, D] for its encoder")


def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, cache_index: Optional[int] = None,
            scan_layers: bool = True, remat: bool = False,
            mixer_chunk: int = 64, dense_moe: bool = False,
            logits_f32: bool = False, unroll_scans: bool = False,
            remat_blocks: int = 1, moe_groups: int = 1,
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Full forward. tokens: [B, S_text].

    prefix_embeds (vlm): [B, n_front, D] prepended before the token stream.
    enc_frames (encdec): [B, S_enc, D] stub frontend output (without a
    cache; with one, the decoder reads the cross keys prefill stored).
    ``remat`` / ``remat_blocks``: see the module docstring (no cache);
    ``scan_layers`` and ``unroll_scans`` have no effect.
    Returns (logits [B, n_front + S_text, V], cache, MoE aux loss summed
    over layers: 0 for a model without MoE)."""
    tp = tpl.for_call(cfg, tokens.shape[1] + (
        0 if prefix_embeds is None else prefix_embeds.shape[1]))
    logits, cache, aux = _forward(
        params, cfg, tokens, prefix_embeds=prefix_embeds,
        enc_frames=enc_frames, positions=positions, cache=cache,
        cache_index=cache_index, remat=remat, mixer_chunk=mixer_chunk,
        dense_moe=dense_moe, logits_f32=logits_f32,
        remat_blocks=remat_blocks, moe_groups=moe_groups, tp=tp)
    return (logits if tp is None else tp.gather_logits(logits)), cache, aux


def _forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor, *,
             prefix_embeds, enc_frames, positions, cache, cache_index,
             remat: bool, mixer_chunk: int, dense_moe: bool,
             logits_f32: bool, remat_blocks: int, moe_groups: int,
             tp: Optional[tpl.TensorParallel],
             ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """:func:`forward` with this rank's block of the vocabulary under
    ``tp``."""
    enc_out, z = None, fsdp.for_call(cfg)
    if cfg.family == "encdec" and cache is None:
        _need_frames(cfg, enc_frames)
        enc_out = encode(params, cfg, enc_frames, remat=remat,
                         remat_blocks=remat_blocks)
    x, aux = _trunk(params, cfg, tokens, positions, cache, cache_index,
                    mixer_chunk, prefix_embeds=prefix_embeds,
                    enc_out=enc_out, dense_moe=dense_moe,
                    moe_groups=moe_groups, with_aux=True, remat=remat,
                    remat_blocks=remat_blocks, tp=tp, z=z)
    return _head(params, cfg, x, logits_f32, tp, z), cache, aux


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def lm_loss(params: Dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, aux_coef: float = 0.01, scan_layers: bool = True,
            remat: bool = False, dense_moe: bool = False,
            mixer_chunk: int = 64, unroll_scans: bool = False,
            remat_blocks: int = 1, moe_groups: int = 1,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in fp32 over the text positions (a VLM's
    prefix positions carry no loss), weighted by ``loss_mask``, plus
    ``aux_coef`` times the MoE load-balance loss.  batch: tokens [B, S],
    targets [B, S], loss_mask [B, S] (+ prefix_embeds / enc_frames per
    family).  Returns (loss, {"ce_loss", "moe_aux"}).  Under a model axis
    the cross-entropy is vocab-parallel (the logits are never gathered)."""
    tokens, prefix = batch["tokens"], batch.get("prefix_embeds")
    tp = tpl.for_call(cfg, tokens.shape[1] + (
        0 if prefix is None else prefix.shape[1]))
    logits, _, aux = _forward(
        params, cfg, tokens, prefix_embeds=prefix,
        enc_frames=batch.get("enc_frames"), positions=None, cache=None,
        cache_index=None, remat=remat, mixer_chunk=mixer_chunk,
        dense_moe=dense_moe, logits_f32=False, remat_blocks=remat_blocks,
        moe_groups=moe_groups, tp=tp)
    targets = batch["targets"]
    npad = logits.shape[1] - targets.shape[1]
    if npad:                                   # vlm prefix positions: no loss
        logits = logits[:, npad:]
    logits = logits.float()
    if tp is not None and tp.vocab:
        lse, tgt = tp.lse_and_target(logits, targets)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - tgt
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_coef * aux, {"ce_loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Caches: init / prefill / decode
# ---------------------------------------------------------------------------

def _init_layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                      dtype, device,
                      tp: Optional[tpl.TensorParallel] = None) -> Dict:
    KV = cfg.n_kv_heads if tp is None else tp.local_kv_heads
    if tp is not None and tp.inside:
        # the kv heads the query heads of this rank's columns read; Hymba's
        # ring holds k and v expanded to those query heads (G = 1, as its
        # attention reads them): one flash launch a decode step
        blk = tp.head_block()
        KV = blk.n_heads if tp.expand else blk.kv1 - blk.kv0
    hd = cfg.head_dim
    kv = lambda n: {"k": torch.zeros((batch, n, KV, hd), dtype=dtype,
                                     device=device),
                    "v": torch.zeros((batch, n, KV, hd), dtype=dtype,
                                     device=device)}
    if kind in ("attn_mlp", "attn_moe"):
        if cfg.mla:
            return init_mla_cache(cfg, batch, max_seq, dtype, device)
        return kv(max_seq)
    if kind == "rwkv":
        return {"tmix": init_tmix_state(cfg, batch, dtype, device, tp),
                "cmix_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                          device=device)}
    if kind == "hymba":
        Wc = min(max_seq, cfg.sliding_window or max_seq)
        ring = kv(Wc)
        ring["kpos"] = torch.full((Wc,), -1, dtype=torch.int32,
                                  device=device)
        return {"attn": ring, "ssm": init_ssm_state(cfg, batch, dtype,
                                                    device, tp)}
    if kind == "dec":
        return {"self": kv(max_seq), "cross": kv(cfg.encoder_seq)}
    raise ValueError(f"unknown layer kind {kind!r}")


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, *,
               device: DeviceLike = None) -> Dict:
    """Per-layer decode caches, ``group<i>``: a list with one per layer
    (under a model axis, of this rank's kv heads)."""
    dev = resolve_device(device)
    tp = tpl.for_call(cfg)
    return {f"group{gi}": [_init_layer_cache(g.kind, cfg, batch, max_seq,
                                             dtype, dev, tp)
                           for _ in range(g.count)]
            for gi, g in enumerate(layer_groups(cfg))}


def prefill(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            cache: Dict, *, prefix_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            mixer_chunk: int = 64, dense_moe: bool = False,
            moe_groups: int = 1) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (after the prefix, if any) through the model, filling
    the cache; for enc-dec, encode the frames once and store every decoder
    layer's cross keys.  Returns (last-position logits [B, V], cache); the
    head runs on the last position only."""
    z = fsdp.for_call(cfg)
    if cfg.family == "encdec":
        _need_frames(cfg, enc_frames)
        enc_out = encode(params, cfg, enc_frames)
        dec = params["group0"]
        blocks = None if z is None else z.stack_blocks("group0", dec)
        for li, layer_c in enumerate(cache["group0"]):
            p = dec[li] if z is None else z.layer("group0", li, dec[li],
                                                  blocks)
            layer_c["cross"] = encode_cross_kv(p["xattn"], cfg, enc_out,
                                               tpl.for_call(cfg))
    n_front = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    S = tokens.shape[1] + n_front
    positions = torch.arange(S, device=tokens.device)
    tp = tpl.for_call(cfg, S)
    x, _ = _trunk(params, cfg, tokens, positions, cache, 0, mixer_chunk,
                  prefix_embeds=prefix_embeds, dense_moe=dense_moe,
                  moe_groups=moe_groups, tp=tp, z=z)
    if tp is None:
        return _head(params, cfg, x[:, -1], z=z), cache
    return tp.gather_logits(_head(params, cfg, tp.last_position(x),
                                  tp=tp.at_length(None), z=z)), cache


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict, pos: Positions, *, dense_moe: bool = False,
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token: [B]; pos: the current position (an int or a
    0-d tensor; counts a VLM's prefix).  Returns (logits [B, V], cache)."""
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=token.device)
    tp, z = tpl.for_call(cfg, 1), fsdp.for_call(cfg)
    x, _ = _trunk(params, cfg, token[:, None], positions, cache, pos,
                  mixer_chunk=1, dense_moe=dense_moe, tp=tp, z=z)
    logits = _head(params, cfg, x[:, 0], tp=tp, z=z)
    return (logits if tp is None else tp.gather_logits(logits)), cache
