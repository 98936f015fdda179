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
one per layer of the stack, applied in a Python loop: no scan, no remat),
the final norm (plus ``in_norm`` for RWKV, ``encoder`` and ``enc_norm``
for enc-dec) and ``lm_head`` when the embedding is not tied.  Weights are
``[d_in, d_out]`` and used as ``x @ W``, as the JAX package lays them out,
so :mod:`.convert` carries JAX parameters over without a transpose.

The JAX package's activation-sharding hints (``shard_acts``, ``sp_gather``,
``sp_scatter``) are identities without a sharding policy and are dropped;
sharding comes with the port's distributed layer.

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..configs.base import ArchConfig
from ..distributed.meshes import DeviceLike, resolve_device
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

def init_attn_params(gen, cfg: ArchConfig, dtype, device) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, H * hd, dtype, device),
        "wk": dense_init(gen, d, KV * hd, dtype, device),
        "wv": dense_init(gen, d, KV * hd, dtype, device),
        "wo": dense_init(gen, H * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _qkv(p: Dict, cfg: ArchConfig, xq: torch.Tensor, xkv: torch.Tensor,
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, Sq = xq.shape[:2]
    Sk = xkv.shape[1]
    return (q.reshape(B, Sq, H, hd), k.reshape(B, Sk, KV, hd),
            v.reshape(B, Sk, KV, hd))


def attn_forward(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 rope: bool = True, window: Optional[int] = None,
                 cache: Optional[Dict] = None,
                 cache_index: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention with optional RoPE and KV cache.  A dense cache:
    prefill writes ``[cache_index, cache_index + S)``, decode reads the
    valid prefix.  A ring cache (``kpos`` in it): the last ``Wc`` keys go
    to slots ``position % Wc``; a prefill (S > 1) attends over its own
    windowed sequence, a decode step over the ring."""
    B, S, D = x.shape
    q, k, v = _qkv(p, cfg, x, x)
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
        elif x.device.type == "cuda":
            out = ring_decode_attention(q, cache["k"], cache["v"],
                                        cache_index)
        else:
            out = ring_cache_attention(q, cache["k"], cache["v"],
                                       cache["kpos"], positions,
                                       window=window)
        return out.reshape(B, S, -1) @ p["wo"], cache
    if cache is not None:
        i = int(cache_index)
        cache["k"][:, i:i + S] = k.to(cache["k"].dtype)
        cache["v"][:, i:i + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        valid = i + S
    out = blockwise_attention(q, k, v, positions, kv_valid_len=valid,
                              causal=causal, window=window,
                              kv_block=min(512, max(k.shape[1], 1)))
    return out.reshape(B, S, -1) @ p["wo"], cache


def cross_attn_forward(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                       kv_cache: Dict) -> torch.Tensor:
    """Cross-attention reading precomputed (k, v) of the encoder output:
    bidirectional, every query at position 0."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    zeros = torch.zeros((S,), dtype=torch.int64, device=x.device)
    out = blockwise_attention(q.reshape(B, S, H, hd), kv_cache["k"],
                              kv_cache["v"], zeros, causal=False)
    return out.reshape(B, S, -1) @ p["wo"]


def encode_cross_kv(p: Dict, cfg: ArchConfig, enc_out: torch.Tensor) -> Dict:
    B, Sk = enc_out.shape[:2]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": k.reshape(B, Sk, KV, hd), "v": v.reshape(B, Sk, KV, hd)}


# ---------------------------------------------------------------------------
# Per-kind layer parameters and application
# ---------------------------------------------------------------------------

def _init_mlp(gen, cfg: ArchConfig, dtype, device) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, d, ff, dtype, device),
            "w3": dense_init(gen, d, ff, dtype, device),
            "w2": dense_init(gen, ff, d, dtype, device)}


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
                      device) -> Dict:
    d = cfg.d_model
    if kind in ("attn_mlp", "attn_moe"):
        p = {"ln1": torch.ones((d,), dtype=dtype, device=device),
             "attn": (init_mla_params(gen, cfg, dtype, device) if cfg.mla
                      else init_attn_params(gen, cfg, dtype, device)),
             "ln2": torch.ones((d,), dtype=dtype, device=device)}
        if kind == "attn_mlp":
            p["mlp"] = _init_mlp(gen, cfg, dtype, device)
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


def apply_layer(kind: str, p: Dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, cache: Optional[Dict] = None,
                cache_index: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None,
                mixer_chunk: int = 64, dense_moe: bool = False,
                moe_groups: int = 1, with_aux: bool = True,
                ) -> Tuple[torch.Tensor, Optional[Dict],
                           Optional[torch.Tensor]]:
    """One block. Returns (x, new_cache, moe_aux_loss): the aux loss is
    None for a layer without MoE, or when ``with_aux`` is false."""
    eps = cfg.norm_eps
    if kind in ("attn_mlp", "attn_moe"):
        h = rms_norm(x, p["ln1"], eps)
        if cfg.mla:
            a, cache = mla_attention(p["attn"], cfg, h, positions,
                                     cache=cache, cache_index=cache_index)
        else:
            a, cache = attn_forward(p["attn"], cfg, h, positions,
                                    cache=cache, cache_index=cache_index,
                                    window=cfg.sliding_window)
        x = x + a
        h = rms_norm(x, p["ln2"], eps)
        if kind == "attn_mlp":
            return x + swiglu(h, **p["mlp"]), cache, None
        aux = (aux_load_balance_loss(p["moe"]["router"],
                                     h.reshape(-1, h.shape[-1]),
                                     cfg.moe.top_k) if with_aux else None)
        x = x + moe_ffn(p["moe"], cfg.moe, h, dense_dispatch=dense_moe,
                        n_groups=moe_groups)
        return x, cache, aux
    if kind == "rwkv":
        h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"], eps)
        t_state = cache["tmix"] if cache is not None else None
        a, t_new = tmix_forward(p["tmix"], cfg, h, t_state,
                                chunk=mixer_chunk)
        x = x + a
        h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"], eps)
        c_prev = cache["cmix_shift"] if cache is not None else None
        c, c_shift = cmix_forward(p["cmix"], h, c_prev)
        x = x + c
        if cache is not None:
            cache["tmix"], cache["cmix_shift"] = t_new, c_shift
        return x, cache, None
    if kind == "hymba":
        h = rms_norm(x, p["ln1"], eps)
        a, _ = attn_forward(p["attn"], cfg, h, positions,
                            cache=cache["attn"] if cache is not None
                            else None,
                            cache_index=cache_index,
                            window=cfg.sliding_window)
        s, s_new = ssm_forward(p["ssm"], cfg, h,
                               cache["ssm"] if cache is not None else None,
                               chunk=mixer_chunk)
        a = rms_norm(a, p["bn_a"], eps)
        s = rms_norm(s, p["bn_s"], eps)
        x = x + 0.5 * (a + s)
        h = rms_norm(x, p["ln2"], eps)
        x = x + swiglu(h, **p["mlp"])
        if cache is not None:
            cache["ssm"] = s_new
        return x, cache, None
    if kind == "enc":
        h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"], eps)
        a, _ = attn_forward(p["attn"], cfg, h, positions, causal=False,
                            rope=False)
        x = x + a
        h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"], eps)
        return x + gelu_mlp(h, **p["mlp"]), None, None
    if kind == "dec":
        h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"], eps)
        a, _ = attn_forward(p["attn"], cfg, h, positions, rope=False,
                            cache=cache["self"] if cache is not None
                            else None,
                            cache_index=cache_index)
        x = x + a
        h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"], eps)
        xkv = (cache["cross"] if cache is not None
               else encode_cross_kv(p["xattn"], cfg, enc_out))
        x = x + cross_attn_forward(p["xattn"], cfg, h, xkv)
        h = layer_norm(x, p["ln3"]["w"], p["ln3"]["b"], eps)
        return x + gelu_mlp(h, **p["mlp"]), cache, None
    raise ValueError(f"unknown layer kind {kind!r}")


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ArchConfig, dtype=torch.float32, *,
                device: DeviceLike = None) -> Dict:
    """Model parameters drawn from ``seed`` with a :class:`torch.Generator`
    on ``device`` (default: the CUDA card; raises without one).  The
    distributions are the JAX package's; the numbers are not (use
    :func:`.convert.params_from_jax` for the JAX package's weights).  On the
    ``meta`` device: shapes only."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype, dev)}
    for gi, g in enumerate(layer_groups(cfg)):
        p[f"group{gi}"] = [init_layer_params(gen, g.kind, cfg, dtype, dev)
                           for _ in range(g.count)]
    if cfg.family == "encdec":
        p["encoder"] = [init_layer_params(gen, "enc", cfg, dtype, dev)
                        for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = _ln(d, dtype, dev)
        p["final_norm"] = _ln(d, dtype, dev)
    elif cfg.family == "ssm":
        p["in_norm"] = _ln(d, dtype, dev)                 # RWKV ln0
        p["final_norm"] = _ln(d, dtype, dev)
    else:
        p["final_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype, dev)
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


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def encode(params: Dict, cfg: ArchConfig,
           enc_frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder: frame embeddings [B, S_enc, D] -> enc_out.  The
    frames are cast to the weights' dtype first (JAX would promote the
    weights instead; the same where the dtypes agree)."""
    x = enc_frames.to(params["embed"].dtype)
    Senc = x.shape[1]
    x = x + sinusoidal_positions(Senc, cfg.d_model, x.device).to(x.dtype)
    pos = torch.arange(Senc, device=x.device)
    for layer_p in params["encoder"]:
        x, _, _ = apply_layer("enc", layer_p, cfg, x, pos)
    return layer_norm(x, params["enc_norm"]["w"], params["enc_norm"]["b"],
                      cfg.norm_eps)


def _trunk(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], cache: Optional[Dict],
           cache_index: Optional[int], mixer_chunk: int, *,
           prefix_embeds: Optional[torch.Tensor] = None,
           enc_out: Optional[torch.Tensor] = None,
           dense_moe: bool = False, moe_groups: int = 1,
           with_aux: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding (after the prefix, if any), every layer and the final
    norm: [B, S] -> ([B, n_front + S, D], the MoE aux loss summed over
    layers, 0 unless ``with_aux``)."""
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.family == "ssm":
        x = layer_norm(x, params["in_norm"]["w"], params["in_norm"]["b"],
                       cfg.norm_eps)
    if cfg.family == "encdec":
        x = x + sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    for gi, g in enumerate(layer_groups(cfg)):
        layers = params[f"group{gi}"]
        caches = cache[f"group{gi}"] if cache is not None else None
        for li, layer_p in enumerate(layers):
            x, _, a = apply_layer(g.kind, layer_p, cfg, x, positions,
                                  cache=caches[li] if caches else None,
                                  cache_index=cache_index, enc_out=enc_out,
                                  mixer_chunk=mixer_chunk,
                                  dense_moe=dense_moe, moe_groups=moe_groups,
                                  with_aux=with_aux)
            if a is not None:
                aux = aux + a
    fn = params["final_norm"]
    if isinstance(fn, dict):
        return layer_norm(x, fn["w"], fn["b"], cfg.norm_eps), aux
    return rms_norm(x, fn, cfg.norm_eps), aux


def _head(params: Dict, cfg: ArchConfig, x: torch.Tensor,
          logits_f32: bool = False) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
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
            mixer_chunk: int = 64, dense_moe: bool = False,
            logits_f32: bool = False, moe_groups: int = 1,
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Full forward. tokens: [B, S_text].

    prefix_embeds (vlm): [B, n_front, D] prepended before the token stream.
    enc_frames (encdec): [B, S_enc, D] stub frontend output (without a
    cache; with one, the decoder reads the cross keys prefill stored).
    Returns (logits [B, n_front + S_text, V], cache, MoE aux loss summed
    over layers: 0 for a model without MoE)."""
    enc_out = None
    if cfg.family == "encdec" and cache is None:
        _need_frames(cfg, enc_frames)
        enc_out = encode(params, cfg, enc_frames)
    x, aux = _trunk(params, cfg, tokens, positions, cache, cache_index,
                    mixer_chunk, prefix_embeds=prefix_embeds,
                    enc_out=enc_out, dense_moe=dense_moe,
                    moe_groups=moe_groups, with_aux=True)
    return _head(params, cfg, x, logits_f32), cache, aux


# ---------------------------------------------------------------------------
# Caches: init / prefill / decode
# ---------------------------------------------------------------------------

def _init_layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                      dtype, device) -> Dict:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    kv = lambda n: {"k": torch.zeros((batch, n, KV, hd), dtype=dtype,
                                     device=device),
                    "v": torch.zeros((batch, n, KV, hd), dtype=dtype,
                                     device=device)}
    if kind in ("attn_mlp", "attn_moe"):
        if cfg.mla:
            return init_mla_cache(cfg, batch, max_seq, dtype, device)
        return kv(max_seq)
    if kind == "rwkv":
        return {"tmix": init_tmix_state(cfg, batch, dtype, device),
                "cmix_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                          device=device)}
    if kind == "hymba":
        Wc = min(max_seq, cfg.sliding_window or max_seq)
        ring = kv(Wc)
        ring["kpos"] = torch.full((Wc,), -1, dtype=torch.int32,
                                  device=device)
        return {"attn": ring, "ssm": init_ssm_state(cfg, batch, dtype,
                                                    device)}
    if kind == "dec":
        return {"self": kv(max_seq), "cross": kv(cfg.encoder_seq)}
    raise ValueError(f"unknown layer kind {kind!r}")


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype, *,
               device: DeviceLike = None) -> Dict:
    """Per-layer decode caches, ``group<i>``: a list with one per layer."""
    dev = resolve_device(device)
    return {f"group{gi}": [_init_layer_cache(g.kind, cfg, batch, max_seq,
                                             dtype, dev)
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
    if cfg.family == "encdec":
        _need_frames(cfg, enc_frames)
        enc_out = encode(params, cfg, enc_frames)
        for layer_p, layer_c in zip(params["group0"], cache["group0"]):
            layer_c["cross"] = encode_cross_kv(layer_p["xattn"], cfg, enc_out)
    n_front = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    positions = torch.arange(tokens.shape[1] + n_front, device=tokens.device)
    x, _ = _trunk(params, cfg, tokens, positions, cache, 0, mixer_chunk,
                  prefix_embeds=prefix_embeds, dense_moe=dense_moe,
                  moe_groups=moe_groups)
    return _head(params, cfg, x[:, -1]), cache


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict, pos: Positions, *, dense_moe: bool = False,
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token: [B]; pos: the current position (an int or a
    0-d tensor; counts a VLM's prefix).  Returns (logits [B, V], cache)."""
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=token.device)
    x, _ = _trunk(params, cfg, token[:, None], positions, cache, pos,
                  mixer_chunk=1, dense_moe=dense_moe)
    return _head(params, cfg, x[:, 0]), cache
