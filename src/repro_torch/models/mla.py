"""Multi-head Latent Attention (DeepSeek-V2), cache-compressed decode: the
port's ``repro/models/mla.py``.

MLA projects keys and values through a shared low-rank latent c_kv of
width ``kv_lora_rank`` (plus a small decoupled RoPE key of width
``rope_head_dim``).  Only (c_kv, k_rope) is cached: kv_lora + rope_dim
numbers a token a layer instead of 2 * H * hd (576 against 4096 for
deepseek-v2-lite).

Attention runs in the latent space, with the per-head up-projections
absorbed into the query and output sides:

  score_t = (q_nope W_uk^T) . c_kv_t   +   q_rope . k_rope_t
  out     = (sum_t p_t c_kv_t) W_uv

so it is one attention with a single kv head of width kv_lora + rope_dim
(576) shared by every query head, whose values are its keys.  On a CUDA
tensor :func:`.attention.blockwise_attention` launches the flash kernel at
that width; the output keeps its first kv_lora columns.

The cache is one ``[B, Smax, kv_lora + rope_dim]`` tensor, ``latent``;
``c_kv`` and ``k_rope`` are views of its two column ranges (the JAX
package's two cache entries), so attention reads the cache in place as
both keys and values, with no concatenation a step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .attention import blockwise_attention
from .layers import apply_rope, dense_init, rms_norm


def init_mla_params(gen, cfg: ArchConfig, dtype, device) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = H * (m.nope_head_dim + m.rope_head_dim)
    return {
        # query (direct projection; v2-lite has no q LoRA)
        "wq": dense_init(gen, d, qd, dtype, device),
        # joint KV down-projection: [D, kv_lora + rope_dim]
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.rope_head_dim,
                            dtype, device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        # up-projections out of the latent
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.nope_head_dim, dtype,
                           device),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype,
                           device),
        "wo": dense_init(gen, H * m.v_head_dim, d, dtype, device),
    }


def _project_q(p: Dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> q_nope [B,S,H,nope], q_rope [B,S,H,rope] (rope applied)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, H, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> c_kv [B,S,R] (normed latent), k_rope [B,S,1,rope] (shared head)."""
    m = cfg.mla
    c_kv, k_rope = (x @ p["w_dkv"]).split([m.kv_lora_rank, m.rope_head_dim],
                                          dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def mla_attention(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache: Optional[Dict] = None,
                  cache_index: Optional[int] = None,
                  unroll: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA block.  x: [B, S, D].

    cache (decode): :func:`init_mla_cache`'s dict, written in place at
    ``[cache_index, cache_index + S)``; keys at and after
    ``cache_index + S`` are masked.  Returns (out [B,S,D], cache).
    ``unroll`` is accepted for the JAX signature and has no effect.
    """
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    R = m.kv_lora_rank
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c_new, kr_new = _project_kv_latent(p, cfg, x, positions)

    if cache is None:
        latent = torch.cat([c_new, kr_new[:, :, 0]], dim=-1)
        valid = None
    else:
        i = int(cache_index)
        cache["c_kv"][:, i:i + S] = c_new.to(cache["c_kv"].dtype)
        cache["k_rope"][:, i:i + S] = kr_new[:, :, 0].to(
            cache["k_rope"].dtype)
        latent = cache["latent"]
        valid = i + S

    # ---- absorbed attention in latent space --------------------------------
    w_uk = p["w_uk"].reshape(R, H, m.nope_head_dim)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    q_full = torch.cat([q_abs, q_rope], dim=-1)              # [B,S,H,R+rope]
    kv = latent[:, :, None, :]                               # [B,Sk,1,R+rope]
    # scale by the *materialized* head dim, per the paper: the factor is
    # rounded to the model dtype before the product, as the JAX package's
    # weakly typed Python scalar is
    scale_fix = ((m.nope_head_dim + m.rope_head_dim) ** -0.5
                 / (q_full.shape[-1] ** -0.5))
    attn_lat = blockwise_attention(
        q_full * torch.tensor(scale_fix, dtype=q_full.dtype), kv, kv,
        positions, kv_valid_len=valid, causal=True,
        kv_block=min(512, max(kv.shape[1], 1)))
    attn_lat = attn_lat[..., :R]                             # [B,S,H,R]
    w_uv = p["w_uv"].reshape(R, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", attn_lat, w_uv)
    return out.reshape(B, S, H * m.v_head_dim) @ p["wo"], cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                   device) -> Dict:
    """``latent`` [B, Smax, R + rope] and its views ``c_kv`` [B, Smax, R]
    and ``k_rope`` [B, Smax, rope]."""
    m = cfg.mla
    latent = torch.zeros((batch, max_seq, m.kv_lora_rank + m.rope_head_dim),
                         dtype=dtype, device=device)
    return {"latent": latent, "c_kv": latent[..., :m.kv_lora_rank],
            "k_rope": latent[..., m.kv_lora_rank:]}


def mla_cache_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    """The MLA memory win, per token per layer (vs 2*H*hd for vanilla MHA)."""
    m = cfg.mla
    return (m.kv_lora_rank + m.rope_head_dim) * dtype_bytes
