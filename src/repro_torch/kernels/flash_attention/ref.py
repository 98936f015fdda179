"""Plain PyTorch versions of the flash attention kernel.

``flash_attention_ref`` is the port of ``repro/kernels/flash_attention/
ref.py`` (kernel layout, same signature).  ``attention_ref`` computes the
same function in model layout with runtime query positions and per-batch
valid lengths: it is what :func:`..ops.flash_attention` runs for a CPU
tensor, and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0,
                        kv_valid: Optional[int] = None) -> torch.Tensor:
    """q: [BH, G, Sq, hd]; k, v: [BH, Sk, hd] -> [BH, G, Sq, hd]."""
    BH, G, Sq, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bgqh,bkh->bgqk", q.float(), k.float()) * (hd ** -0.5)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = k_pos < (Sk if kv_valid is None else kv_valid)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgqk,bkh->bgqh", p, v.float())
    return out.to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_positions: torch.Tensor,
                  kv_valid: Union[None, int, torch.Tensor] = None, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; H = KV * G.  Query i sits
    at ``q_positions[i]``; keys at index >= ``kv_valid`` ([] or [B]) are
    masked.  Softmax in fp32 with NEG_INF masking; returns q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bqkgs", qg, k.float()) * (hd ** -0.5)
    kpos = torch.arange(Sk, device=q.device)
    qpos = q_positions.to(q.device)
    valid = torch.as_tensor(Sk if kv_valid is None else kv_valid,
                            device=q.device).to(torch.int64)
    valid = torch.broadcast_to(valid, (B,))
    mask = (kpos[None, :] < valid[:, None])[:, None, :]        # [B, 1, Sk]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
    if window is not None:
        mask = mask & (kpos[None, None, :] > qpos[None, :, None] - window)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
