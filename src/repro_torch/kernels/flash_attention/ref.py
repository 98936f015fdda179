"""Plain PyTorch versions of the flash attention kernel.

``flash_attention_ref`` is the port of ``repro/kernels/flash_attention/
ref.py`` (kernel layout, same signature).  ``attention_ref`` computes the
same function in model layout with runtime query positions and per-batch
valid lengths: it is what :func:`..ops.flash_attention` runs for a CPU
tensor, and what the CUDA kernels are held against on the card.
``attention_split_ref`` computes it the way the split-kv decode kernel
does (per-chunk partials, then a merge in chunk order); the card holds the
decode kernel against it too.  ``attention_backward_ref`` is autograd
through ``attention_ref``: the plain version of the backward kernel.
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


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        kv_valid: Union[None, int, torch.Tensor] = None, *,
                        chunk: int, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """:func:`attention_ref`'s function, computed as the split-kv kernel
    computes it.  The keys of batch row b that any query can see form the
    range [lo_b, hi_b) (widened to [0, Sk) when some query sees none: its
    weights are then uniform over all Sk keys).  Chunk c, keys
    [c * chunk, (c + 1) * chunk) of that range, gives each row a partial
    m_c (max score, NEG_INF with no key), l_c = sum exp(s - m_c) and
    acc_c = sum exp(s - m_c) v; masked keys in range score NEG_INF, keys
    outside it do not count.  The merge, in chunk order:
    out = sum_c e_c acc_c / max(sum_c e_c l_c, 1e-30), e_c = exp(m_c - M),
    M = max_c m_c."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bqkgs", qg, k.float()) * (hd ** -0.5)
    valid = torch.as_tensor(Sk if kv_valid is None else kv_valid,
                            device=q.device).to(torch.int64)
    valid = torch.broadcast_to(valid.clamp(0, Sk), (B,))
    # each (batch, query)'s visible keys [lo, hi)
    pos = q_positions.to(q.device, torch.int64)[None, :]         # [1, Sq]
    hi = torch.broadcast_to(valid[:, None], (B, Sq))
    if causal:
        hi = torch.minimum(hi, pos + 1)
    lo = torch.broadcast_to(torch.clamp(pos - window + 1, min=0)
                            if window is not None else torch.zeros_like(pos),
                            (B, Sq))
    kpos = torch.arange(Sk, device=q.device)
    visible = (kpos >= lo[..., None]) & (kpos < hi[..., None])  # [B, Sq, Sk]
    seen = hi > lo
    empty = (~seen).any(dim=1)                                   # [B]
    big = torch.iinfo(torch.int64).max
    b_lo = torch.where(seen, lo, big).amin(dim=1)
    b_hi = torch.where(seen, hi, -1).amax(dim=1)
    b_lo = torch.where(empty, 0, b_lo)
    b_hi = torch.where(empty, Sk, b_hi)
    in_range = (kpos >= b_lo[:, None]) & (kpos < b_hi[:, None])  # [B, Sk]
    s = torch.where(visible[:, :, None, None, :], s, NEG_INF)
    vf = v.float()
    ms, ls, accs = [], [], []
    for c0 in range(0, max(Sk, 1), chunk):
        take = in_range.clone()
        take[:, :c0] = False
        take[:, c0 + chunk:] = False
        sc = torch.where(take[:, None, None, None, :], s, -torch.inf)
        m = torch.clamp(sc.amax(dim=-1), min=NEG_INF)
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bqkgs,bskh->bqkgh", p, vf))
    M = torch.stack(ms).amax(dim=0)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(ls[0])
    for m, l, acc in zip(ms, ls, accs):
        e = torch.exp(m - M)
        den = den + e * l
        num = num + e[..., None] * acc
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor,
                           q_positions: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None):
    """(dq, dk, dv) of :func:`attention_ref` (every key valid) for the
    gradient ``dout`` of its output: autograd through the plain version, on
    the inputs' device.  What the backward kernel is held against."""
    with torch.enable_grad():
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = attention_ref(qq, kk, vv, q_positions, None, causal=causal,
                            window=window)
        return torch.autograd.grad(out, (qq, kk, vv), dout)
