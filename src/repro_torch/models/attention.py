"""Attention for the LM stack (the port's ``repro/models/attention.py``).

  * :func:`blockwise_attention` — causal / bidirectional attention with
    GQA, an optional sliding window and a valid key length (the KV cache).
    On the card (:func:`repro_torch.kernels._card.on_card`: a CUDA tensor,
    or a dry run's ``meta`` one) it calls the hand-written flash kernel
    (:mod:`repro_torch.kernels.flash_attention`); on a CPU tensor it runs
    the blockwise online-softmax formulation of the JAX package, block for
    block, so the CPU path is held against JAX in the tests.
  * :func:`ring_cache_attention` — decode over a sliding-window ring
    cache, masked by the position stored in each slot (the JAX
    formulation; the CPU path), and :func:`ring_decode_attention`, its card
    formulation: flash over the first ``min(pos + 1, Wc)`` slots with no
    causal or window mask.
  * :func:`dense_attention` — the unchunked oracle.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels._card import on_card
from ..kernels.flash_attention import ops as fa_ops
from ..kernels.flash_attention.ref import NEG_INF, attention_ref

ValidLen = Union[None, int, torch.Tensor]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        kv_valid_len: ValidLen = None, *,
                        causal: bool = True, window: Optional[int] = None,
                        kv_block: int = 512,
                        unroll: bool = False) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; GQA via H = KV * G.

    q_positions: [Sq] global positions of the queries (decode passes [pos]).
    kv_valid_len: [] or [B] — keys at index >= valid_len are masked (cache).
    ``unroll`` is accepted for the JAX signature and has no effect.
    """
    if on_card(q):
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      kv_valid=kv_valid_len,
                                      q_positions=q_positions)
    if q.device.type != "cpu":
        raise ValueError(f"blockwise_attention: unsupported device "
                         f"{q.device}")
    fa_ops.PLAIN_CALLS["flash_attention"] += 1
    return _blockwise_plain(q, k, v, q_positions, kv_valid_len,
                            causal=causal, window=window, kv_block=kv_block)


def _blockwise_plain(q, k, v, q_positions, kv_valid_len, *, causal, window,
                     kv_block):
    """The JAX package's blockwise online softmax over kv blocks (keys
    padded with zeros to a whole number of blocks)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    nb = -(-Sk // kv_block)
    pad = nb * kv_block - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, Sq, KV, G, hd).float()
    valid = torch.as_tensor(Sk if kv_valid_len is None else kv_valid_len)
    valid = torch.broadcast_to(valid.to(torch.int64), (B,))
    qpos = q_positions.to(torch.int64)

    m = torch.full((B, Sq, KV, G), NEG_INF)
    l = torch.zeros((B, Sq, KV, G))
    acc = torch.zeros((B, Sq, KV, G, hd))
    for j in range(nb):
        kj = k[:, j * kv_block:(j + 1) * kv_block].float()
        vj = v[:, j * kv_block:(j + 1) * kv_block].float()
        kpos = j * kv_block + torch.arange(kv_block)
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, kj) * scale
        mask = (kpos[None, :] < valid[:, None])[:, None, :]     # [B, 1, C]
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
        if window is not None:
            mask = mask & (kpos[None, None, :] > qpos[None, :, None] - window)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p,
                                                   vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def ring_cache_attention(q: torch.Tensor, k_ring: torch.Tensor,
                         v_ring: torch.Tensor, kpos: torch.Tensor,
                         q_positions: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Attention over a sliding-window RING cache in plain PyTorch.

    q: [B, Sq, H, hd]; k_ring, v_ring: [B, Wc, KV, hd]; kpos: [Wc] int —
    the absolute position stored in each slot (-1 = empty); q_positions:
    [Sq].  Causal and window masking is by position, so slot order does not
    matter.
    """
    B, Sq, H, hd = q.shape
    Wc, KV = k_ring.shape[1], k_ring.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, k_ring.float()) * hd ** -0.5
    kp, qp = kpos.to(torch.int64)[None, :], q_positions.to(torch.int64)
    mask = (kp >= 0) & (kp <= qp[:, None])                       # [Sq, Wc]
    if window is not None:
        mask = mask & (kp > qp[:, None] - window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckh->bqkgh", p, v_ring.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step at position ``pos`` over a ring of ``Wc`` slots that
    a prefill and the decode steps before this one filled in order, ``Wc``
    at most the window.  The ring then holds exactly the positions
    ``(pos - Wc, pos]`` that exist, in slots ``[0, min(pos + 1, Wc))``, and
    all of them are inside the window and causal: so this equals
    :func:`ring_cache_attention` with no mask but the valid slot count.
    On a CUDA tensor one flash launch (the ``split_kv`` route)."""
    n = min(int(pos) + 1, k_ring.shape[1])
    return fa_ops.flash_attention(q, k_ring, v_ring, causal=False,
                                  kv_valid=n)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor,
                    kv_valid_len: ValidLen = None, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Unchunked oracle (small shapes / tests only)."""
    return attention_ref(q, k, v, q_positions, kv_valid_len, causal=causal,
                         window=window)
