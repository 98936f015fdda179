"""Gated linear recurrence in plain PyTorch (the port's
``repro/models/linrec.py``): the oracles of the WKV kernel on the CPU.

Per head,

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{Nk x Nv}

with out_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T) in mode 'rwkv' and
out_t = q_t^T S_t in mode 'inclusive'.  :func:`chunked_linear_recurrence`
is the JAX package's chunked form, chunk for chunk (pairwise decays
exp(A_i - A_j) <= 0 inside a chunk, the state carried exactly across
chunks); :func:`recurrent_step` the one-token form; and
:func:`naive_linear_recurrence` the step-by-step ground truth.  All math in
fp32; inputs cast in, outputs cast back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pad_to(x: torch.Tensor, S: int) -> torch.Tensor:
    """Zero-pad axis 1 of [B, S, h, N] to length S."""
    pad = S - x.shape[1]
    return x if pad == 0 else torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))


def chunked_linear_recurrence(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, log_w: torch.Tensor,
                              u: Optional[torch.Tensor] = None,
                              initial_state: Optional[torch.Tensor] = None,
                              *, mode: str = "rwkv", chunk: int = 64,
                              return_state: bool = False,
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """q, k, log_w: [B, S, h, Nk]; v: [B, S, h, Nv]; u: [h, Nk] (rwkv mode).

    log_w must be <= 0 (log of a decay in (0, 1]).
    initial_state: [B, h, Nk, Nv].  Returns (out [B, S, h, Nv], final_state
    or None).
    """
    if mode not in ("rwkv", "inclusive"):
        raise ValueError(mode)
    B, S, h, Nk = q.shape
    Nv = v.shape[-1]
    dt = q.dtype
    C = min(chunk, S)
    nc = -(-S // C)
    Sp = nc * C
    f32 = torch.float32
    q_, k_, v_, w_ = (_pad_to(x.to(f32), Sp) for x in (q, k, v, log_w))

    def to_chunks(x):                           # [nc, B, C, h, N]
        return x.reshape(B, nc, C, h, x.shape[-1]).transpose(0, 1)
    qc, kc, vc, wc = map(to_chunks, (q_, k_, v_, w_))

    state = (torch.zeros((B, h, Nk, Nv), dtype=f32, device=q.device)
             if initial_state is None else initial_state.to(f32))
    ones = torch.ones((C, C), dtype=torch.bool, device=q.device)
    tri = torch.tril(ones, diagonal=-1 if mode == "rwkv" else 0)
    eye = torch.eye(C, dtype=f32, device=q.device)
    outs = []
    for c in range(nc):
        qb, kb, vb, wb = qc[c], kc[c], vc[c], wc[c]          # [B, C, h, *]
        A = torch.cumsum(wb, dim=1)                           # log decays
        A_total = A[:, -1]                                    # [B, h, Nk]
        A_q = A - wb if mode == "rwkv" else A                 # A_{t-1} / A_t
        # inter-chunk: q_t dressed with exp(A_q) reads the carried state
        out_inter = torch.einsum("bchk,bhkv->bchv", qb * torch.exp(A_q),
                                 state)
        # intra-chunk: pairwise exponents A_q[t] - A[s] (<= 0 on tri)
        expo = A_q[:, :, None] - A[:, None, :, :, :]          # [B,C,C,h,Nk]
        expo = torch.where(tri[None, :, :, None, None], expo, -torch.inf)
        M = torch.einsum("bthk,bshk,btshk->btsh", qb, kb, torch.exp(expo))
        if mode == "rwkv" and u is not None:
            diag = torch.einsum("bthk,hk,bthk->bth", qb, u.to(f32), kb)
            M = M + diag[:, :, None, :] * eye[None, :, :, None]
        out_intra = torch.einsum("btsh,bshv->bthv", M, vb)
        # state update: S' = diag(e^{A_total}) S + sum_s k_s e^{A_tot-A_s} v_s
        k_dress = kb * torch.exp(A_total[:, None] - A)
        state = (state * torch.exp(A_total)[..., None]
                 + torch.einsum("bchk,bchv->bhkv", k_dress, vb))
        outs.append(out_inter + out_intra)
    out = torch.stack(outs, 1).reshape(B, Sp, h, Nv)[:, :S]
    return out.to(dt), (state if return_state else None)


def recurrent_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, state: torch.Tensor,
                   u: Optional[torch.Tensor] = None, *, mode: str = "rwkv",
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token step.  q, k, log_w: [B, h, Nk]; v: [B, h, Nv];
    state: [B, h, Nk, Nv].  Returns (out [B, h, Nv], new_state)."""
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(log_w.to(f32))                                # [B, h, Nk]
    kv = kf[..., :, None] * vf[..., None, :]                    # [B,h,Nk,Nv]
    new_state = state * w[..., None] + kv
    if mode == "rwkv":
        read = state + (u.to(f32)[None, :, :, None] * kv
                        if u is not None else kv)
    else:
        read = new_state
    out = torch.einsum("bhk,bhkv->bhv", qf, read)
    return out.to(q.dtype), new_state


def naive_linear_recurrence(q, k, v, log_w, u=None, initial_state=None,
                            *, mode: str = "rwkv"):
    """Step-by-step oracle: same signature and semantics as the chunked
    form, O(S) sequential."""
    B, S, h, Nk = q.shape
    Nv = v.shape[-1]
    state = (torch.zeros((B, h, Nk, Nv), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.float())
    outs = []
    for t in range(S):
        o, state = recurrent_step(q[:, t], k[:, t], v[:, t], log_w[:, t],
                                  state, u, mode=mode)
        outs.append(o)
    return torch.stack(outs, dim=1), state
