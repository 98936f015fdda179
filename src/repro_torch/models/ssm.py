"""Selective-SSM (Mamba-style) head of Hymba's parallel SSM branch (the
port's ``repro/models/ssm.py``).

Per head: a depthwise causal conv, then the selective state-space
recurrence

    h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t x_t        h in R^{state x hd}
    y_t = C_t^T h_t + D * x_t

mapped onto the gated linear recurrence in mode 'inclusive' with
q_t = C_t, k_t = dt_t * B_t, v_t = x_t, log_w = A * dt_t (A < 0).

The scan (:func:`inclusive_scan`): on a CPU tensor the plain chunked
recurrence of :mod:`.linrec` in mode 'inclusive', as the JAX package
computes it.  On a CUDA tensor the hand-written WKV kernels
(:mod:`repro_torch.kernels.rwkv_scan`): a prefill (S >= 16, fp32 streams,
no gradient) is one call of the ``chunk_f32`` kernels in inclusive mode
(:func:`repro_torch.kernels.rwkv_scan.ops.inclusive_scan`); under autograd
and for a decode step's S = 1 it goes through the identity

    q_t^T S_t = (q_t * exp(log_w_t))^T S_{t-1} + (q_t . k_t) v_t

(:func:`wkv_inclusive`): the WKV op with r = q * exp(log_w) and u = 0
computes the first term and carries the state (its gradient is the WKV
backward kernel's), the second is elementwise.  The streams are fp32
(``_selective_terms``), so that op takes ``chunk_f32`` at S >= 16 and
``step`` below.

Under a model axis (``tp``, a :class:`~repro_torch.distributed.
tensor_parallel.TensorParallel` that splits inside heads) a rank holds
columns [c0, c1) of the inner width: its columns of ``w_in``, ``w_gate``,
``conv`` and ``conv_b`` and its rows of ``w_B``, ``w_C``, ``w_dt`` and
``w_out``.  The stream, the gate and the depthwise conv run on its
columns; B, C and dt are partial sums over all heads, summed over
``model`` (their cotangents too: each rank reads other heads of them).
The recurrence is independent along v's columns, so the rank scans its
columns as sub-heads of ``g`` columns (``HeadBlock``: g = gcd(hd,
inner/tp)), each with the q, k and decay of the head it lies in: ``[B, S,
inner/(tp g), N]`` and ``[B, S, inner/(tp g), g]``, 25 sub-heads of 16 for
Hymba-1.5B at model 4.  ``dt_bias``, ``log_a`` and ``d_skip`` are read at
those heads: whole (the model axis does not divide the heads) through
``TensorParallel.shared_weight``, else this rank's heads.  The output is
the partial product with its rows of ``w_out``; the state a rank holds is
``[B, inner/(tp g), N, g]`` and its conv carry ``[B, W-1, inner/tp]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed import tensor_parallel as tpl
from ..kernels._card import on_card
from ..kernels.rwkv_scan import ops as rw_ops
from .layers import dense_init, normal
from .linrec import chunked_linear_recurrence, recurrent_step


def init_ssm_params(gen, cfg: ArchConfig, dtype, device) -> Dict:
    s = cfg.ssm
    assert s is not None
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    inner = h * hd
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    log_a = torch.log(torch.linspace(1.0, float(s.state_dim), s.state_dim,
                                     device=device))
    return {
        "w_in": dense_init(gen, d, inner, dtype, device),      # x path
        "w_gate": dense_init(gen, d, inner, dtype, device),    # silu gate
        "conv": normal(gen, (s.conv_width, inner), 1.0 / s.conv_width,
                       dtype, device),
        "conv_b": zeros(inner),
        # selective parameters (computed from the post-conv stream)
        "w_B": dense_init(gen, inner, h * s.state_dim, dtype, device),
        "w_C": dense_init(gen, inner, h * s.state_dim, dtype, device),
        "w_dt": dense_init(gen, inner, h, dtype, device),
        "dt_bias": zeros(h),
        # A (negative, per head/state) in fp32 whatever the model dtype
        "log_a": log_a[None, :].repeat(h, 1),                  # [h, state]
        "d_skip": torch.ones((h, 1), dtype=dtype, device=device),
        "w_out": dense_init(gen, inner, d, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,S,C]; w: [W,C]; prev: [B,W-1,C] carry.
    Returns (silu(y) [B,S,C], new carry [B,W-1,C])."""
    W, S = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype,
                       device=x.device)
           if prev is None else prev.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                           # [B, S+W-1, C]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    # the carry a copy: a view would keep the whole padded input alive
    return F.silu(y), (xp[:, -(W - 1):].clone() if W > 1 else pad)


def _at_sub_heads(w: torch.Tensor, cfg: ArchConfig,
                  tp: tpl.TensorParallel) -> torch.Tensor:
    """A per-head leaf (``dt_bias``, ``log_a``, ``d_skip``) at this rank's
    sub-heads: whole, through ``shared_weight`` (its gradient summed over
    'model'), or this rank's heads where the model axis splits them."""
    idx = tp.block_index("sub_heads", w.device)
    if w.shape[0] == cfg.n_heads:
        return tp.shared_weight(w).index_select(0, idx)
    return w.index_select(0, idx - tp.head_block().h0)


def _selective_terms(p: Dict, cfg: ArchConfig, u: torch.Tensor,
                     tp: Optional[tpl.TensorParallel] = None):
    """u: [..., inner] post-conv stream -> (q, k, v, log_w) per head; q, k
    and log_w fp32, v in u's dtype.  Under ``tp`` u is this rank's columns
    and the heads are its sub-heads (see the module docstring)."""
    s = cfg.ssm
    h, hd, N = cfg.n_heads, cfg.head_dim, s.state_dim
    lead = u.shape[:-1]
    if tp is None:
        B_t = (u @ p["w_B"]).reshape(*lead, h, N)
        C_t = (u @ p["w_C"]).reshape(*lead, h, N)
        dt = F.softplus((u @ p["w_dt"]).float() + p["dt_bias"].float())
        A = -torch.exp(p["log_a"].float())                    # [h, state]
        log_w = dt[..., None] * A                             # [..., h, state]
        k = B_t.float() * dt[..., None]
        v = u.reshape(*lead, h, hd)
        return C_t.float(), k, v, log_w
    blk = tp.head_block()
    idx = tp.block_index("sub_heads", u.device)
    parts = tp.sum_partials(torch.cat(
        [u @ p["w_B"], u @ p["w_C"], u @ p["w_dt"]], -1))
    B_t, C_t, dt = parts.split([h * N, h * N, h], -1)
    B_t = B_t.reshape(*lead, h, N).index_select(-2, idx)
    C_t = C_t.reshape(*lead, h, N).index_select(-2, idx)
    dt = F.softplus(dt.index_select(-1, idx).float()
                    + _at_sub_heads(p["dt_bias"], cfg, tp).float())
    A = -torch.exp(_at_sub_heads(p["log_a"], cfg, tp).float())
    log_w = dt[..., None] * A
    k = B_t.float() * dt[..., None]
    v = u.reshape(*lead, blk.n_sub, blk.g)
    return C_t.float(), k, v, log_w


def _skip(p: Dict, cfg: ArchConfig,
          tp: Optional[tpl.TensorParallel]) -> torch.Tensor:
    """``d_skip`` [heads, 1], at this rank's sub-heads under ``tp``."""
    return (p["d_skip"] if tp is None
            else _at_sub_heads(p["d_skip"], cfg, tp))


def wkv_inclusive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor,
                  initial_state: Optional[torch.Tensor] = None, *,
                  chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive recurrence through the WKV op (see the module
    docstring): q, k, log_w [B, S, h, Nk], v [B, S, h, Nv], one dtype.
    Returns (out [B, S, h, Nv], final state [B, h, Nk, Nv] fp32).  On a
    CUDA tensor one WKV launch; on a CPU tensor the WKV op's plain version
    (``chunk`` its chunk length)."""
    u = torch.zeros(q.shape[2:], dtype=torch.float32, device=q.device)
    out, state = rw_ops.wkv_scan(q * torch.exp(log_w), k, v, log_w, u,
                                 initial_state, chunk=chunk)
    return out + (q * k).sum(-1, keepdim=True) * v, state


def inclusive_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None, *,
                   chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """out_t = q_t^T S_t with S_t = diag(exp log_w_t) S_{t-1} + k_t v_t^T.
    Returns (out, final state).  CPU: the plain chunked recurrence
    (``chunk`` its chunk length); on the card (``on_card``: a CUDA tensor
    or a dry run's ``meta`` one): :func:`_card`."""
    if not on_card(q):
        return rw_ops.inclusive_scan(q, k, v, log_w, initial_state,
                                     chunk=chunk)
    return _card(q, k, v, log_w, initial_state, chunk=chunk)


def _card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, initial_state: Optional[torch.Tensor], *,
          chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """A card call: the WKV op's inclusive mode (one ``chunk_f32`` call)
    where that route takes the shape and no gradient is needed, else
    :func:`wkv_inclusive` (a decode step's S = 1, autograd)."""
    state = () if initial_state is None else (initial_state,)
    if (rw_ops.route(q.dtype, q.shape[1], q.shape[3], v.shape[3])
            == "chunk_f32"
            and not rw_ops.takes_function(q, k, v, log_w, *state)):
        return rw_ops.inclusive_scan(q, k, v, log_w, initial_state,
                                     chunk=chunk)
    return wkv_inclusive(q, k, v, log_w, initial_state, chunk=chunk)


def ssm_forward(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Dict] = None, *, chunk: int = 64,
                tp: Optional[tpl.TensorParallel] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,D] -> [B,S,D].  state: {'conv': [B,W-1,inner],
    'ssm': [B,h,state,hd]} for streaming/decode; the new state is returned
    (None when stateless).  Under ``tp`` x is whole on every rank, the
    state this rank's (see the module docstring) and the output its
    partial sum."""
    keep_state = state is not None
    u = x @ p["w_in"]
    gate = F.silu(x @ p["w_gate"])
    u, conv_carry = _causal_conv(u, p["conv"], p["conv_b"],
                                 state["conv"] if keep_state else None)
    q, k, v, log_w = _selective_terms(p, cfg, u, tp)
    out, s_new = inclusive_scan(q, k, v.float(), log_w,
                                state["ssm"] if keep_state else None,
                                chunk=chunk)
    out = out + v * _skip(p, cfg, tp).to(v.dtype)[None, None]
    out = out.reshape(u.shape).to(x.dtype)
    out = (out * gate) @ p["w_out"]
    new_state = {"conv": conv_carry, "ssm": s_new} if keep_state else None
    return out, new_state


def ssm_step(p: Dict, cfg: ArchConfig, x: torch.Tensor, state: Dict,
             tp: Optional[tpl.TensorParallel] = None,
             ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode in plain PyTorch. x: [B,D].  Under ``tp`` as
    :func:`ssm_forward`: this rank's state, its partial output."""
    u = x @ p["w_in"]                                         # [B, inner]
    gate = F.silu(x @ p["w_gate"])
    window = torch.cat([state["conv"].to(u.dtype), u[:, None]], dim=1)
    y = torch.einsum("bwc,wc->bc", window, p["conv"]) + p["conv_b"]
    u = F.silu(y)
    q, k, v, log_w = _selective_terms(p, cfg, u, tp)
    out, ssm_new = recurrent_step(q, k, v.float(), log_w, state["ssm"],
                                  mode="inclusive")
    out = out + v * _skip(p, cfg, tp).to(v.dtype)[None]
    out = out.reshape(u.shape).to(x.dtype)
    out = (out * gate) @ p["w_out"]
    return out, {"conv": window[:, 1:], "ssm": ssm_new}


def init_ssm_state(cfg: ArchConfig, batch: int, dtype, device,
                   tp: Optional[tpl.TensorParallel] = None) -> Dict:
    """Zero state: ``conv`` [B, W-1, inner] and ``ssm`` [B, h, state, hd]
    fp32; under ``tp`` this rank's columns, ``[B, W-1, inner/tp]`` and
    ``[B, inner/(tp g), state, g]``."""
    s = cfg.ssm
    inner, h, hd = cfg.n_heads * cfg.head_dim, cfg.n_heads, cfg.head_dim
    if tp is not None and tp.inside:
        blk = tp.head_block()
        inner, h, hd = blk.c1 - blk.c0, blk.n_sub, blk.g
    return {"conv": torch.zeros((batch, s.conv_width - 1, inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, h, s.state_dim, hd),
                               dtype=torch.float32, device=device)}
