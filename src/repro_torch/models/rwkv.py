"""RWKV6 'Finch' blocks (the port's ``repro/models/rwkv.py``): time-mix
(WKV with data-dependent decay) and channel-mix.

  * DDLerp token-shift: every projection input is a data-dependent lerp
    between x_t and x_{t-1} through a shared low-rank trunk.
  * Data-dependent decay  w_t = exp(-exp(w0 + lora_w(.)))  per channel.
  * WKV: on a CUDA tensor the hand-written scan kernel
    (:mod:`repro_torch.kernels.rwkv_scan`); on a CPU tensor the plain
    chunked recurrence of :mod:`.linrec`, as the JAX package computes it.
  * Per-head GroupNorm (eps 64e-5) on the WKV output, SiLU(g) output gate.
  * Channel-mix: shifted lerp, squared-ReLU key MLP, sigmoid receptance.

Under a model axis (``tp``, a
:class:`~repro_torch.distributed.tensor_parallel.TensorParallel`) the input
is whole on every rank and the projections are this rank's: ``wr``, ``wk``,
``wv``, ``wg`` its columns (h/tp whole heads), ``wo`` its rows, ``u`` its
heads, and the WKV state its heads ``[B, h/tp, hd, hd]``; the time-mix
output is this rank's partial sum.  The replicated leaves enter through
the layout: the DDLerp (``mu_x``, ``mu``, ``maa_w1``, ``maa_w2``), the
decay LoRA's input projection and the channel-mix lerps feed the split
projections whole (``shared_weight``: their gradients summed over
``model``); the decay base ``w0``, the LoRA output ``w_lora_b`` and the
GroupNorm are read at this rank's columns only (``split_to_model``: the
blocks' gradients all-gathered).  The channel-mix value ``k @ wv`` is a
partial sum that multiplies the receptance: it is reduce-scattered to this
rank's columns, multiplied by this rank's receptance columns and the
product all-gathered (``scatter_columns``, ``gather_columns``), so its
output is whole.

Where the heads do not split whole (rwkv6-3b's 40 at model 16: 160
columns, 2.5 heads a rank) they split inside: the projections are the
rank's columns as before, r, k, v and the decay are all-gathered to the
heads its columns touch (``touched_heads``), the scan and GroupNorm run
over those heads whole with ``u`` (whole on every rank, as its spec) at
them, and the rank keeps its columns of the normed output
(``keep_columns``); a boundary head is computed on both ranks that share
it and the gather's backward sums its gradient.  The state holds the
touched heads ``[B, h1 - h0, hd, hd]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.tensor_parallel import split_to_model
from ..kernels.rwkv_scan import ops as rw_ops
from .layers import dense_init, normal
from .linrec import recurrent_step

DDLERP_RANK = 32          # low-rank trunk width of the time_maa loras
DECAY_RANK = 64           # rank of the decay lora


def init_tmix_params(gen, cfg: ArchConfig, dtype, device) -> Dict:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    assert h * hd == d, "RWKV6 requires n_heads * head_dim == d_model"
    full = lambda shape, x: torch.full(shape, x, dtype=dtype, device=device)
    return {
        # DDLerp base mixes (mu_x plus one per stream r,k,v,w,g)
        "mu_x": full((d,), 0.0),
        "mu": full((5, d), 0.0),
        "maa_w1": dense_init(gen, d, 5 * DDLERP_RANK, dtype, device),
        "maa_w2": normal(gen, (5, DDLERP_RANK, d), 0.01, dtype, device),
        # data-dependent decay
        "w0": full((d,), -6.0),                       # exp(-exp(-6)) ~ 1
        "w_lora_a": dense_init(gen, d, DECAY_RANK, dtype, device),
        "w_lora_b": normal(gen, (DECAY_RANK, d), 0.01, dtype, device),
        # projections
        "wr": dense_init(gen, d, d, dtype, device),
        "wk": dense_init(gen, d, d, dtype, device),
        "wv": dense_init(gen, d, d, dtype, device),
        "wg": dense_init(gen, d, d, dtype, device),
        "wo": dense_init(gen, d, d, dtype, device),
        # per-head diagonal bonus u ('time_faaaa')
        "u": normal(gen, (h, hd), 0.1, dtype, device),
        # per-head GroupNorm
        "gn_w": full((d,), 1.0),
        "gn_b": full((d,), 0.0),
    }


def init_cmix_params(gen, cfg: ArchConfig, dtype, device) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.zeros((d,), dtype=dtype, device=device),
        "mu_r": torch.zeros((d,), dtype=dtype, device=device),
        "wk": dense_init(gen, d, ff, dtype, device),
        "wv": dense_init(gen, ff, d, dtype, device),
        "wr": dense_init(gen, d, d, dtype, device),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} stream: [B,S,D] -> [B,S,D]; ``prev`` [B,D] seeds t=0."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _tmix_weights(p: Dict, tp) -> Dict:
    """``p`` as a rank's time-mix reads it: under ``tp`` the replicated
    leaves wrapped so that their gradients sum over the model axis (where
    heads split inside, ``u`` whole at the heads this rank's columns
    touch)."""
    if tp is None:
        return p
    q = dict(p)
    for name in ("mu_x", "mu", "maa_w1", "maa_w2", "w_lora_a"):
        q[name] = tp.shared_weight(p[name])
    for name in ("w0", "w_lora_b", "gn_w", "gn_b"):
        q[name] = split_to_model(p[name], tp.mesh, p[name].dim() - 1)
    if tp.inside:
        blk = tp.head_block()
        q["u"] = tp.shared_weight(p["u"])[blk.h0:blk.h1]
    return q


def _heads(tp, B: int, h: int, hd: int, *streams: torch.Tensor):
    """The WKV streams ``[B, S, n]`` (r, k, v, log w) at their heads
    ``[B, S, h, hd]``: this rank's whole heads, or where heads split
    inside the heads its columns touch (gathered from every rank's)."""
    if tp is not None and tp.inside:
        return tp.touched_heads(*streams)
    return tuple(x.reshape(B, x.shape[1], h, hd) for x in streams)


def _ddlerp(p: Dict, x: torch.Tensor,
            xprev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Data-dependent lerp for the 5 streams; returns (xr, xk, xv, xw, xg)."""
    dx = xprev - x
    xxx = x + dx * p["mu_x"]
    trunk = torch.tanh(xxx.float() @ p["maa_w1"].float())
    B, S = x.shape[:2]
    trunk = trunk.reshape(B, S, 5, DDLERP_RANK)
    off = torch.einsum("bsfr,frd->bsfd", trunk, p["maa_w2"].float())
    mix = p["mu"].float()[None, None] + off                    # [B,S,5,D]
    streams = x[:, :, None, :] + dx[:, :, None, :] * mix.to(x.dtype)
    return tuple(streams[:, :, i] for i in range(5))


def _decay_log_w(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """log(w_t) = -exp(w0 + lora_w(xw)) in fp32 (always < 0)."""
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float()) \
        @ p["w_lora_b"].float()
    return -torch.exp(p["w0"].float() + lora)


def _group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, h: int,
                eps: float = 64e-5, tp=None) -> torch.Tensor:
    """Per-head GroupNorm over [..., D] with D = h * hd.  Where heads split
    inside (``tp``), ``x`` holds the heads this rank's columns touch and
    ``w``, ``b`` its columns: the heads are normed whole, then this rank's
    columns kept."""
    shp = x.shape
    xg = x.reshape(*shp[:-1], h, shp[-1] // h).float()
    mu = xg.mean(-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(-1, keepdim=True)
    xg = ((xg - mu) * torch.rsqrt(var + eps)).reshape(shp)
    if tp is not None and tp.inside:
        xg = tp.keep_columns(xg)
    return (xg * w + b).to(x.dtype)


def tmix_forward(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                 state: Optional[Dict] = None, *, chunk: int = 64, tp=None,
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """RWKV6 time-mix. x: [B,S,D].

    ``state`` (decode/streaming): {'shift': [B,D], 'wkv': [B,h,hd,hd]}.
    Returns (out [B,S,D], new state or None when stateless).  ``chunk`` is
    the plain version's chunk length; on the card the WKV kernel's route
    (``rwkv_scan.ops.route``) sets its own: a bf16 prefill at head width 64
    runs the chunked tensor-core kernel, anything else (fp32, a decode
    step's S = 1) the step kernel.  Under ``tp`` the heads (and the state's
    ``wkv``) are this rank's and ``out`` is its partial sum.
    """
    B, S, D = x.shape
    hd = cfg.head_dim
    h = _local_heads(p, cfg, tp)
    p = _tmix_weights(p, tp)
    keep_state = state is not None
    prev = state["shift"] if keep_state else None
    s0 = state["wkv"] if keep_state else None

    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, prev))
    r, k, v, log_w = _heads(tp, B, h, hd, xr @ p["wr"], xk @ p["wk"],
                            xv @ p["wv"], _decay_log_w(p, xw))
    g = xg @ p["wg"]
    out, s_new = rw_ops.wkv_scan(r, k, v, log_w, p["u"], s0, chunk=chunk)
    out = _group_norm(out.reshape(B, S, h * hd), p["gn_w"], p["gn_b"], h,
                      tp=tp)
    out = (out * F.silu(g)) @ p["wo"]
    # the shift a copy: a view would keep the whole [B, S, D] input alive
    new_state = ({"shift": x[:, -1].clone(), "wkv": s_new} if keep_state
                 else None)
    return out, new_state


def tmix_step(p: Dict, cfg: ArchConfig, x: torch.Tensor, state: Dict,
              tp=None) -> Tuple[torch.Tensor, Dict]:
    """Single-token step in plain PyTorch. x: [B,D];
    state {'shift':[B,D],'wkv':[B,h,hd,hd]} (under ``tp`` this rank's
    heads, and ``out`` its partial sum)."""
    B, D = x.shape
    hd = cfg.head_dim
    h = _local_heads(p, cfg, tp)
    p = _tmix_weights(p, tp)
    xr, xk, xv, xw, xg = _ddlerp(p, x[:, None, :],
                                 state["shift"][:, None, :])
    r, k, v, log_w = (t[:, 0] for t in _heads(
        tp, B, h, hd, xr @ p["wr"], xk @ p["wk"], xv @ p["wv"],
        _decay_log_w(p, xw)))
    g = (xg @ p["wg"])[:, 0]
    out, wkv = recurrent_step(r, k, v, log_w, state["wkv"], u=p["u"],
                              mode="rwkv")
    out = _group_norm(out.reshape(B, h * hd), p["gn_w"], p["gn_b"], h,
                      tp=tp)
    out = (out * F.silu(g)) @ p["wo"]
    return out, {"shift": x, "wkv": wkv}


def cmix_forward(p: Dict, x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None, *, tp=None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 channel-mix. x: [B,S,D] -> ([B,S,D], last-token shift state).
    Under ``tp`` the output is whole on every rank (this rank's block of
    the sequence under sequence TP): see the module docstring."""
    mu_k, mu_r = ((p["mu_k"], p["mu_r"]) if tp is None else
                  (tp.shared_weight(p["mu_k"]), tp.shared_weight(p["mu_r"])))
    dx = _shift(x, prev) - x
    xk = x + dx * mu_k
    xr = x + dx * mu_r
    k = torch.square(F.relu(xk @ p["wk"]))
    if tp is None:
        return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1].clone()
    # a product of sums is not a sum of products: reduce k @ wv first
    kv = tp.scatter_columns(k @ p["wv"])
    return (tp.gather_columns(torch.sigmoid(xr @ p["wr"]) * kv),
            x[:, -1].clone())


def _local_heads(p: Dict, cfg: ArchConfig, tp) -> int:
    """The WKV heads a rank runs: its whole heads, or where heads split
    inside, the heads its columns touch."""
    if tp is not None and tp.inside:
        return tp.head_block().n_heads
    return p["wr"].shape[1] // cfg.head_dim


def init_tmix_state(cfg: ArchConfig, batch: int, dtype, device,
                    tp=None) -> Dict:
    """A zero time-mix state (under ``tp``, of this rank's heads, or where
    heads split inside of the heads its columns touch; the shift is
    whole)."""
    hd = cfg.head_dim
    h = (cfg.n_heads if tp is None else tp.head_block().n_heads
         if tp.inside else cfg.n_heads // tp.size)
    return {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
            "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                               device=device)}
