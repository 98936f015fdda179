"""Mixture-of-Experts FFN (DeepSeek-V2-Lite fine-grained MoE; Grok-1 MoE):
the port's ``repro/models/moe.py``.

Token dispatch to experts is a MapReduce shuffle: token-choices are the
intermediate pairs keyed by their expert, and the experts are the
reducers.  This module holds the math: the float32 router, the dispatch
and combine, and the experts' gated MLPs, applied with ``torch.bmm`` over
``[E, C, D]`` buffers.  Three dispatch paths, as in the JAX package:

  * :func:`moe_ffn_dense`    — no capacity: every token through every
                               expert, one-hot combine; exact, O(T*E).
  * :func:`moe_ffn_capacity` — the one-hot einsum dispatch with a fixed
                               capacity C (overflow keeps only the shared
                               experts' output).
  * :func:`moe_ffn_sorted`   — the serving path: per group, token-choices
                               are sorted by expert (stable), ranked within
                               their expert with ``searchsorted``, and the
                               first C of each expert kept.

The sorted path reproduces the JAX keep-mask, slots and arrival order
exactly.  It moves rows with gathers only, never an atomic add: each kept
token-choice owns one slot, so the dispatch gathers each slot's token, and
the combine gathers each token's k rows and sums them in a fixed order, so
the result on the card is bitwise repeatable.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoEConfig
from ..distributed import tensor_parallel as tpl
from .layers import dense_init, normal

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_moe_params(gen, cfg: ArchConfig, dtype, device) -> Dict:
    """Per-layer MoE params (stacked expert weights: [E, ...]).  The router
    stays float32 whatever ``dtype`` is."""
    m = cfg.moe
    d, E = cfg.d_model, m.n_routed
    p = {
        "router": dense_init(gen, d, E, torch.float32, device),
        "w1": _expert_init(gen, E, d, m.d_ff_expert, dtype, device),
        "w3": _expert_init(gen, E, d, m.d_ff_expert, dtype, device),
        "w2": _expert_init(gen, E, m.d_ff_expert, d, dtype, device),
    }
    if m.n_shared:
        ff_sh = m.d_ff_expert * m.n_shared
        p["shared_w1"] = dense_init(gen, d, ff_sh, dtype, device)
        p["shared_w3"] = dense_init(gen, d, ff_sh, dtype, device)
        p["shared_w2"] = dense_init(gen, ff_sh, d, dtype, device)
    return p


def _expert_init(gen, E, d_in, d_out, dtype, device):
    return normal(gen, (E, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5,
                  dtype, device)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _router_probs(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    logits = x.float() @ router_w.float()                          # [T, E]
    return torch.softmax(logits, dim=-1)


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-then-TopK routing (DeepSeek-V2 style).

    x: [T, D] tokens.  Returns (weights [T, k] float32 renormalised, ids
    [T, k]), each row in descending probability.
    """
    w, ids = torch.topk(_router_probs(router_w, x), top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids


def aux_load_balance_loss(router_w: torch.Tensor, x: torch.Tensor,
                          top_k: int, rows=None) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over experts of
    fraction_tokens * fraction_prob * E).  On a rank's rows of a batch
    split by ``rows`` (``tensor_parallel.rows_policy``) the fractions are
    the whole batch's: counts and probability sums are summed over its
    batch axes."""
    probs = _router_probs(router_w, x)
    E = probs.shape[-1]
    ids = torch.topk(probs, top_k, dim=-1).indices
    # integer-valued float sums: exact in any order
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, ids.reshape(-1),
                        torch.ones(ids.numel(), device=x.device))
    counts = tpl.psum_rows(counts, rows)
    f = counts / torch.clamp(counts.sum(), min=1.0)
    if rows is None:
        return E * torch.sum(f * probs.mean(dim=0))
    n_tok = tpl.psum_rows(torch.full((), float(probs.shape[0]),
                                     device=x.device), rows)
    return E * torch.sum(f * tpl.psum_rows(probs.sum(dim=0), rows) / n_tok)


# ---------------------------------------------------------------------------
# Expert FFN application
# ---------------------------------------------------------------------------

def _expert_swiglu(w1, w3, w2, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, C, D] -> [E, C, D] through per-expert gated MLP."""
    h = F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2)


def moe_ffn_dense(p: Dict, m: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Exact (capacity-less) MoE: every token through every expert, gated by
    its renormalised top-k weights.  [T, D] -> [T, D]."""
    T, D = x.shape
    w, ids = route(p["router"], x, m.top_k)
    onehot = F.one_hot(ids, m.n_routed).to(x.dtype)              # [T, k, E]
    gate = torch.einsum("tk,tke->te", w.to(x.dtype), onehot)      # [T, E]
    xe = x[None].expand(m.n_routed, T, D)
    ye = _expert_swiglu(p["w1"], p["w3"], p["w2"], xe)            # [E, T, D]
    out = torch.einsum("etd,te->td", ye, gate)
    return out + _shared(p, x)


def moe_ffn_capacity(p: Dict, m: MoEConfig, x: torch.Tensor,
                     capacity: Optional[int] = None) -> torch.Tensor:
    """Capacity-based dispatch, the one-hot einsum formulation.

    x: [T, D].  Each expert takes at most C tokens in arrival order;
    overflow token-choices contribute nothing (the token keeps the shared
    experts' output)."""
    T, D = x.shape
    E, k = m.n_routed, m.top_k
    if capacity is None:
        capacity = max(int(T * k * m.capacity_factor / E), 1)
    C = min(capacity, T)
    w, ids = route(p["router"], x, k)

    onehot = F.one_hot(ids, E)                                    # [T, k, E]
    pos = torch.cumsum(onehot.reshape(T * k, E), dim=0) - 1       # arrival
    within = (pos.reshape(T, k, E) * onehot).sum(-1)              # [T, k]
    keep = within < C
    w = w * keep.to(w.dtype)

    # a rank >= C has no one-hot column (all zeros), as jax.nn.one_hot
    pos_oh = (within[..., None] == torch.arange(C, device=x.device)
              ).to(x.dtype)                                        # [T, k, C]
    oh = onehot.to(x.dtype)
    disp = torch.einsum("tke,tkc->tec", oh, pos_oh)
    comb = torch.einsum("tk,tke,tkc->tec", w.to(x.dtype), oh, pos_oh)
    xe = torch.einsum("td,tec->ecd", x, disp)                     # [E, C, D]
    ye = _expert_swiglu(p["w1"], p["w3"], p["w2"], xe)
    out = torch.einsum("ecd,tec->td", ye, comb)
    return out + _shared(p, x)


def sorted_dispatch(ids: torch.Tensor, n_experts: int, n_groups: int,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted path's placement of every token-choice.

    ids: [T, k] expert ids.  Within each of ``n_groups`` groups of T / G
    tokens, token-choices are stably sorted by expert and ranked within
    their expert; the first ``capacity`` of each expert are kept.  Returns
    (slot [T, k], keep [T, k]) in token order: a kept choice of group g,
    expert e and rank c sits at ``(g * E + e) * C + c`` of a
    ``[G, E, C]`` buffer, so ``slot - g * E * C`` is the JAX package's
    slot within the group.  A dropped choice has slot 0, as there."""
    T, k = ids.shape
    G, C = n_groups, capacity
    Tg = T // G
    e_flat = ids.reshape(G, Tg * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(Tg * k, device=ids.device) - first       # in expert
    # back to token order: rank_tok[g, order[g, i]] = rank[g, i]
    rank_tok = torch.empty_like(rank).scatter_(1, order, rank)
    keep = rank_tok < C
    g = torch.arange(G, device=ids.device)[:, None]
    slot = torch.where(keep, (g * n_experts + e_flat) * C + rank_tok, 0)
    return slot.reshape(T, k), keep.reshape(T, k)


def moe_ffn_sorted(p: Dict, m: MoEConfig, x: torch.Tensor,
                   n_groups: int = 1,
                   capacity: Optional[int] = None) -> torch.Tensor:
    """Production dispatch: per-group sort-based routing (GShard-style).

    x: [T, D].  Tokens are split into ``n_groups`` groups; each expert
    takes at most C = min(capacity, Tg * k) token-choices of a group, in
    arrival order (default capacity Tg * k * capacity_factor / E).  No
    [T, E, C] one-hot tensor is built: a [G, E, C, D] buffer is gathered
    by slot, and the experts run on its [E, G * C, D] transpose (a view
    for one group).
    """
    T, D = x.shape
    E, k = m.n_routed, m.top_k
    if T % n_groups:
        raise ValueError(f"moe_ffn_sorted: {T} tokens do not split into "
                         f"{n_groups} groups")
    Tg = T // n_groups
    if capacity is None:
        capacity = max(int(Tg * k * m.capacity_factor / E), 1)
    C = min(capacity, Tg * k)
    n_slots = E * n_groups * C

    w, ids = route(p["router"], x, k)
    slot, keep = sorted_dispatch(ids, E, n_groups, C)
    at = torch.where(keep, slot, n_slots)     # a dropped choice: row n_slots
    # dispatch: each slot gathers its token's row (an empty slot row T,
    # the zero row appended to x)
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k)
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=x.device)
    src[at.reshape(-1)] = tok.reshape(-1)
    x_ext = torch.cat([x, x.new_zeros((1, D))])
    xe = x_ext[src[:n_slots]].reshape(n_groups, E, C, D)
    ye = _expert_swiglu(p["w1"], p["w3"], p["w2"],
                        xe.transpose(0, 1).reshape(E, n_groups * C, D))
    ye = ye.reshape(E, n_groups, C, D).transpose(0, 1).reshape(n_slots, D)

    # combine: each token gathers its k rows (a dropped choice the zero
    # row) and sums them, weighted, in a fixed order
    ye_ext = torch.cat([ye, ye.new_zeros((1, D))])
    vals = ye_ext[at]                                             # [T, k, D]
    wk = w.to(x.dtype) * keep.to(x.dtype)
    out = (vals * wk[..., None]).sum(dim=1)
    return out + _shared(p, x)


def _shared(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if "shared_w1" not in p:
        return torch.zeros_like(x)
    h = F.silu(x @ p["shared_w1"]) * (x @ p["shared_w3"])
    return h @ p["shared_w2"]


def moe_ffn(p: Dict, m: MoEConfig, x: torch.Tensor, *,
            dense_dispatch: bool = False, n_groups: int = 1) -> torch.Tensor:
    """[.., D] -> [.., D]; flattens leading dims to a token axis."""
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1])
    if dense_dispatch:
        out = moe_ffn_dense(p, m, xt)
    else:
        out = moe_ffn_sorted(p, m, xt, n_groups=n_groups)
    return out.reshape(*lead, x.shape[-1])
