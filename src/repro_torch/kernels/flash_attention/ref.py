"""Plain PyTorch versions of the flash attention kernel.

``flash_attention_ref`` is the port of ``repro/kernels/flash_attention/
ref.py`` (kernel layout, same signature).  ``attention_ref`` computes the
same function in model layout with runtime query positions and per-batch
valid lengths: it is what :func:`..ops.flash_attention` runs for a CPU
tensor, and what the CUDA kernels are held against on the card.
``attention_split_ref`` computes it the way the split-kv decode kernel
does (per-chunk partials, then a merge in chunk order); the card holds the
decode kernel against it too.  ``attention_wide_ref`` computes it the way
the wide tensor-core prefill kernel (hd 576) does: its blocks of folded
rows, its key tiles in its order, the base-2 online softmax and P as two
bf16 parts in the P V product; the card holds that kernel against it,
and the CPU tests hold it against the JAX op.  ``attention_backward_ref``
is autograd through ``attention_ref``: the plain version of the backward
kernel.
``attention_mma_ref`` computes the forward the way the TF32 tensor-core
kernel (route ``mma_tf32``) does: S and P V as split-TF32 products, the
base-2 softmax; the card holds that kernel against it, and the CPU tests
hold it against the JAX op.
``attention_backward_split_ref`` computes the same gradients with every
product's operands split into TF32 parts as the backward kernel's
``mma.sync`` products take them: the CPU tests' evidence that the split
keeps fp32's accuracy where one TF32 product does not.  Nothing on the card
path calls it.
"""
from __future__ import annotations

import math
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
    mask = _visible(B, Sk, q_positions, kv_valid, causal, window, q.device)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _visible(B: int, Sk: int, q_positions: torch.Tensor,
             kv_valid: Union[None, int, torch.Tensor], causal: bool,
             window: Optional[int], device) -> torch.Tensor:
    """[B, Sq (or 1), Sk] bool: key j is valid (j < kv_valid, [] or [B]),
    and, for the query at ``q_positions[i]``, not after it (causal) and
    inside its window."""
    kpos = torch.arange(Sk, device=device)
    qpos = q_positions.to(device)
    valid = torch.as_tensor(Sk if kv_valid is None else kv_valid,
                            device=device).to(torch.int64)
    valid = torch.broadcast_to(valid, (B,))
    mask = (kpos[None, :] < valid[:, None])[:, None, :]        # [B, 1, Sk]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
    if window is not None:
        mask = mask & (kpos[None, None, :] > qpos[None, :, None] - window)
    return mask


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


LOG2E = 1.4426950408889634
WIDE_ROWS = 64          # folded (position, head) rows of a wide-route block


def attention_wide_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_positions: torch.Tensor,
                       kv_valid: Union[None, int, torch.Tensor] = None, *,
                       causal: bool = True, key_tile: int = 64,
                       split_p: bool = True) -> torch.Tensor:
    """:func:`attention_ref`'s function (no window), computed as the wide
    tensor-core kernel computes it.  The rows of one (batch, kv head) are
    folded, row r = i * G + g for query i and head g, and cut into blocks
    of ``WIDE_ROWS``.  A block's key range is [0, hi): the largest end of
    its rows' visible keys, or [0, Sk) when one of its rows sees none (its
    weights are then uniform over all Sk keys).  The block walks the tiles
    of ``key_tile`` keys of that range from the last to the first: scores
    in fp32 scaled by scale * log2(e) (the fp32 product of the two), keys
    past the range skipped (weight 0), keys in it that a row does not see
    NEG_INF; m_t = max(m, max_j s), p = 2^(s - m_t),
    l = l 2^(m - m_t) + sum p, acc = acc 2^(m - m_t) + P V with fp32 sums,
    P = hi + lo, hi = bf16(p), lo = bf16(p - hi), as the kernel's two
    products take it (``split_p=False``: P = bf16(p), one product);
    out = acc / max(l, 1e-30) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    R = Sq * G
    nb = -(-R // WIDE_ROWS)
    pad = nb * WIDE_ROWS - R
    dev = q.device
    qf = q.float().reshape(B, Sq, KV, G, hd).permute(0, 2, 1, 3, 4)
    qf = torch.nn.functional.pad(qf.reshape(B, KV, R, hd), (0, 0, 0, pad))
    qf = qf.reshape(B, KV, nb, WIDE_ROWS, hd)
    valid = torch.as_tensor(Sk if kv_valid is None else kv_valid,
                            device=dev).to(torch.int64)
    valid = torch.broadcast_to(valid.clamp(0, Sk), (B,))
    row_pos = q_positions.to(dev, torch.int64).repeat_interleave(G)  # [R]
    row_hi = torch.broadcast_to(valid[:, None], (B, R))
    if causal:
        row_hi = torch.minimum(row_hi, row_pos[None, :] + 1)
    row_hi = torch.nn.functional.pad(row_hi, (0, pad), value=Sk)
    row_hi = row_hi.reshape(B, nb, WIDE_ROWS)                   # [B, nb, 64]
    real = (torch.arange(nb * WIDE_ROWS, device=dev) < R).reshape(
        nb, WIDE_ROWS)
    none = (real & (row_hi <= 0)).any(dim=-1)                   # [B, nb]
    hi = torch.where(none, Sk, torch.where(real, row_hi, 0).amax(dim=-1))
    n_t = (hi + key_tile - 1) // key_tile                       # [B, nb]
    scale = (torch.tensor(hd ** -0.5, dtype=torch.float32)
             * torch.tensor(LOG2E, dtype=torch.float32)).item()
    m = torch.full((B, KV, nb, WIDE_ROWS), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, KV, nb, WIDE_ROWS, hd, device=dev)
    kf, vf = k.float(), v.float()
    for t in reversed(range(int(n_t.max()) if n_t.numel() else 0)):
        j0 = t * key_tile
        keys = torch.arange(j0, j0 + key_tile, device=dev)
        n_in = max(min(Sk - j0, key_tile), 0)
        kt = torch.zeros(B, key_tile, KV, hd, device=dev)
        vt = torch.zeros_like(kt)
        kt[:, :n_in], vt[:, :n_in] = kf[:, j0:j0 + n_in], vf[:, j0:j0 + n_in]
        s = torch.einsum("bkrnh,bjkh->bkrnj", qf, kt) * scale
        s = torch.where((keys >= row_hi[..., None])[:, None], NEG_INF, s)
        s = torch.where((keys >= hi[..., None])[:, None, :, None, :],
                        -math.inf, s)
        m_t = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_t)
        p = torch.exp2(s - m_t[..., None])
        on = (t < n_t)[:, None, :, None]                         # [B,1,nb,1]
        l = torch.where(on, l * corr + p.sum(dim=-1), l)
        pb = p.to(torch.bfloat16).float()
        if split_p:
            pb = pb + (p - pb).to(torch.bfloat16).float()
        pv = torch.einsum("bkrnj,bjkh->bkrnh", pb, vt)
        acc = torch.where(on[..., None], acc * corr[..., None] + pv, acc)
        m = torch.where(on, m_t, m)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, KV, nb * WIDE_ROWS, hd)[:, :, :R]
    out = out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4)
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: what the backward kernel's operand rounding (one integer
    add; the tensor cores drop the low 13 bits) gives."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 split: bool) -> torch.Tensor:
    """``einsum(eq, a, b)`` on TF32 operands with fp32 sums.  ``split``: each
    operand x as hi = tf32(x) and lo = tf32(x - hi), the product
    lo.hi + hi.lo + hi.hi (lo.lo dropped), as the kernel takes fp32
    operands; otherwise one product of the rounded operands."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ah, bh)
    if split:
        al, bl = tf32_round(a - ah), tf32_round(b - bh)
        out = (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + out
    return out


def attention_backward_split_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor,
                                 q_positions: torch.Tensor, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 split: bool = True):
    """(dq, dk, dv) of :func:`attention_ref` (every key valid), computed as
    the backward kernel computes them: S = scale Q K^T, dP = dO V^T,
    dV = P^T dO, dK = scale dS^T Q and dQ = scale dS K, each product on
    TF32 operands (:func:`_tf32_einsum`; ``split=False`` rounds each
    operand once, which the kernel never does with fp32 data), P from the
    split S, D = dO . O with O the plain forward's output, and a row that
    sees no key giving 1 / Sk to every dV_j.  fp32 throughout; the
    gradients take q's, k's and v's dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd).float()
    dog = dout.reshape(B, Sq, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    mm = lambda eq, a, b: _tf32_einsum(eq, a, b, split)        # noqa: E731
    s = mm("bqkgh,bskh->bqkgs", qg, kf) * scale
    dp = mm("bqkgh,bskh->bqkgs", dog, vf)
    kpos = torch.arange(Sk, device=q.device)
    qpos = q_positions.to(q.device)[:, None]
    visible = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        visible = visible & (kpos[None, :] <= qpos)
    if window is not None:
        visible = visible & (kpos[None, :] > qpos - window)
    vis = visible[None, :, None, None, :]
    empty = ~visible.any(dim=1)[None, :, None, None, None]    # no key seen
    s = torch.where(vis, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - torch.where(empty, 0.0, lse)), 0.0)
    out = attention_ref(q.float(), k.float(), v.float(), q_positions,
                        causal=causal, window=window)
    D = (dog * out.reshape(B, Sq, KV, G, hd)).sum(-1, keepdim=True)
    ds = torch.where(vis, p * (dp - D), 0.0)
    dv = mm("bqkgs,bqkgh->bskh", torch.where(empty, 1.0 / Sk, p), dog)
    dk = mm("bqkgs,bqkgh->bskh", ds, qg) * scale
    dq = mm("bqkgs,bskh->bqkgh", ds, kf) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_mma_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor,
                      kv_valid: Union[None, int, torch.Tensor] = None, *,
                      causal: bool = True, window: Optional[int] = None,
                      split: bool = True) -> torch.Tensor:
    """:func:`attention_ref`'s function, computed as the TF32 tensor-core
    kernel computes it: S = Q K^T on TF32 operands (:func:`_tf32_einsum`:
    with ``split`` each operand as hi + lo parts, three products; else one
    rounding each, which the kernel never does with fp32 data), scaled by
    scale * log2(e) (the fp32 product of the two); a key a row does not see
    scores NEG_INF, so a row that sees none has uniform weights over all Sk
    keys; p = 2^(s - max); O = P V on TF32 operands the same way, with fp32
    sums;
    out = O / max(sum p, 1e-30) in q's dtype.  The kernel's blocks and key
    tiles change only the order of its fp32 sums: a key outside a block's
    range is one no row of the block sees, so it weighs 0 either way."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    scale = (torch.tensor(hd ** -0.5, dtype=torch.float32)
             * torch.tensor(LOG2E, dtype=torch.float32)).item()
    s = _tf32_einsum("bqkgh,bskh->bqkgs", qg, k.float(), split) * scale
    mask = _visible(B, Sk, q_positions, kv_valid, causal, window, q.device)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = _tf32_einsum("bqkgs,bskh->bqkgh", p, v.float(), split)
    out = o / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)
