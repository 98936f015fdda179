"""Plain PyTorch versions of the WKV scan kernels: :func:`wkv_scan_ref`,
the chunked linear recurrence of :mod:`repro_torch.models.linrec` over the
Pallas kernel's layout (the port of ``repro/kernels/rwkv_scan/ref.py``),
:func:`wkv_subchunk_ref`, the algorithm of the ``tensor_core`` route, and
:func:`wkv_chunk_f32_ref`, that of the ``chunk_f32`` route, both in model
layout; :func:`wkv_backward_ref`, autograd through the chunked
recurrence, is the plain version of the backward kernel, and
:func:`wkv_backward_chunk_ref` the algorithm of its ``chunk`` route."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...models.linrec import chunked_linear_recurrence


def wkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                 chunk: int = 64):
    """Same signature as wkv_scan_pallas: r/k/log_w [BH, S, Nk],
    v [BH, S, Nv], u [BH, Nk], s0 [BH, Nk, Nv].  Returns (out [BH, S, Nv],
    final state [BH, Nk, Nv] fp32)."""
    # each of the BH rows is one head of a batch of one
    as_heads = lambda x: x.transpose(0, 1)[None]           # [1, S, BH, N]
    out, sT = chunked_linear_recurrence(
        as_heads(r), as_heads(k), as_heads(v), as_heads(log_w), u=u,
        initial_state=s0[None], mode="rwkv", chunk=chunk, return_state=True)
    return out[0].transpose(0, 1), sT[0]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: what ``cvt.rna.tf32.f32`` gives the tensor cores."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def wkv_subchunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None, *, chunk: int = 64,
                     sub: int = 16, leaf: Optional[int] = None,
                     tf32: bool = False):
    """The plain version of the ``tensor_core`` route's algorithm
    (``csrc/wkv_chunk.cuh``: ``chunk=32, sub=16, leaf=8``), in model
    layout: r, k, log_w [B, S, h, Nk], v [B, S, h, Nv], u [h, Nk], s0 [B,
    h, Nk, Nv] or None.  Returns (out [B, S, h, Nv] in r's dtype, final
    state [B, h, Nk, Nv] fp32).

    Per chunk of ``chunk`` steps, with A the in-chunk running sum of log_w
    and A_q[t] = A[t-1] (0 at t = 0), every exponent a difference <= 0:

    * inter-chunk: (r * exp(A_q)) @ S;
    * between sub-chunks of ``sub`` rows (query block tb after key block
      sb, e the last row of sb): M = (r * exp(A_q - A[e])) @
      (k * exp(A[e] - A))^T;
    * diagonal blocks directly: M[t, s] = sum_i r_ti k_si exp(A_q[t, i] -
      A[s, i]) for s < t, and the bonus M[t, t] = sum_i r_ti u_i k_ti;
      with ``leaf`` each diagonal block is first split the same way into
      blocks of ``leaf`` rows, and only theirs are direct;
    * out = inter + M @ v; the state S <- diag(exp A[-1]) S + (k *
      exp(A[-1] - A))^T @ v.

    fp32 throughout; ``tf32=True`` rounds every product's operands to TF32
    as the kernel feeds its tensor cores.  The ragged last chunk is padded
    with r = k = v = 0 and log_w = 0, which leaves the state alone."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    sizes = (sub,) if leaf is None else (sub, leaf)
    if chunk % sub or sub % sizes[-1]:
        raise ValueError(f"chunk {chunk}, sub {sub}, leaf {leaf}: each "
                         f"must divide the one before")
    f32 = torch.float32
    rnd = tf32_round if tf32 else (lambda x: x)
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def blocks(x):                          # [nc, B, h, chunk, N], fp32
        x = torch.nn.functional.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, chunk, h, x.shape[-1]).permute(1, 0, 3, 2, 4)
    rc, kc, vc, wc = map(blocks, (r, k, v, log_w))
    state = (torch.zeros((B, h, Nk, Nv), dtype=f32, device=r.device)
             if s0 is None else s0.to(f32))
    uf = u.to(f32)[None, :, None, :]                        # [1, h, 1, Nk]

    def intra(M, rb, kb, A, Aq, lo, hi, sizes):
        """M[lo:hi, lo:hi] below and on the diagonal."""
        size = sizes[0]
        for t0 in range(lo, hi, size):
            q = slice(t0, t0 + size)
            for e in range(lo + size - 1, t0, size):       # key blocks
                key = slice(e + 1 - size, e + 1)
                r_hat = rb[:, :, q] * torch.exp(Aq[:, :, q] - A[:, :, e:e + 1])
                k_hat = kb[:, :, key] * torch.exp(A[:, :, e:e + 1]
                                                  - A[:, :, key])
                M[:, :, q, key] = rnd(r_hat) @ rnd(k_hat).transpose(-1, -2)
            if len(sizes) > 1:
                intra(M, rb, kb, A, Aq, t0, t0 + size, sizes[1:])
                continue
            lower = torch.tril(torch.ones(size, size, dtype=torch.bool,
                                          device=r.device), -1)
            expo = Aq[:, :, q, None] - A[:, :, None, q]  # [B, h, t, s, Nk]
            gate = torch.where(lower[:, :, None], torch.exp(expo), 0.0)
            diag = torch.einsum("bhtk,bhsk,bhtsk->bhts", rb[:, :, q],
                                kb[:, :, q], gate)
            bonus = (rb[:, :, q] * uf * kb[:, :, q]).sum(-1)
            M[:, :, q, q] = diag + torch.diag_embed(bonus)

    outs = []
    for c in range(nc):
        rb, kb, vb, wb = rc[c], kc[c], vc[c], wc[c]     # [B, h, chunk, *]
        A = torch.cumsum(wb, dim=2)
        Aq = torch.nn.functional.pad(A[:, :, :-1], (0, 0, 1, 0))
        out = rnd(rb * torch.exp(Aq)) @ rnd(state)
        M = torch.zeros((B, h, chunk, chunk), dtype=f32, device=r.device)
        intra(M, rb, kb, A, Aq, 0, chunk, sizes)
        out = out + rnd(M) @ rnd(vb)
        A_tot = A[:, :, -1]                                 # [B, h, Nk]
        k_til = kb * torch.exp(A_tot[:, :, None] - A)
        state = (state * torch.exp(A_tot)[..., None]
                 + rnd(k_til).transpose(-1, -2) @ rnd(vb))
        outs.append(out)
    out = torch.stack(outs, 1)                      # [B, nc, h, chunk, Nv]
    out = out.transpose(2, 3).reshape(B, nc * chunk, h, Nv)[:, :S]
    return out.to(r.dtype), state


LOG2E = 1.4426950408889634


def wkv_chunk_f32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: Optional[torch.Tensor] = None,
                      s0: Optional[torch.Tensor] = None, *,
                      mode: str = "rwkv", chunk: int = 64, block: int = 16):
    """The plain version of the ``chunk_f32`` route's algorithm
    (``csrc/wkv_chunk_f32.cuh``: ``chunk=64, block=16``), in model layout:
    q (r in mode 'rwkv'), k, log_w [B, S, h, Nk], v [B, S, h, Nv], u [h,
    Nk] (mode 'rwkv'; None: no bonus), s0 [B, h, Nk, Nv] or None.  Returns
    (out [B, S, h, Nv] in q's dtype, final state [B, h, Nk, Nv] fp32).

    Three steps, fp32 throughout, w = log_w * log2(e) (base 2):

    * (a) per chunk, its state ``dS = (k * 2^X)^T v`` with X the sum of w
      over the chunk's later steps, and its decay 2^(sum of w over it);
    * (b) the scan over chunks, ``S_c = diag(decay_c) S_{c-1} + dS_c`` from
      s0: each chunk's starting state and the final state;
    * (c) per chunk, cut into blocks of ``block`` steps: each block's
      starting state (S_0 the chunk's, ``S_b+1 = diag(2^T_b) S_b +
      (k * 2^Y)^T v`` over block b, T_b its sum of w, Y the sum of w
      over the block's later steps), then for the rows of block b ``out
      = (q * 2^P) S_b + M_b v`` with P the sum of w from the block's
      start through the step the query reads (t in mode 'inclusive',
      t - 1 in mode 'rwkv') and ``M_b[t, s] = sum_i q_ti k_si g_tsi``
      for s in the block up to that step, g the product of 2^w over the
      steps after s through it (mode 'rwkv': ``M_b[t, t] = sum_i q_ti
      u_i k_ti``).

    Every exponent is a sum of w over a run of steps, never a difference
    of two running sums, so it loses nothing to cancellation whatever
    decay came before: sums run in step order inside a block (forward
    from its start, or back from its end), and a block's total is added
    whole.  M_b's gates are running products: from the block's last step
    back, each key step multiplies the query's coefficients by its 2^w.
    The ragged last chunk is padded with q = k = v = 0 and log_w = 0,
    which leaves the state alone."""
    if mode not in ("rwkv", "inclusive"):
        raise ValueError(mode)
    if chunk % block:
        raise ValueError(f"block {block} must divide chunk {chunk}")
    B, S, h, Nk = q.shape
    Nv = v.shape[-1]
    f32 = torch.float32
    incl = mode == "inclusive"
    L, nb = block, chunk // block
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(x):                          # [B, h, nc, chunk, N], fp32
        x = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, chunk, h, x.shape[-1]).permute(0, 3, 1, 2, 4)
    qc, kc, vc = map(chunks, (q, k, v))
    w = chunks(log_w) * LOG2E
    wb = w.reshape(B, h, nc, nb, L, Nk)                 # blocks of L steps
    E = torch.exp2(w)
    lp_in = torch.cumsum(wb, 4)          # block start through t
    ls_in = torch.flip(torch.cumsum(torch.flip(wb, [4]), 4), [4])
    ls_ex = F.pad(ls_in[..., 1:, :], (0, 0, 0, 1))      # after s to the end
    lpx = lp_in if incl else F.pad(lp_in[..., :-1, :], (0, 0, 1, 0))
    t_rev, t_fwd = ls_in[..., 0, :], lp_in[..., -1, :]  # block totals
    dev = q.device
    blk = torch.arange(nb, device=dev)[:, None, None]   # a step's block

    def total(T, b):                    # block b's total, [..., 1, 1, Nk]
        return T[:, :, :, b, None, None, :]

    # (a) the chunks' states and decays
    x = ls_ex
    for b in range(nb):
        x = x + torch.where(blk < b, total(t_rev, b), 0.0)
    k_til = (kc.reshape(wb.shape) * torch.exp2(x)).reshape(kc.shape)
    dS = torch.einsum("bhcsk,bhcsv->bhckv", k_til, vc)
    tot = torch.zeros_like(t_rev[:, :, :, 0])
    for b in range(nb):
        tot = tot + t_rev[:, :, :, b]
    decay = torch.exp2(tot)                               # [B, h, nc, Nk]

    # (b) the scan over chunks
    state = (torch.zeros((B, h, Nk, Nv), dtype=f32, device=dev)
             if s0 is None else s0.to(f32))
    starts = []
    for c in range(nc):
        starts.append(state)
        state = decay[:, :, c, :, None] * state + dS[:, :, c]
    starts = torch.stack(starts, 2)                   # [B, h, nc, Nk, Nv]

    # (c) the outputs: each block's starting state ...
    shape = (B, h, nc, nb, L)
    k_hat = kc.reshape(wb.shape) * torch.exp2(ls_ex)
    v_blk = vc.reshape(*shape, Nv)
    dS_blk = torch.einsum("bhcnsk,bhcnsv->bhcnkv", k_hat, v_blk)
    block_states = [starts]
    for b in range(nb - 1):
        block_states.append(torch.exp2(t_fwd[:, :, :, b, :, None])
                            * block_states[-1] + dS_blk[:, :, :, b])
    block_states = torch.stack(block_states, 3)   # [B, h, nc, nb, Nk, Nv]
    qb = qc.reshape(wb.shape)
    out = torch.einsum("bhcntk,bhcnkv->bhcntv", qb * torch.exp2(lpx),
                       block_states)
    # ... and M_b: from the block's last step back, the coefficients
    # start at zero, take q_t at s = t (mode 'inclusive': before the key,
    # 'rwkv': after it, the bonus u taking the key s = t) and multiply by
    # each key step's 2^w
    E_blk = E.reshape(wb.shape)
    k_blk = kc.reshape(wb.shape)
    coef = torch.zeros_like(qb)
    bonus = (qb * u.to(f32)[None, :, None, None, None, :]
             if u is not None and not incl else torch.zeros_like(qb))
    M = torch.zeros((*shape, L), dtype=f32, device=dev)
    rows = torch.arange(L, device=dev)[:, None]
    for s_ in range(L - 1, -1, -1):
        diag = rows == s_                                        # [L, 1]
        if incl:
            coef = torch.where(diag, qb, coef)
        use = coef if incl else torch.where(diag, bonus, coef)
        M[..., s_] = (use * k_blk[..., s_, None, :]).sum(-1)
        coef = coef * E_blk[..., s_, None, :]
        if not incl:
            coef = torch.where(diag, qb, coef)
    out = out + torch.einsum("bhcnts,bhcnsv->bhcntv", M, v_blk)
    out = out.reshape(B, h, nc, chunk, Nv)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, nc * chunk, h, Nv)[:, :S]
    return out.to(q.dtype), state


def wkv_backward_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, u: torch.Tensor,
                     dout: torch.Tensor, *, chunk: int = 64):
    """(dr, dk, dv, dlog_w, du) of the WKV scan in model layout (zero
    initial state, final state unused) for the gradient ``dout`` of its
    output: autograd through :func:`chunked_linear_recurrence` in mode
    'rwkv' on the inputs' device."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (r, k, v, log_w, u)]
        out, _ = chunked_linear_recurrence(*xs[:4], u=xs[4], mode="rwkv",
                                           chunk=chunk)
        return torch.autograd.grad(out, xs, dout)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b; with ``tf32`` as the kernel's ``mma.sync`` takes it: each fp32
    operand split into hi = tf32(x) and lo = tf32(x - hi), and the product
    lo.hi + hi.lo + hi.hi (three TF32 products, fp32 sums)."""
    if not tf32:
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def wkv_backward_chunk_ref(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, log_w: torch.Tensor,
                           u: torch.Tensor, dout: torch.Tensor, *,
                           chunk: int = 64, sub: int = 16,
                           tf32: bool = True):
    """The plain version of the backward's ``chunk`` route
    (``csrc/wkv_backward_chunk.cuh``: ``chunk=64, sub=16``): (dr, dk, dv,
    dlog_w, du) of the WKV scan (zero initial state, final state unused)
    in model layout, each in its input's dtype.

    With w = log_w * log2(e), per chunk cut into blocks of ``sub`` steps,
    and per block its in-block sums of w before each step (Pin), after it
    (Xin) and over it (T); every gate is 2^(a sum of w over a run of
    steps), the runs between blocks taken as sums of whole blocks' T:

    * (a) each chunk's state (k 2^X)^T v and gradient state (r 2^P)^T dout
      (X the chunk's sums after a step, P before it) and decay 2^(sum T);
    * (b) the scans over chunks: each chunk's starting state S^c, its
      ending gradient state dS^c (dS_{c-1} = decay_c dS_c + its own), and
      Q^c = rowwise dS^c . S^{c+1};
    * (c) per chunk, M' = dout v^T and the forward's gated M (between
      blocks (r 2^Pin)(k 2^Xin 2^gap)^T, in the diagonal blocks gates as
      running products of E = 2^w and the bonus r u k on the diagonal);
      then per block dr' = 2^Pin (dout S^T 2^pre + sum over earlier
      blocks M' (k 2^Xin) 2^gap) + its diagonal block's terms, dk' = 2^Xin
      (v dS^T 2^post + sum over later blocks M'^T (r 2^Pin) 2^gap) + its
      diagonal block's, dv = (k 2^Xin 2^post) dS + M^T dout; dr = dr' + u k
      vd, dk = dk' + u r vd (vd = v . dout); dlog_w back through each
      block (dlog_w_t = Q_t - k_t dk'_t, Q_{t-1} = dlog_w_t + r_t dr'_t)
      from Q at its end: Q^c plus the later blocks' sums of r dr' - k dk'
      (rounding runs over at most a chunk's additions); du the chunks'
      sums of r k vd, added in (batch, chunk) order.

    ``tf32=True`` takes every product between blocks (and of the states)
    with split TF32 operands as the kernel's tensor cores do; the diagonal
    blocks are fp32.  The ragged last chunk is padded with zeros (log_w = 0:
    gates of 1, nothing added)."""
    if chunk % sub:
        raise ValueError(f"sub {sub} must divide chunk {chunk}")
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    f32 = torch.float32
    L, NB = sub, chunk // sub
    nc = -(-S // chunk)
    pad = nc * chunk - S
    dev = r.device

    def chunks(x):                          # [B, h, nc, chunk, N], fp32
        x = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, chunk, h, x.shape[-1]).permute(0, 3, 1, 2, 4)
    rc, kc, vc, dc = map(chunks, (r, k, v, dout))
    blocks = lambda x: x.reshape(B, h, nc, NB, L, x.shape[-1])
    rb, kb, vb, db = map(blocks, (rc, kc, vc, dc))
    wb = blocks(chunks(log_w) * LOG2E)
    uf = u.to(f32)

    # in-block sums in step order: Pin forward (T its total), Xin back
    Pin, Xin = torch.zeros_like(wb), torch.zeros_like(wb)
    acc = torch.zeros_like(wb[..., 0, :])
    for l in range(L):
        Pin[..., l, :] = acc
        acc = acc + wb[..., l, :]
    T = acc                                           # [B, h, nc, NB, Nk]
    acc = torch.zeros_like(T)
    for l in range(L - 1, -1, -1):
        Xin[..., l, :] = acc
        acc = acc + wb[..., l, :]
    E, ePin, eXin = torch.exp2(wb), torch.exp2(Pin), torch.exp2(Xin)
    rP, kX = rb * ePin, kb * eXin

    def span(a, b):     # 2^(T of blocks a+1 .. b-1), [B, h, nc, 1, Nk]
        s = torch.zeros_like(T[..., 0, :])
        for j in range(a + 1, b):
            s = s + T[..., j, :]
        return torch.exp2(s)[..., None, :]
    pre = [span(-1, t) for t in range(NB)]
    post = [span(s, NB) for s in range(NB)]
    tr = lambda x: x.transpose(-1, -2)

    # (a) the chunks' states, gradient states and decays
    kXp = torch.cat([kX[..., s, :, :] * post[s] for s in range(NB)], -2)
    rPp = torch.cat([rP[..., t, :, :] * pre[t] for t in range(NB)], -2)
    local = _mm(tr(kXp), vc, tf32)                    # [B, h, nc, Nk, Nv]
    dlocal = _mm(tr(rPp), dc, tf32)
    tot = torch.zeros_like(T[..., 0, :])
    for j in range(NB):
        tot = tot + T[..., j, :]
    decay = torch.exp2(tot)[..., None]                # [B, h, nc, Nk, 1]

    # (b) the scans: starting states forward, ending gradient states back
    st = torch.zeros((B, h, Nk, Nv), dtype=f32, device=dev)
    starts = []
    for c in range(nc):
        starts.append(st)
        st = decay[:, :, c] * st + local[:, :, c]
    nexts = starts[1:] + [st]
    dst = torch.zeros_like(st)
    ends, qend = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        ends[c] = dst
        qend[c] = (dst * nexts[c]).sum(-1)
        dst = decay[:, :, c] * dst + dlocal[:, :, c]
    S0, dS = torch.stack(starts, 2), torch.stack(ends, 2)
    Q = torch.stack(qend, 2)                          # [B, h, nc, Nk]

    # (c) per chunk: M' and M ...
    Mp = _mm(dc, tr(vc), tf32).reshape(B, h, nc, NB, L, NB, L)
    M = torch.zeros_like(Mp)
    for t in range(NB):
        for s in range(t):
            M[:, :, :, t, :, s] = _mm(rP[..., t, :, :],
                                      tr(kX[..., s, :, :] * span(s, t)),
                                      tf32)
    # the diagonal blocks: from the block's last step back, the query's
    # coefficients start at zero, the bonus takes the key s = t, then r_t,
    # each key step multiplying them by its E
    coef, bonus = torch.zeros_like(rb), rb * uf[None, :, None, None, None, :]
    Md = torch.zeros((B, h, nc, NB, L, L), dtype=f32, device=dev)
    rows = torch.arange(L, device=dev)[:, None]
    for s_ in range(L - 1, -1, -1):
        diag = rows == s_
        Md[..., s_] = (torch.where(diag, bonus, coef)
                       * kb[..., s_, None, :]).sum(-1)
        coef = torch.where(diag, rb, coef * E[..., s_, None, :])
    for b in range(NB):
        M[:, :, :, b, :, b] = Md[:, :, :, b]

    # ... then each block's gradients
    def shift(x, d, down):      # x[t - d] (down) or x[t + d], zero outside
        return (F.pad(x[..., :L - d, :], (0, 0, d, 0)) if down
                else F.pad(x[..., d:, :], (0, 0, 0, d)))
    drp, dkp, dv = [], [], []
    for b in range(NB):
        Mpd = Mp[:, :, :, b, :, b]                    # [B, h, nc, L, L]
        # dr': the state before the chunk, the earlier blocks, the diagonal
        acc = _mm(db[..., b, :, :], tr(S0), tf32) * pre[b]
        for s in range(b):
            acc = acc + _mm(Mp[:, :, :, b, :, s], kX[..., s, :, :],
                            tf32) * span(s, b)
        acc = acc * ePin[..., b, :, :]
        gate = torch.ones_like(acc)
        for d in range(1, L):           # key t - d of query t
            m = F.pad(torch.diagonal(Mpd, -d, -2, -1), (d, 0))[..., None]
            acc = acc + gate * shift(kb[..., b, :, :], d, True) * m
            gate = gate * shift(E[..., b, :, :], d, True)
        drp.append(acc)
        # dk': the gradient state after the chunk, the later blocks, the
        # diagonal
        acc = _mm(vb[..., b, :, :], tr(dS), tf32) * post[b]
        for t in range(b + 1, NB):
            acc = acc + _mm(tr(Mp[:, :, :, t, :, b]), rP[..., t, :, :],
                            tf32) * span(b, t)
        acc = acc * eXin[..., b, :, :]
        gate = torch.ones_like(acc)
        for d in range(1, L):           # query s + d of key s
            m = F.pad(torch.diagonal(Mpd, -d, -2, -1), (0, d))[..., None]
            acc = acc + gate * shift(rb[..., b, :, :], d, False) * m
            gate = gate * shift(E[..., b, :, :], d, False)
        dkp.append(acc)
        # dv: the gradient state after the chunk, then M^T dout
        acc = _mm(kX[..., b, :, :] * post[b], dS, tf32)
        for t in range(b, NB):
            acc = acc + _mm(tr(M[:, :, :, t, :, b]), db[..., t, :, :], tf32)
        dv.append(acc)
    drp, dkp, dv = (torch.stack(x, 3).reshape(B, h, nc, chunk, -1)
                    for x in (drp, dkp, dv))
    vd = torch.diagonal(Mp.reshape(B, h, nc, chunk, chunk), 0, -2,
                        -1)[..., None]
    uk = uf[None, :, None, None, :]
    dr = drp + uk * kc * vd
    dk = dkp + uk * rc * vd
    # dlog_w back through each block from Q^c plus the later blocks' sums
    # of r dr' - k dk'
    kd, rdr = blocks(kc * dkp), blocks(rc * drp)
    ysum = torch.zeros_like(T)
    for l in range(L - 1, -1, -1):
        ysum = ysum + (rdr[..., l, :] - kd[..., l, :])
    dlw = torch.zeros_like(kd)
    for b in range(NB):
        q = Q
        for later in range(NB - 1, b, -1):
            q = q + ysum[..., later, :]
        for l in range(L - 1, -1, -1):
            dlw[..., b, l, :] = q - kd[..., b, l, :]
            q = dlw[..., b, l, :] + rdr[..., b, l, :]
    dlw = dlw.reshape(B, h, nc, chunk, Nk)
    rkv = blocks(rc * kc * vd)         # the chunk's r k vd, by blocks
    part = torch.zeros_like(Q)                        # [B, h, nc, Nk]
    for b in range(NB):
        pb = torch.zeros_like(Q)
        for l in range(L - 1, -1, -1):
            pb = pb + rkv[..., b, l, :]
        part = part + pb
    du = torch.zeros_like(uf)
    for b in range(B):
        for c in range(nc):
            du = du + part[b, :, c]

    def unchunk(x, like):
        x = x.permute(0, 2, 3, 1, 4).reshape(B, nc * chunk, h, x.shape[-1])
        return x[:, :S].to(like.dtype)
    return (unchunk(dr, r), unchunk(dk, k), unchunk(dv, v),
            unchunk(dlw, log_w), du.to(u.dtype))
