"""Plain PyTorch versions of the WKV scan kernels: :func:`wkv_scan_ref`,
the chunked linear recurrence of :mod:`repro_torch.models.linrec` over the
Pallas kernel's layout (the port of ``repro/kernels/rwkv_scan/ref.py``),
:func:`wkv_subchunk_ref`, the algorithm of the ``tensor_core`` route, and
:func:`wkv_chunk_f32_ref`, that of the ``chunk_f32`` route, both in model
layout; :func:`wkv_backward_ref`, autograd through the chunked
recurrence, is the plain version of the backward kernel."""
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
