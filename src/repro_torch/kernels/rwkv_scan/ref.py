"""Plain PyTorch versions of the WKV scan kernels: :func:`wkv_scan_ref`,
the chunked linear recurrence of :mod:`repro_torch.models.linrec` over the
Pallas kernel's layout (the port of ``repro/kernels/rwkv_scan/ref.py``),
and :func:`wkv_subchunk_ref`, the algorithm of the ``tensor_core`` route in
model layout."""
from __future__ import annotations

from typing import Optional

import torch

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
