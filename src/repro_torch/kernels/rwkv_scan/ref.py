"""Plain PyTorch version of the WKV scan kernel: the chunked linear
recurrence of :mod:`repro_torch.models.linrec` over the kernel's layout
(the port of ``repro/kernels/rwkv_scan/ref.py``)."""
from __future__ import annotations

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
