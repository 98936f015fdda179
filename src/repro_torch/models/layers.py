"""Shared building blocks: norms, the gated and GELU MLPs, RoPE, sinusoidal
positions and init helpers (the port's ``repro/models/layers.py``).

Norms and RoPE compute in fp32 and cast back to the input's dtype, as the
JAX versions do.  Weights are laid out ``[d_in, d_out]`` and applied as
``x @ W``.  Inits draw in fp32 from a :class:`torch.Generator` on the
target device and cast; on the ``meta`` device they make shapes only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def normal(gen: Optional[torch.Generator], shape: Sequence[int], std: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in fp32 from ``gen`` on ``device``, cast to
    ``dtype``; an uninitialised tensor of that shape on ``meta``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               device="cpu") -> torch.Tensor:
    return normal(gen, (d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5, dtype,
                  device)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype = torch.float32,
               device="cpu") -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """Llama-style gated MLP: (silu(x W1) * (x W3)) W2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, tp=None) -> torch.Tensor:
    """Whisper-style MLP: gelu(x W1 + b1) W2 + b2, with the tanh GELU the
    JAX package uses (``approximate=True``; the exact one differs by about
    1e-3).  Under ``tp`` (a ``tensor_parallel.TensorParallel``) ``w1``,
    ``b1`` and ``w2`` are this rank's FFN block: the partial product is
    summed over the model axis (``tp.exit``) and ``b2``, whole, is added
    once after the sum."""
    y = F.gelu(x @ w1 + b1, approximate="tanh") @ w2
    if tp is None:
        return y + b2
    return tp.exit(y) + tp.norm_weight(b2)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  Rotates
    the two halves of the head dim (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    angles = positions[..., :, None].float() * freqs           # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]               # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device="cpu") -> torch.Tensor:
    """Whisper encoder's fixed sinusoidal embedding table [seq, d]."""
    return sinusoidal_at(torch.arange(seq, device=device), d)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at arbitrary positions [S] -> [S, d] fp32: sin
    in the even columns, cos in the odd ones."""
    pos = positions.float()[:, None]
    div = torch.exp(-torch.log(torch.tensor(10_000.0))
                    * torch.arange(0, d, 2, dtype=torch.float32) / d)
    angles = pos * div.to(positions.device)
    tab = torch.empty((positions.shape[0], d), dtype=torch.float32,
                      device=positions.device)
    tab[:, 0::2] = torch.sin(angles)
    tab[:, 1::2] = torch.cos(angles)
    return tab
