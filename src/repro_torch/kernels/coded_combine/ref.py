"""Plain PyTorch versions of the four coded-combine kernels.

Each repeats its kernel's arithmetic in the kernel's order (the order of
the Pallas kernels in ``repro/kernels/coded_combine/kernel.py``): fp32
accumulation over i = 0..r-1 as a multiply then an add, one round to the
stream dtype, and a true division in the decode.  ``ops`` uses them for
tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them
on the card.
"""
from __future__ import annotations

import torch


def encode_ref(streams: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """streams: [r, ...]; coeffs: [r] -> sum_i c_i v_i, in streams dtype."""
    c = coeffs.to(device=streams.device, dtype=torch.float32)
    acc = c[0] * streams[0].float()
    for i in range(1, streams.shape[0]):
        acc = acc + c[i] * streams[i].float()
    return acc.to(streams.dtype)


def decode_ref(f: torch.Tensor, known: torch.Tensor,
               coeffs: torch.Tensor) -> torch.Tensor:
    """coeffs[0] is the missing stream's coefficient; coeffs[1:] those of
    the r-1 known streams [r-1, ...]."""
    c = coeffs.to(device=f.device, dtype=torch.float32)
    acc = f.float()
    for i in range(known.shape[0]):
        acc = acc - c[i + 1] * known[i].float()
    return (acc / c[0]).to(f.dtype)


def _words(x: torch.Tensor) -> torch.Tensor:
    # uint32 has few kernels in PyTorch; XOR the same bits as int32
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def xor_encode_ref(streams: torch.Tensor) -> torch.Tensor:
    acc = _words(streams[0])
    for i in range(1, streams.shape[0]):
        acc = acc ^ _words(streams[i])
    return acc.view(streams.dtype)


def xor_decode_ref(f: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    acc = _words(f)
    for i in range(known.shape[0]):
        acc = acc ^ _words(known[i])
    return acc.view(f.dtype)
