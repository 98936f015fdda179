"""Public flash attention op: the port's ``repro/kernels/flash_attention/
ops.py``, in model layout.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel (``csrc/flash_attention.cu``, built at first use by
:mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the
plain version :func:`.ref.attention_ref`.  There is no fallback from the
card to the CPU and no library attention.

The JAX wrapper transposes to ``[B*KV, G, S, hd]`` and pads hd to 128
lanes and S to its block sizes for the TPU's tiling.  The kernel reads
q ``[B, Sq, H, hd]`` and k/v ``[B, Sk, KV, hd]`` in place through their
strides and needs no padding or block sizes.  Query positions and the
valid key count are runtime arguments (ints or tensors on the card), so a
decode step reuses the same launch for every position.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls that took the
plain version (CPU tensors); :func:`reset_launch_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional, Union

import torch

from . import ref
from .. import _build

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes
MAX_HEAD_DIM = 128


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0
    PLAIN_CALLS["flash_attention"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention",
                              "flash_attention/csrc/flash_attention.cu")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fa_forward.argtypes = ([i32, p, p, p, p] + [i32] * 6 + [i64] * 9
                               + [p, i32, p, i32, i32, i32, i32,
                                  ctypes.c_float, i32, p])
    lib.fa_forward.restype = ctypes.c_int
    return lib


def build() -> float:
    """Build (or load) the kernel now; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _int32_on(x: torch.Tensor, device: torch.device, shape) -> torch.Tensor:
    x = torch.broadcast_to(x.to(device=device, dtype=torch.int32), shape)
    return x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    kv_valid: Union[None, int, torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    ) -> torch.Tensor:
    """Model layout: q [B, Sq, H, hd]; k, v [B, Sk, KV, hd]; H = KV * G.
    Query i sits at position ``q_positions[i]`` when given, else
    ``q_offset + i``; keys at index >= ``kv_valid`` (an int, or a [] / [B]
    tensor) are masked.  Returns [B, Sq, H, hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"[B, Sq, KV*G, hd] / [B, Sk, KV, hd]")
    if q.device.type == "cpu":
        PLAIN_CALLS["flash_attention"] += 1
        pos = (q_positions if q_positions is not None
               else torch.arange(q_offset, q_offset + Sq))
        return ref.attention_ref(q, k, v, pos, kv_valid, causal=causal,
                                 window=window)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must share one CUDA "
                         f"device (or the CPU), got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16 on the card, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM} "
                         f"is not supported by the kernel")
    # the kernel takes any strides but a unit stride along hd
    q, k, v = (x if x.stride(3) == 1 else x.contiguous() for x in (q, k, v))
    pos_ptr, valid_ptr, valid_n = None, None, Sk
    if q_positions is not None:
        q_positions = _int32_on(q_positions, q.device, (Sq,))
        pos_ptr = q_positions.data_ptr()
    if isinstance(kv_valid, torch.Tensor):
        kv_valid = _int32_on(kv_valid, q.device, (B,))
        valid_ptr = kv_valid.data_ptr()
    elif kv_valid is not None:
        valid_n = int(kv_valid)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # 16-byte loads when every row of q, k, v starts 16-byte aligned
    per16 = 16 // q.element_size()
    vec = hd % per16 == 0 and all(
        x.data_ptr() % 16 == 0 and all(st % per16 == 0
                                       for st in x.stride()[:3])
        for x in (q, k, v))
    rc = _library().fa_forward(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        pos_ptr, int(q_offset), valid_ptr, valid_n, int(bool(causal)),
        int(window is not None), int(window or 0), hd ** -0.5, int(vec),
        _build.stream_handle())
    _build.check_launch(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
