"""The flash attention backward op: dQ, dK and dV of
:func:`.ops.flash_attention`'s function.

On a CUDA tensor :func:`flash_attention_backward` launches the hand-written
Hopper kernel ``csrc/flash_backward.cu`` (built at first use by
:mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the
plain version :func:`.ref.attention_backward_ref` (autograd through
:func:`.ref.attention_ref`).  The JAX package has no backward Pallas kernel
(``jax.value_and_grad`` differentiates its jnp attention): this is the
port's own, and :mod:`.ops` pairs it with the forward kernels in a
``torch.autograd.Function``.

Every key below Sk is valid: the autograd path refuses ``kv_valid``.
``LAUNCHES`` counts wrapper calls that launched (two device kernels each),
``PLAIN_CALLS`` calls that took the plain version; :func:`reset_launch_counts`
zeroes both.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional, Tuple

import torch

from . import ref
from .. import _build

LAUNCHES: Dict[str, int] = {"flash_attention_backward": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention_backward": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes


class _Args(ctypes.Structure):
    """``BwdArgs`` of csrc/flash_backward.cu, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "o", "dout", "dq", "dk", "dv", "lse",
                  "delta")]
                + [(n, ctypes.c_int) for n in
                   ("B", "Sq", "Sk", "H", "KV", "hd")]
                + [(f"{t}_s{a}", ctypes.c_int64) for t in "qkvod"
                   for a in "bsh"]
                + [("q_pos", ctypes.c_void_p), ("q_offset", ctypes.c_int),
                   ("causal", ctypes.c_int), ("has_window", ctypes.c_int),
                   ("window", ctypes.c_int), ("scale", ctypes.c_float)])


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention_backward"] = 0
    PLAIN_CALLS["flash_attention_backward"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_backward",
                              "flash_attention/csrc/flash_backward.cu")
    lib.fa_backward.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.fa_backward.restype = ctypes.c_int
    lib.fa_backward_args_size.restype = ctypes.c_int
    if lib.fa_backward_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"flash_attention_backward: BwdArgs is "
                           f"{lib.fa_backward_args_size()} bytes in the "
                           f"library, {ctypes.sizeof(_Args)} in its mirror")
    return lib


def build() -> float:
    """Build (or load) the kernel now; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _last_dim_unit(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None, q_offset: int = 0,
                             q_positions: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=, window=,
    q_offset=, q_positions=)`` (model layout, every key valid) given its
    output ``out`` and the gradient ``dout`` reaching it.  The gradients
    take q's, k's and v's dtypes and shapes (contiguous)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % KV
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_backward: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)} do "
                         f"not fit [B, Sq, KV*G, hd] / [B, Sk, KV, hd]")
    dev = q.device
    if dev.type == "cpu":
        PLAIN_CALLS["flash_attention_backward"] += 1
        pos = (q_positions if q_positions is not None
               else torch.arange(q_offset, q_offset + Sq))
        return ref.attention_backward_ref(q, k, v, dout, pos, causal=causal,
                                          window=window)
    tensors = (q, k, v, out, dout)
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("flash_attention_backward: q, k, v, out, dout must "
                         "share one CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"flash_attention_backward: q, k, v, out, dout must "
                        f"all be float32 or all bfloat16 on the card, got "
                        f"{[x.dtype for x in tensors]}")
    from .ops import MAX_HEAD_DIM          # the forward's cap (ops imports us)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_backward: head dim {hd} > "
                         f"{MAX_HEAD_DIM} is not supported by the kernel")
    q, k, v, out, dout = (_last_dim_unit(x) for x in tensors)
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, KV, hd), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Sk, KV, hd), dtype=q.dtype, device=dev)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = torch.empty((2, B, H, Sq), dtype=torch.float32, device=dev)
    pos_ptr = 0
    if q_positions is not None:
        q_positions = torch.broadcast_to(
            q_positions.to(device=dev, dtype=torch.int32), (Sq,)).contiguous()
        pos_ptr = q_positions.data_ptr()
    strides = [s for x in (q, k, v, out, dout) for s in x.stride()[:3]]
    args = _Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                 B, Sq, Sk, H, KV, hd, *strides, pos_ptr, int(q_offset),
                 int(bool(causal)), int(window is not None),
                 int(window or 0), hd ** -0.5)
    rc = _library().fa_backward(_DTYPES[q.dtype], ctypes.addressof(args),
                                _build.stream_handle())
    _build.check_launch(rc, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv
