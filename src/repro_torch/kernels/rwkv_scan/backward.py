"""The WKV scan backward op: dr, dk, dv, dlog_w and du of
:func:`.ops.wkv_scan`'s function with a zero initial state and an unused
final state.

On a CUDA tensor :func:`wkv_scan_backward` launches the hand-written Hopper
kernels of ``csrc/wkv_backward.cu`` (built at first use by
:mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the
plain version :func:`.ref.wkv_backward_ref` (autograd through the chunked
recurrence).  The JAX package has no backward Pallas kernel
(``jax.value_and_grad`` differentiates its jnp recurrence): this is the
port's own, and :mod:`.ops` pairs it with the forward kernels in a
``torch.autograd.Function``.

``LAUNCHES`` counts wrapper calls that launched (three device kernels
each), ``PLAIN_CALLS`` calls that took the plain version;
:func:`reset_launch_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Tuple

import torch

from . import ref
from .. import _build

LAUNCHES: Dict[str, int] = {"wkv_scan_backward": 0}
PLAIN_CALLS: Dict[str, int] = {"wkv_scan_backward": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes


class _Args(ctypes.Structure):
    """``Args`` of csrc/wkv_backward.cu, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("r", "k", "v", "log_w", "u", "dout", "dr", "dk", "dv",
                  "dlog_w", "du", "du_part", "ckpt", "rdr")]
                + [(n, ctypes.c_int) for n in ("B", "T", "H", "nk", "nv")])


def reset_launch_counts() -> None:
    LAUNCHES["wkv_scan_backward"] = 0
    PLAIN_CALLS["wkv_scan_backward"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("wkv_backward",
                              "rwkv_scan/csrc/wkv_backward.cu")
    lib.wkv_backward.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    for fn in (lib.wkv_backward, lib.wkv_backward_args_size,
               lib.wkv_backward_chunk):
        fn.restype = ctypes.c_int
    if lib.wkv_backward_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"wkv_scan_backward: Args is "
                           f"{lib.wkv_backward_args_size()} bytes in the "
                           f"library, {ctypes.sizeof(_Args)} in its mirror")
    return lib


def build() -> float:
    """Build (or load) the kernel now; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def wkv_scan_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor,
                      dout: torch.Tensor, *, chunk: int = 64,
                      ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dlog_w, du) of ``wkv_scan(r, k, v, log_w, u)`` (model
    layout: r, k, log_w [B, S, h, Nk], v and dout [B, S, h, Nv], u [h, Nk])
    given the gradient ``dout`` of its output.  Each gradient takes its
    input's dtype and shape (contiguous).  ``chunk`` only sets the CPU plain
    version's chunk length."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    if (k.shape != r.shape or log_w.shape != r.shape
            or v.shape[:3] != (B, S, h) or tuple(u.shape) != (h, Nk)
            or dout.shape != v.shape):
        raise ValueError(f"wkv_scan_backward: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_w "
                         f"{tuple(log_w.shape)}, u {tuple(u.shape)}, dout "
                         f"{tuple(dout.shape)} do not fit [B, S, h, N]")
    if r.device.type == "cpu":
        PLAIN_CALLS["wkv_scan_backward"] += 1
        return ref.wkv_backward_ref(r, k, v, log_w, u, dout, chunk=chunk)
    tensors = (r, k, v, log_w, u, dout)
    if r.device.type != "cuda" or any(x.device != r.device for x in tensors):
        raise ValueError("wkv_scan_backward: all tensors must share one CUDA "
                         "device (or the CPU)")
    if (r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype
            or dout.dtype != r.dtype
            or log_w.dtype not in (torch.float32, r.dtype)):
        raise TypeError(f"wkv_scan_backward: r, k, v, dout must share "
                        f"float32 or bfloat16 and log_w be float32 or "
                        f"theirs, got {[x.dtype for x in tensors]}")
    from .ops import MAX_NK, MAX_NV          # the forward's caps
    if Nk > MAX_NK or Nv > MAX_NV:
        raise ValueError(f"wkv_scan_backward: Nk {Nk} > {MAX_NK} or Nv {Nv} "
                         f"> {MAX_NV} is not supported by the kernel")
    dev = r.device
    r, k, v, dout = (x.contiguous() for x in (r, k, v, dout))
    lw32 = log_w.to(torch.float32).contiguous()
    u32 = u.to(torch.float32).contiguous()
    dr, dk = torch.empty_like(r), torch.empty_like(k)
    dv = torch.empty_like(v)
    dlw = torch.empty(r.shape, dtype=torch.float32, device=dev)
    du = torch.empty((h, Nk), dtype=torch.float32, device=dev)
    if B * h * S == 0:
        return (dr.zero_(), dk.zero_(), dv.zero_(),
                dlw.zero_().to(log_w.dtype), du.zero_().to(u.dtype))
    lib = _library()
    chunks = -(-S // lib.wkv_backward_chunk())
    du_part = torch.empty((B, h, Nk), dtype=torch.float32, device=dev)
    ckpt = torch.empty((B, h, chunks, Nk, Nv), dtype=torch.float32,
                       device=dev)
    rdr = torch.empty((B, h, S, Nk), dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr() for x in (r, k, v, lw32, u32, dout, dr, dk, dv, dlw,
                                   du, du_part, ckpt, rdr)]
    args = _Args(*ptrs, B, S, h, Nk, Nv)
    rc = lib.wkv_backward(_DTYPES[r.dtype], ctypes.addressof(args),
                          _build.stream_handle())
    _build.check_launch(rc, "wkv_scan_backward")
    LAUNCHES["wkv_scan_backward"] += 1
    return dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype)
