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

On the card :func:`route` picks the kernels by dtype and shape alone, with
no fallback from one route to the other:

* ``chunk`` — fp32 or bf16 r, k, v, dout at Nk <= ``CHUNK_MAX_N``, Nv <=
  ``CHUNK_MAX_N`` and S >= ``CHUNK`` (RWKV6's heads, Hymba's SSM through
  its WKV identity): ``csrc/wkv_backward_chunk.cuh``, chunks of ``CHUNK``
  steps in parallel, cut into blocks of ``BLOCK`` whose products are split
  TF32 tensor-core products; plain version
  :func:`.ref.wkv_backward_chunk_ref`.
* ``step`` — everything else: the sequential kernels of
  ``csrc/wkv_backward.cu``, one block per (batch, head) walking time.

Inside a dry run a ``meta`` tensor takes the card's branch and launches
nothing: it allocates what the launch allocates (the gradients and the
route's scratch: :func:`_step_scratch`, :func:`chunk_args`) and reports
its work (:func:`backward_work`), as a card call does to an active
recorder.

``LAUNCHES`` counts wrapper calls that launched (four device kernels a
``chunk`` call, three a ``step`` call), ``ROUTE_CALLS`` the same calls by
route, ``PLAIN_CALLS`` calls that took the plain version, ``DRY_CALLS`` a
dry run's calls by route; :func:`reset_launch_counts` zeroes all four.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Tuple

import torch

from . import ref
from .. import _build
from .._card import account, on_card

LAUNCHES: Dict[str, int] = {"wkv_scan_backward": 0}
PLAIN_CALLS: Dict[str, int] = {"wkv_scan_backward": 0}
ROUTES = ("chunk", "step")
ROUTE_CALLS: Dict[str, int] = dict.fromkeys(ROUTES, 0)
DRY_CALLS: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes
CHUNK = 64                  # steps a chunk of the chunk route (kC of
                            # csrc/wkv_backward_chunk.cuh)
BLOCK = 16                  # steps a block (kL)
CHUNK_MAX_N = 64            # widest Nk and Nv it takes
STEP_CHUNK = 32             # steps a checkpoint of the step route (kC of
                            # csrc/wkv_backward.cu)


class _Args(ctypes.Structure):
    """``Args`` of csrc/wkv_backward.cu, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("r", "k", "v", "log_w", "u", "dout", "dr", "dk", "dv",
                  "dlog_w", "du", "du_part", "ckpt", "rdr")]
                + [(n, ctypes.c_int) for n in ("B", "T", "H", "nk", "nv")])


class _ChunkArgs(ctypes.Structure):
    """``wkvbc::Args`` of csrc/wkv_backward_chunk.cuh, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("r", "k", "v", "lw", "u", "dout", "dr", "dk", "dv", "dlw",
                  "du", "states", "dstates", "decay", "qend", "du_part")]
                + [(n, ctypes.c_int64 * 3) for n in ("sr", "sk", "sv", "sw",
                                                      "sd")]
                + [(n, ctypes.c_int) for n in ("B", "T", "H", "nk", "nv",
                                                "vec")])


def reset_launch_counts() -> None:
    LAUNCHES["wkv_scan_backward"] = 0
    PLAIN_CALLS["wkv_scan_backward"] = 0
    for r in ROUTES:
        ROUTE_CALLS[r] = 0
    DRY_CALLS.clear()


def route(dtype: torch.dtype, S: int, Nk: int, Nv: int) -> str:
    """The kernels a card call takes, by the dtype of r, k, v, dout and the
    shape alone."""
    if (dtype in _DTYPES and S >= CHUNK and Nk <= CHUNK_MAX_N
            and Nv <= CHUNK_MAX_N):
        return "chunk"
    return "step"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("wkv_backward",
                              "rwkv_scan/csrc/wkv_backward.cu")
    for fn in (lib.wkv_backward, lib.wkv_backward_chunked):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.wkv_backward, lib.wkv_backward_args_size,
               lib.wkv_backward_chunk, lib.wkv_backward_chunked,
               lib.wkv_backward_chunked_args_size,
               lib.wkv_backward_chunked_len,
               lib.wkv_backward_chunked_block):
        fn.restype = ctypes.c_int
    sizes = ((lib.wkv_backward_args_size(), ctypes.sizeof(_Args)),
             (lib.wkv_backward_chunk(), STEP_CHUNK),
             (lib.wkv_backward_chunked_args_size(),
              ctypes.sizeof(_ChunkArgs)),
             (lib.wkv_backward_chunked_len(), CHUNK),
             (lib.wkv_backward_chunked_block(), BLOCK))
    if any(a != b for a, b in sizes):
        raise RuntimeError(f"wkv_scan_backward: the library's (Args bytes, "
                           f"step chunk, chunk Args bytes, chunk, block) "
                           f"{[a for a, _ in sizes]} differ from the "
                           f"wrapper's {[b for _, b in sizes]}")
    return lib


def build() -> float:
    """Build (or load) the kernel now; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def backward_work(r: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
                  u: torch.Tensor) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) of one call.  The bytes are its bound's in
    ``PERF.md``: r, k, v and dout read and dr, dk, dv written in their
    dtype, log_w read and dlog_w written in fp32, u read and du written in
    fp32.  The FLOPs, which that bound leaves out, are counted as twice
    the forward's 7 a (step, i, j): each forward product has a gradient
    product."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    size = r.element_size()
    nbytes = (size * (4 * r.numel() + 3 * v.numel())
              + 4 * 2 * log_w.numel() + 4 * 2 * u.numel())
    return 14.0 * B * S * h * Nk * Nv, float(nbytes)


def _account(r, v, log_w, u, way: str) -> bool:
    """:func:`repro_torch.kernels._card.account` of a call on route
    ``way``."""
    return account("wkv_scan_backward", DRY_CALLS, way, r,
                   lambda: backward_work(r, v, log_w, u))


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
    if not on_card(r):
        if r.device.type != "cpu":
            raise ValueError(f"wkv_scan_backward: tensors must be on a CUDA "
                             f"device or the CPU, got {r.device}")
        PLAIN_CALLS["wkv_scan_backward"] += 1
        return ref.wkv_backward_ref(r, k, v, log_w, u, dout, chunk=chunk)
    tensors = (r, k, v, log_w, u, dout)
    if any(x.device != r.device for x in tensors):
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
    if route(r.dtype, S, Nk, Nv) == "chunk":
        return _launch_chunk(r, k, v, log_w, u, dout)
    return _launch_step(r, k, v, log_w, u, dout)


def _step_scratch(B: int, S: int, h: int, Nk: int, Nv: int, dev
                  ) -> Tuple[torch.Tensor, ...]:
    """The step route's fp32 scratch: du's partial sums a (batch, head),
    the state at each checkpoint of ``STEP_CHUNK`` steps, and r's reverse
    rows."""
    chunks = -(-S // STEP_CHUNK)
    mk = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    return mk(B, h, Nk), mk(B, h, chunks, Nk, Nv), mk(B, h, S, Nk)


def _launch_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                 ) -> Tuple[torch.Tensor, ...]:
    """One ``step`` call on the card (checked CUDA tensors of the kernels'
    dtypes and widths; any sequence length)."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
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
    du_part, ckpt, rdr = _step_scratch(B, S, h, Nk, Nv, dev)
    if _account(r, v, log_w, u, "step"):
        return dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype)
    lib = _library()
    ptrs = [x.data_ptr() for x in (r, k, v, lw32, u32, dout, dr, dk, dv, dlw,
                                   du, du_part, ckpt, rdr)]
    args = _Args(*ptrs, B, S, h, Nk, Nv)
    rc = lib.wkv_backward(_DTYPES[r.dtype], ctypes.addressof(args),
                          _build.stream_handle())
    _build.check_launch(rc, "wkv_scan_backward (step)")
    LAUNCHES["wkv_scan_backward"] += 1
    ROUTE_CALLS["step"] += 1
    return dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype)


def chunk_args(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
               grads: Tuple[torch.Tensor, ...],
               ) -> Tuple[_ChunkArgs, Tuple[torch.Tensor, ...]]:
    """The ``wkvbc::Args`` of one ``chunk`` call (r, k, v, dout of one dtype
    and log_w fp32, each with a contiguous last dimension; u fp32
    contiguous; ``grads`` the contiguous dr, dk, dv, dlog_w, du) and the
    scratch it allocates: keep both alive until the launch has run."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    chunks = -(-S // CHUNK)
    mk = lambda *s: torch.empty(s, dtype=torch.float32, device=r.device)
    scratch = (mk(B * h * chunks * Nk * Nv), mk(B * h * chunks * Nk * Nv),
               mk(B * h * chunks * Nk), mk(B * h * chunks * Nk),
               mk(B * h * chunks * Nk))
    streams = (r, k, v, log_w, dout)
    # 16-byte copies of the streams staged by cp.async (the fp32 ones)
    copied = [x for x in streams if x.dtype == torch.float32]
    vec = (Nk % 4 == 0 and Nv % 4 == 0
           and all(x.data_ptr() % 16 == 0
                   and all(st % 4 == 0 for st in x.stride()[:3])
                   for x in copied))
    strides = [(ctypes.c_int64 * 3)(*x.stride()[:3]) for x in streams]
    args = _ChunkArgs(*(x.data_ptr() for x in (r, k, v, log_w, u, dout)),
                      *(x.data_ptr() for x in grads),
                      *(x.data_ptr() for x in scratch),
                      *strides, B, S, h, Nk, Nv, int(vec))
    return args, scratch


def _launch_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                  ) -> Tuple[torch.Tensor, ...]:
    """One ``chunk`` call on the card: r, k, v, dout and log_w read in
    place (any strides of batch, time and head; the last dimension is
    copied only if it is not contiguous)."""
    B, S, h, Nk = r.shape
    r, k, v, dout = (x if x.stride(-1) == 1 else x.contiguous()
                     for x in (r, k, v, dout))
    lw32 = log_w if log_w.dtype == torch.float32 else log_w.float()
    lw32 = lw32 if lw32.stride(-1) == 1 else lw32.contiguous()
    u32 = u.to(torch.float32).contiguous()
    dev = r.device
    grads = (torch.empty(r.shape, dtype=r.dtype, device=dev),
             torch.empty(k.shape, dtype=k.dtype, device=dev),
             torch.empty(v.shape, dtype=v.dtype, device=dev),
             torch.empty(r.shape, dtype=torch.float32, device=dev),
             torch.empty((h, Nk), dtype=torch.float32, device=dev))
    if B * h == 0:
        return tuple(x.zero_() for x in grads)
    args, _scratch = chunk_args(r, k, v, lw32, u32, dout, grads)
    if _account(r, v, log_w, u, "chunk"):
        dr, dk, dv, dlw, du = grads
        return dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype)
    rc = _library().wkv_backward_chunked(_DTYPES[r.dtype],
                                         ctypes.addressof(args),
                                         _build.stream_handle())
    _build.check_launch(rc, "wkv_scan_backward (chunk)")
    LAUNCHES["wkv_scan_backward"] += 1
    ROUTE_CALLS["chunk"] += 1
    dr, dk, dv, dlw, du = grads
    return dr, dk, dv, dlw.to(log_w.dtype), du.to(u.dtype)
