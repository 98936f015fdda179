"""Public WKV scan op: the port's ``repro/kernels/rwkv_scan/ops.py``, in
model layout.

On a CUDA tensor :func:`wkv_scan` launches one of the hand-written Hopper
kernels (``csrc/wkv_scan.cu`` with ``csrc/wkv_chunk.cuh``, built at first
use by :mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it
runs the plain chunked recurrence (:func:`repro_torch.models.linrec.
chunked_linear_recurrence`).  There is no fallback from the card to the
CPU, and none from one route to the other.

On the card :func:`route` picks the kernel by dtype and shape alone:

* ``tensor_core`` — bf16 r, k, v (log_w fp32 or bf16) with Nk = Nv = 64
  and S >= ``TC_MIN_SEQ``: chunks of ``TC_CHUNK`` steps, factored into
  sub-chunks of ``TC_SUB`` and then ``TC_LEAF`` steps so that the products
  between them are TF32 tensor-core products (fp32 accumulators); plain
  version :func:`.ref.wkv_subchunk_ref`.
* ``step`` — everything else (fp32 streams, whose tolerance no TF32
  product meets; decode's S = 1; other head widths): the state in
  registers, time walked step by step.

Both read ``[B, S, h, N]`` in place and need no padding (the ragged last
chunk is masked in the kernel); the JAX wrapper transposes to ``[B*h, S,
N]`` and pads S for the Pallas grid.  ``chunk`` only sets the CPU plain
version's chunk length.

Under autograd (grad mode on and r, k, v, log_w or u requiring a gradient)
a card call goes through :class:`WkvScanFn`: its forward is the same
launch, its backward the hand-written backward kernel (:mod:`.backward`).
Without autograd (serving, ``torch.no_grad``, ``torch.inference_mode``) the
launch is called directly.  A gradient into ``initial_state`` or out of the
final state is not implemented: the first raises when the call is made,
the second when the backward reaches it.  On a CPU tensor the plain version
is differentiable through ordinary autograd.

``LAUNCHES`` counts kernel launches (one per call, whichever route),
``ROUTE_CALLS`` the same calls by route, and ``PLAIN_CALLS`` calls that
took the plain version (CPU tensors); :func:`reset_launch_counts` zeroes
all three.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional, Tuple

import torch

from . import backward
from .. import _build
from ...models.linrec import chunked_linear_recurrence

LAUNCHES: Dict[str, int] = {"wkv_scan": 0}
PLAIN_CALLS: Dict[str, int] = {"wkv_scan": 0}
ROUTES = ("tensor_core", "step")
ROUTE_CALLS: Dict[str, int] = dict.fromkeys(ROUTES, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes
MAX_NK, MAX_NV = 128, 256
TC_WIDTH = 64               # Nk = Nv of the tensor-core instance
TC_MIN_SEQ = 16             # one sub-chunk (kMinT of csrc/wkv_chunk.cuh)
TC_CHUNK = 32               # steps a chunk (kC)
TC_SUB = 16                 # steps a sub-chunk (kL)
TC_LEAF = 8                 # rows of the directly computed diagonal blocks


def reset_launch_counts() -> None:
    LAUNCHES["wkv_scan"] = 0
    PLAIN_CALLS["wkv_scan"] = 0
    for r in ROUTES:
        ROUTE_CALLS[r] = 0


def route(dtype: torch.dtype, S: int, Nk: int, Nv: int) -> str:
    """The kernel a card call takes, by the dtype of r, k, v and the shape
    alone."""
    if (dtype == torch.bfloat16 and Nk == Nv == TC_WIDTH
            and S >= TC_MIN_SEQ):
        return "tensor_core"
    return "step"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("wkv_scan", "rwkv_scan/csrc/wkv_scan.cu")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv_forward.argtypes = [i32, i32] + [p] * 8 + [i32] * 5 + [p]
    lib.wkv_forward.restype = ctypes.c_int
    lib.wkv_forward_tc.argtypes = [i32] + [p] * 8 + [i32] * 5 + [p]
    lib.wkv_forward_tc.restype = ctypes.c_int
    lib.wkv_tc_blocks_per_sm.argtypes = [i32]
    for fn in (lib.wkv_tc_smem_bytes, lib.wkv_tc_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def build() -> float:
    """Build (or load) the kernel now; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def tc_occupancy() -> Tuple[int, int]:
    """(shared memory bytes a block, blocks an SM) of the tensor-core
    kernel with fp32 log_w, as the card's runtime reports them."""
    lib = _library()
    return lib.wkv_tc_smem_bytes(), lib.wkv_tc_blocks_per_sm(
        _DTYPES[torch.float32])


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte aligned start (the tensor-core kernel's
    cp.async copies): a view that starts off 16 bytes is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor,
             initial_state: Optional[torch.Tensor] = None, *,
             chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: r, k, log_w [B, S, h, Nk]; v [B, S, h, Nv]; u [h, Nk];
    initial_state [B, h, Nk, Nv] (zeros if None).
    Returns (out [B, S, h, Nv] in r's dtype, final_state [B, h, Nk, Nv]
    fp32)."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    if k.shape != r.shape or log_w.shape != r.shape \
            or v.shape[:3] != (B, S, h) or tuple(u.shape) != (h, Nk):
        raise ValueError(f"wkv_scan: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, log_w {tuple(log_w.shape)}, "
                         f"u {tuple(u.shape)} do not fit [B, S, h, N]")
    if r.device.type == "cpu":
        PLAIN_CALLS["wkv_scan"] += 1
        out, sT = chunked_linear_recurrence(
            r, k, v, log_w, u=u, initial_state=initial_state, mode="rwkv",
            chunk=chunk, return_state=True)
        return out, sT
    return _card(r, k, v, log_w, u, initial_state)


def takes_function(*tensors: torch.Tensor) -> bool:
    """Whether a card call goes through the autograd ``Function``: grad
    mode is on and some input requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _card(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor,
          initial_state: Optional[torch.Tensor],
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A card call: :class:`WkvScanFn` under autograd, else the launch
    itself."""
    if takes_function(r, k, v, log_w, u, *(() if initial_state is None
                                           else (initial_state,))):
        if initial_state is not None:
            raise NotImplementedError(
                "wkv_scan: no gradient with an initial state (streaming "
                "state); call it under torch.no_grad() or without one")
        return WkvScanFn.apply(r, k, v, log_w, u)
    return _launch(r, k, v, log_w, u, initial_state)


class WkvScanFn(torch.autograd.Function):
    """The card's differentiable WKV scan (zero initial state): the forward
    kernels, then :func:`.backward.wkv_scan_backward`.  A gradient reaching
    the final state raises."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u):
        ctx.set_materialize_grads(False)
        out, sT = _launch(r, k, v, log_w, u, None)
        ctx.save_for_backward(r, k, v, log_w, u)
        return out, sT

    @staticmethod
    def backward(ctx, dout, dsT):
        if dsT is not None:
            raise NotImplementedError(
                "wkv_scan: no gradient out of the final state")
        if dout is None:
            return None, None, None, None, None
        r, k, v, log_w, u = ctx.saved_tensors
        return backward.wkv_scan_backward(r, k, v, log_w, u, dout)


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_w: torch.Tensor, u: torch.Tensor,
            initial_state: Optional[torch.Tensor],
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on the card (see :func:`wkv_scan`)."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    tensors = (r, k, v, log_w, u) + (() if initial_state is None
                                     else (initial_state,))
    if r.device.type != "cuda" or any(x.device != r.device for x in tensors):
        raise ValueError("wkv_scan: all tensors must share one CUDA device "
                         "(or the CPU)")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or log_w.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"wkv_scan: r, k, v must share float32 or bfloat16 "
                        f"and log_w be float32 or theirs, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}, {log_w.dtype}")
    if Nk > MAX_NK or Nv > MAX_NV:
        raise ValueError(f"wkv_scan: Nk {Nk} > {MAX_NK} or Nv {Nv} > "
                         f"{MAX_NV} is not supported by the kernel")
    way = route(r.dtype, S, Nk, Nv)
    if way == "tensor_core":
        r, k, v, log_w = (_aligned(x) for x in (r, k, v, log_w))
    else:
        r, k, v, log_w = (x.contiguous() for x in (r, k, v, log_w))
    u32 = u.to(torch.float32).contiguous()
    s0 = (None if initial_state is None
          else initial_state.to(torch.float32).contiguous())
    out = torch.empty((B, S, h, Nv), dtype=r.dtype, device=r.device)
    sT = torch.empty((B, h, Nk, Nv), dtype=torch.float32, device=r.device)
    if B * h == 0:
        return out, sT
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u32.data_ptr(), None if s0 is None else s0.data_ptr(),
            out.data_ptr(), sT.data_ptr(), B, S, h, Nk, Nv,
            _build.stream_handle())
    if way == "tensor_core":
        rc = _library().wkv_forward_tc(_DTYPES[log_w.dtype], *ptrs)
    else:
        rc = _library().wkv_forward(_DTYPES[r.dtype], _DTYPES[log_w.dtype],
                                    *ptrs)
    _build.check_launch(rc, f"wkv_scan ({way})")
    LAUNCHES["wkv_scan"] += 1
    ROUTE_CALLS[way] += 1
    return out, sT
