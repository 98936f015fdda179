"""Public WKV scan op: the port's ``repro/kernels/rwkv_scan/ops.py``, in
model layout.

On a CUDA tensor :func:`wkv_scan` launches one of the hand-written Hopper
kernels (``csrc/wkv_scan.cu`` with ``csrc/wkv_chunk.cuh`` and
``csrc/wkv_chunk_f32.cuh``, built at first use by
:mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the
plain chunked recurrence (:func:`repro_torch.models.linrec.
chunked_linear_recurrence`).  There is no fallback from the card to the
CPU, and none from one route to another.

On the card :func:`route` picks the kernel by dtype and shape alone:

* ``tensor_core`` — bf16 r, k, v (log_w fp32 or bf16) with Nk = Nv = 64
  and S >= ``TC_MIN_SEQ``: chunks of ``TC_CHUNK`` steps, factored into
  sub-chunks of ``TC_SUB`` and then ``TC_LEAF`` steps so that the products
  between them are TF32 tensor-core products (fp32 accumulators); plain
  version :func:`.ref.wkv_subchunk_ref`.
* ``chunk_f32`` — fp32 r, k, v, log_w with Nk <= ``CHUNK_ROUTE_MAX_NK``,
  Nv <= ``CHUNK_MAX_N`` and S >= ``CHUNK_MIN_SEQ``: chunks of
  ``CHUNK_F32`` steps in three kernels (each chunk's state, the scan over
  chunks, the outputs), fp32 FMAs on the CUDA cores; plain version
  :func:`.ref.wkv_chunk_f32_ref`.  :func:`inclusive_scan` runs the same
  kernels in the recurrence's inclusive mode (Hymba's SSM) at Nk <=
  ``CHUNK_MAX_N``.  At RWKV6's Nk 64 the step kernel is faster (one block
  of these an SM; PERF.md), so fp32 at Nk 64 stays there.
* ``step`` — everything else (decode's S = 1, bf16 off the tensor-core
  shapes, fp32 at Nk 64, wider heads): the state in registers, time
  walked step by step.

All read ``[B, S, h, N]`` in place and need no padding (the ragged last
chunk is masked in the kernel; ``chunk_f32`` also reads strided views);
the JAX wrapper transposes to ``[B*h, S, N]`` and pads S for the Pallas
grid.  ``chunk`` only sets the CPU plain version's chunk length.

Under autograd (grad mode on and r, k, v, log_w or u requiring a gradient)
a card call goes through :class:`WkvScanFn`: its forward is the same
launch, its backward the hand-written backward kernel (:mod:`.backward`).
Without autograd (serving, ``torch.no_grad``, ``torch.inference_mode``) the
launch is called directly.  A gradient into ``initial_state`` or out of the
final state is not implemented: the first raises when the call is made,
the second when the backward reaches it.  On a CPU tensor the plain version
is differentiable through ordinary autograd.

Inside a dry run (:func:`repro_torch.kernels._card.dry_run`) a ``meta``
tensor takes the card's branch: the route the card would take, the
allocations the launch makes (its output, final state and, on
``chunk_f32``, its scratch) and no launch, under the same ``Function``
(the backward is :mod:`.backward`'s shape-only route).  A card call and
a dry-run call report their work to an active recorder
(:func:`scan_work`, the formula of the kernel's bound in ``PERF.md``).

``LAUNCHES`` counts kernel launches (one per call, whichever route;
``chunk_f32``'s three kernels are one call),
``ROUTE_CALLS`` the same calls by route, ``PLAIN_CALLS`` calls that
took the plain version (CPU tensors) and ``DRY_CALLS`` a dry run's
shape-only calls by route; :func:`reset_launch_counts` zeroes all four.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional, Tuple

import torch

from . import backward
from .. import _build
from .._card import account, on_card
from ...models.linrec import chunked_linear_recurrence

LAUNCHES: Dict[str, int] = {"wkv_scan": 0}
PLAIN_CALLS: Dict[str, int] = {"wkv_scan": 0}
ROUTES = ("tensor_core", "chunk_f32", "step")
ROUTE_CALLS: Dict[str, int] = dict.fromkeys(ROUTES, 0)
DRY_CALLS: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes
MAX_NK, MAX_NV = 128, 256
TC_WIDTH = 64               # Nk = Nv of the tensor-core instance
TC_MIN_SEQ = 16             # one sub-chunk (kMinT of csrc/wkv_chunk.cuh)
TC_CHUNK = 32               # steps a chunk (kC)
TC_SUB = 16                 # steps a sub-chunk (kL)
TC_LEAF = 8                 # rows of the directly computed diagonal blocks
CHUNK_F32 = 64              # steps a chunk of chunk_f32 (kC of
                            # csrc/wkv_chunk_f32.cuh)
CHUNK_MIN_SEQ = 16          # shortest sequence chunk_f32 takes (kMinT)
CHUNK_MAX_N = 64            # widest Nk and Nv it takes
CHUNK_ROUTE_MAX_NK = 32     # widest Nk wkv_scan routes to it


def reset_launch_counts() -> None:
    LAUNCHES["wkv_scan"] = 0
    PLAIN_CALLS["wkv_scan"] = 0
    for r in ROUTES:
        ROUTE_CALLS[r] = 0
    DRY_CALLS.clear()


def route(dtype: torch.dtype, S: int, Nk: int, Nv: int) -> str:
    """The kernel a card call takes, by the dtype of r, k, v and the shape
    alone."""
    if (dtype == torch.bfloat16 and Nk == Nv == TC_WIDTH
            and S >= TC_MIN_SEQ):
        return "tensor_core"
    if (dtype == torch.float32 and S >= CHUNK_MIN_SEQ
            and Nk <= CHUNK_ROUTE_MAX_NK and Nv <= CHUNK_MAX_N):
        return "chunk_f32"
    return "step"


def scan_work(r: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
              inclusive: bool = False) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) of one forward call, the formula of its bound in
    ``PERF.md``: 7 FLOPs a (step, i, j) (the k v product, the bonus and
    read FMAs, the decay FMA); r (q), k and v read and the output written
    once in their dtype, log_w read once in its own, the fp32 state read
    and written once, and in the rwkv mode the fp32 bonus u read."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    n_in = B * S * h
    nbytes = (r.element_size() * n_in * (2 * Nk + 2 * Nv)
              + log_w.element_size() * n_in * Nk + 8 * B * h * Nk * Nv)
    if not inclusive:
        nbytes += 4 * h * Nk
    return 7.0 * n_in * Nk * Nv, float(nbytes)


class _ChunkArgs(ctypes.Structure):
    """``wkvf32::Args`` of csrc/wkv_chunk_f32.cuh, field by field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "lw", "u", "s0", "out", "sT", "states",
                  "decay")]
                + [(n, ctypes.c_int64 * 3) for n in ("sq", "sk", "sv", "sw")]
                + [(n, ctypes.c_int) for n in ("B", "T", "H", "nk", "nv",
                                                "vec")])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("wkv_scan", "rwkv_scan/csrc/wkv_scan.cu")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv_forward.argtypes = [i32, i32] + [p] * 8 + [i32] * 5 + [p]
    lib.wkv_forward.restype = ctypes.c_int
    lib.wkv_forward_tc.argtypes = [i32] + [p] * 8 + [i32] * 5 + [p]
    lib.wkv_forward_tc.restype = ctypes.c_int
    lib.wkv_tc_blocks_per_sm.argtypes = [i32]
    lib.wkv_forward_chunk_f32.argtypes = [i32, p, p]
    lib.wkv_chunk_f32_occupancy.argtypes = [i32, p]
    lib.wkv_chunk_f32_occupancy.restype = None
    for fn in (lib.wkv_tc_smem_bytes, lib.wkv_tc_blocks_per_sm,
               lib.wkv_forward_chunk_f32, lib.wkv_chunk_f32_args_size,
               lib.wkv_chunk_f32_chunk):
        fn.restype = ctypes.c_int
    if (lib.wkv_chunk_f32_args_size() != ctypes.sizeof(_ChunkArgs)
            or lib.wkv_chunk_f32_chunk() != CHUNK_F32):
        raise RuntimeError(f"wkv_scan: the library's chunk_f32 Args "
                           f"({lib.wkv_chunk_f32_args_size()} bytes) or "
                           f"chunk ({lib.wkv_chunk_f32_chunk()}) differ "
                           f"from ops.py's ({ctypes.sizeof(_ChunkArgs)}, "
                           f"{CHUNK_F32})")
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


def chunk_f32_occupancy(Nk: int) -> Tuple[int, int, int, int]:
    """(shared memory bytes a block, blocks an SM) of chunk_f32's state
    kernel, then of its output kernel, at Nk's instance, as the card's
    runtime reports them."""
    out = (ctypes.c_int * 4)()
    _library().wkv_chunk_f32_occupancy(Nk, out)
    return tuple(out)


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
    if not on_card(r):
        _plain_only(r, "wkv_scan")
        PLAIN_CALLS["wkv_scan"] += 1
        out, sT = chunked_linear_recurrence(
            r, k, v, log_w, u=u, initial_state=initial_state, mode="rwkv",
            chunk=chunk, return_state=True)
        return out, sT
    return _card(r, k, v, log_w, u, initial_state)


def inclusive_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None, *,
                   chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's inclusive mode, out_t = q_t^T S_t with S_t =
    diag(exp log_w_t) S_{t-1} + k_t v_t^T (Hymba's SSM), in model layout:
    q, k, log_w [B, S, h, Nk], v [B, S, h, Nv], initial_state [B, h, Nk,
    Nv] (zeros if None).  Returns (out [B, S, h, Nv] in q's dtype, final
    state [B, h, Nk, Nv] fp32).

    On a CUDA tensor one call of the ``chunk_f32`` kernels in inclusive
    mode (fp32 streams, Nk, Nv <= ``CHUNK_MAX_N``; no gradient: under
    autograd it raises), else it raises; on a CPU tensor the plain chunked
    recurrence (``chunk`` its chunk length)."""
    B, S, h, Nk = q.shape
    if k.shape != q.shape or log_w.shape != q.shape \
            or v.shape[:3] != (B, S, h):
        raise ValueError(f"inclusive_scan: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_w "
                         f"{tuple(log_w.shape)} do not fit [B, S, h, N]")
    if not on_card(q):
        _plain_only(q, "inclusive_scan")
        PLAIN_CALLS["wkv_scan"] += 1
        out, sT = chunked_linear_recurrence(
            q, k, v, log_w, initial_state=initial_state, mode="inclusive",
            chunk=chunk, return_state=True)
        return out, sT
    state = () if initial_state is None else (initial_state,)
    if takes_function(q, k, v, log_w, *state):
        raise NotImplementedError(
            "inclusive_scan: no gradient on the card; take wkv_scan's "
            "identity (models/ssm.py) under autograd")
    return _launch_chunk(q, k, v, log_w, None, initial_state, True)


def _plain_only(x: torch.Tensor, op: str) -> None:
    """A call off the card runs the plain version on the CPU only."""
    if x.device.type != "cpu":
        raise ValueError(f"{op}: tensors must be on a CUDA device or the "
                         f"CPU, got {x.device}")


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
    """One forward launch on the card (see :func:`wkv_scan`); on a dry
    run's ``meta`` tensors its shape-only form."""
    B, S, h, Nk = r.shape
    Nv = v.shape[-1]
    tensors = (r, k, v, log_w, u) + (() if initial_state is None
                                     else (initial_state,))
    if not on_card(r) or any(x.device != r.device for x in tensors):
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
    if way == "chunk_f32":
        return _launch_chunk(r, k, v, log_w, u, initial_state, False)
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
    if account("wkv_scan", DRY_CALLS, way, r,
               lambda: scan_work(r, v, log_w)):
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


def _launch_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: Optional[torch.Tensor],
                  initial_state: Optional[torch.Tensor], inclusive: bool,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``chunk_f32`` call on the card: mode 'inclusive', or mode 'rwkv'
    with the bonus u.  q, k, v, log_w are read in place (any strides of
    batch, time and head; the last dimension is copied only if it is not
    contiguous)."""
    B, S, h, Nk = q.shape
    Nv = v.shape[-1]
    tensors = (q, k, v, log_w) + tuple(x for x in (u, initial_state)
                                       if x is not None)
    if not on_card(q) or any(x.device != q.device for x in tensors):
        raise ValueError("wkv_scan: all tensors must share one CUDA device "
                         "(or the CPU)")
    if any(x.dtype != torch.float32 for x in (q, k, v, log_w)):
        raise TypeError(f"wkv_scan chunk_f32: q (r), k, v and log_w must be "
                        f"float32, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{log_w.dtype}")
    if Nk > CHUNK_MAX_N or Nv > CHUNK_MAX_N:
        raise ValueError(f"wkv_scan chunk_f32: Nk {Nk} or Nv {Nv} > "
                         f"{CHUNK_MAX_N}")
    q, k, v, log_w = (x if x.stride(-1) == 1 else x.contiguous()
                      for x in (q, k, v, log_w))
    u32 = None if u is None else u.to(torch.float32).contiguous()
    s0 = (None if initial_state is None
          else initial_state.to(torch.float32).contiguous())
    dev = q.device
    out = torch.empty((B, S, h, Nv), dtype=torch.float32, device=dev)
    if B * h == 0 or S == 0:
        sT = (torch.zeros((B, h, Nk, Nv), dtype=torch.float32, device=dev)
              if s0 is None else s0.clone())
        return out, sT
    sT = torch.empty((B, h, Nk, Nv), dtype=torch.float32, device=dev)
    args, _scratch = chunk_f32_args(q, k, v, log_w, u32, s0, out, sT)
    if account("wkv_scan", DRY_CALLS, "chunk_f32", q,
               lambda: scan_work(q, v, log_w, inclusive)):
        return out, sT
    rc = _library().wkv_forward_chunk_f32(int(inclusive),
                                          ctypes.addressof(args),
                                          _build.stream_handle())
    _build.check_launch(rc, "wkv_scan (chunk_f32)")
    LAUNCHES["wkv_scan"] += 1
    ROUTE_CALLS["chunk_f32"] += 1
    return out, sT


def chunk_f32_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: Optional[torch.Tensor],
                   s0: Optional[torch.Tensor], out: torch.Tensor,
                   sT: torch.Tensor, chunk: int = CHUNK_F32,
                   ) -> Tuple[_ChunkArgs, Tuple[torch.Tensor, ...]]:
    """The ``wkvf32::Args`` of one ``chunk_f32`` call (fp32 tensors on one
    card; q, k, v, log_w with a contiguous last dimension, u, s0, out and
    sT contiguous) and the scratch it allocates, ``chunk`` steps a chunk:
    keep both alive until the launch has run."""
    B, S, h, Nk = q.shape
    Nv = v.shape[-1]
    chunks = -(-S // chunk)
    states = torch.empty(B * h * chunks * Nk * Nv, dtype=torch.float32,
                         device=q.device)
    decay = torch.empty(B * h * chunks * Nk, dtype=torch.float32,
                        device=q.device)
    streams = (q, k, v, log_w)
    vec = (Nk % 4 == 0 and Nv % 4 == 0
           and all(x.data_ptr() % 16 == 0
                   and all(st % 4 == 0 for st in x.stride()[:3])
                   for x in streams))
    ptr = lambda x: None if x is None else x.data_ptr()
    strides = [(ctypes.c_int64 * 3)(*x.stride()[:3]) for x in streams]
    args = _ChunkArgs(*(ptr(x) for x in (q, k, v, log_w, u, s0, out, sT,
                                         states, decay)),
                      *strides, B, S, h, Nk, Nv, int(vec))
    return args, (states, decay)
