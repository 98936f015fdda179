"""Public flash attention op: the port's ``repro/kernels/flash_attention/
ops.py``, in model layout.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernels (``csrc/flash_attention.cu``, ``csrc/flash_tc.cuh``,
``csrc/flash_tc_wide.cuh`` and ``csrc/flash_mma.cuh``, built at first use by
:mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it runs the
plain version :func:`.ref.attention_ref`.  There is no fallback from the
card to the CPU and no library attention.

On the card :func:`route` picks one of four kernels by dtype, shape,
alignment and window alone (never by a failure):

* ``split_kv`` — at most 16 (query, head) rows per (batch, kv head), which
  is decode, fp32 or bf16: one block per (batch, kv head, chunk of
  :func:`split_chunk` keys) writes a partial softmax to fp32 scratch, and a
  second kernel merges the partials in chunk order (bitwise repeatable).
* ``tensor_core`` — bf16 prefill with hd <= 128 and a multiple of 16 and
  16-byte aligned rows: ``wgmma`` bf16 products with fp32 accumulators.
* ``tensor_core_wide`` — bf16 prefill at hd 576 (MLA's absorbed width)
  with 16-byte aligned rows and no window: ``wgmma`` as above, 64 folded
  (position, head) rows a block and the output's columns split over two
  warpgroups.  When v is k (:func:`wide_key_tile`) one shared-memory tile
  of 64 keys serves as both, else K and V take 32-key tiles.
* ``mma_tf32`` — everything else: the fp32 prefill, and bf16 with hd not a
  multiple of 16, hd 129-575, a window over hd 128 or unaligned rows.
  ``mma.sync`` TF32 products with fp32 accumulators, an fp32 operand split
  into two TF32 parts (three products each: within a few fp32 roundoffs of
  fp32 products); its plain mirror is :func:`.ref.attention_mma_ref`.

Head dims up to ``MAX_HEAD_DIM`` = 576 run on the card (MLA's absorbed
attention works at kv_lora_rank + rope_head_dim = 576); a larger one
raises.

The JAX wrapper transposes to ``[B*KV, G, S, hd]`` and pads hd to 128
lanes and S to its block sizes for the TPU's tiling.  The kernel reads
q ``[B, Sq, H, hd]`` and k/v ``[B, Sk, KV, hd]`` in place through their
strides and needs no padding or block sizes.  Query positions and the
valid key count are runtime arguments (ints or tensors on the card), so a
decode step reuses the same launch for every position.

Under autograd (grad mode on and q, k or v requiring a gradient) a card
call goes through :class:`FlashAttentionFn`: its forward is the same
launch, its backward the hand-written backward kernel
(:mod:`.backward`).  Only q, k, v and the output are saved, so a
rematerialised layer recomputes the forward launch and nothing else.
Without autograd (serving, ``torch.no_grad``, ``torch.inference_mode``) the
launch is called directly, so the serving path pays nothing for the
``Function``.  A gradient through ``kv_valid`` is not implemented: it
raises.  On a CPU tensor the plain version is differentiable through
ordinary autograd.

Inside a dry run (:func:`repro_torch.kernels._card.dry_run`) a ``meta``
tensor takes the card's branch: :func:`_launch` picks the route the card
would take, allocates what the launch allocates (:func:`_outputs`: the
output and split-kv's partials) and launches nothing, under the same
``Function`` (the backward is :mod:`.backward`'s shape-only route).  A
card call and a dry-run call report their work to an active recorder
(:func:`repro_torch.kernels._card.account`): :func:`attention_work`, the
formula of the kernel's bound in ``PERF.md``.

``LAUNCHES`` counts wrapper calls that launched (one per call, whichever
route; ``split_kv`` runs two device kernels), ``ROUTE_CALLS`` the same calls
by route, ``PLAIN_CALLS`` calls that took the plain version (CPU tensors)
and ``DRY_CALLS`` a dry run's shape-only calls by route;
:func:`reset_launch_counts` zeroes all four.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import backward, ref
from .. import _build
from .._card import account, on_card

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}
ROUTES = ("tensor_core", "tensor_core_wide", "split_kv", "mma_tf32")
ROUTE_CALLS: Dict[str, int] = dict.fromkeys(ROUTES, 0)
DRY_CALLS: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes
MAX_HEAD_DIM = 576
TC_MAX_HEAD_DIM = 128       # the tensor-core route's widest instance
WIDE_HEAD_DIM = 576         # the wide tensor-core route's one instance
SPLIT_MAX_ROWS = 16         # (query, head) rows per (batch, kv head)
SPLIT_CHUNK = 64            # keys per split-kv chunk (kChunk of the source)


def split_chunk(dtype: torch.dtype, hd: int) -> int:
    """Keys per split-kv chunk of the kernel instance for ``hd`` (the
    source's ``split_chunk``): half of ``SPLIT_CHUNK`` for float32 above
    hd 256, whose 64-key chunk would not fit a block's shared memory."""
    return SPLIT_CHUNK // 2 if dtype == torch.float32 and hd > 256 \
        else SPLIT_CHUNK


# ``Args`` of csrc/flash_attention.cu, field by field in declaration order
# (struct codes, native alignment): every entry point takes it packed, and
# _library checks these offsets against the compiler's
ARGS_CODES = "PPPP" + "i" * 6 + "q" * 9 + "PiPiiiifiPP"
_ARGS = struct.Struct("@" + ARGS_CODES)


def args_offsets() -> list:
    """Byte offset of each field of the packed ``Args``."""
    return [struct.calcsize("@" + ARGS_CODES[:i] + "0" + c)
            for i, c in enumerate(ARGS_CODES)]


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0
    PLAIN_CALLS["flash_attention"] = 0
    for r in ROUTES:
        ROUTE_CALLS[r] = 0
    DRY_CALLS.clear()


def route(dtype: torch.dtype, Sq: int, H: int, KV: int, hd: int,
          vec: bool, window: Optional[int] = None) -> str:
    """The kernel a card call takes, by dtype, shape, alignment (``vec``:
    every row of q, k and v starts 16-byte aligned) and window alone."""
    if Sq * (H // KV) <= SPLIT_MAX_ROWS:
        return "split_kv"
    if dtype == torch.bfloat16 and vec:
        if hd % 16 == 0 and hd <= TC_MAX_HEAD_DIM:
            return "tensor_core"
        if hd == WIDE_HEAD_DIM and window is None:
            return "tensor_core_wide"
    return "mma_tf32"


def visible_pairs(Sq: int, q_offset: int, valid: int, causal: bool,
                  window: Optional[int]) -> Tuple[int, int]:
    """(query, key) pairs the masks keep for one (batch, head), queries at
    positions ``q_offset + i`` over ``valid`` keys, and the number of
    distinct keys any query sees: the work the data needs."""
    p = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(valid, p + 1) if causal else np.full_like(p, valid)
    lo = (np.maximum(0, p - window + 1) if window is not None
          else np.zeros_like(p))
    seen = hi > lo
    if not seen.any():
        return 0, 0
    return int((hi - lo)[seen].sum()), int(hi[seen].max() - lo[seen].min())


def same_data(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same elements (MLA passes its
    latent as k and as v): one storage, offset and strides."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset()
            and a.stride() == b.stride() and a.shape == b.shape)


def attention_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int], q_offset: int = 0,
                   kv_valid: Union[None, int, torch.Tensor] = None,
                   q_positions: Optional[torch.Tensor] = None,
                   backward: bool = False) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) of one call, the formula of its bound in
    ``PERF.md``: forward, 4 hd FLOPs a visible (query, key) pair and head,
    q read and the output written once, each key (and value, unless v is
    k) the queries see read once; backward (``backward``), 10 hd FLOPs a
    pair and head (S, dP, dV, dK, dQ) and q, k, v, dO, dQ, dK, dV and the
    output moved once.  Positions given as a tensor are read as the last
    Sq of the valid keys (a prefill from 0, a decode step at the cache's
    end: every model call), and a valid count given as a tensor as every
    key, since reading either would wait on the card."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    valid = (Sk if kv_valid is None or isinstance(kv_valid, torch.Tensor)
             else min(int(kv_valid), Sk))
    off = valid - Sq if q_positions is not None else int(q_offset)
    pairs, keys = visible_pairs(Sq, off, valid, causal, window)
    size = q.element_size()
    if backward:
        return (10.0 * hd * H * B * pairs,
                float(size * 4 * (q.numel() + k.numel())))
    n_kv = 1 if same_data(k, v) else 2
    return (4.0 * hd * H * B * pairs,
            float(size * (2 * q.numel() + n_kv * B * keys * KV * hd)))


# the entry point of each route that takes (dtype, args, stream)
_ENTRY = {"tensor_core": "fa_forward_tc",
          "tensor_core_wide": "fa_forward_tc_wide",
          "mma_tf32": "fa_forward_mma"}


def wide_key_tile(k: torch.Tensor, v: torch.Tensor) -> int:
    """Keys per tile of the wide tensor-core route for these k and v: 64
    when v is k (the same storage and strides, as MLA passes its latent
    cache), when one shared-memory tile serves as K and as V; else 32, so
    that separate K and V tiles fit the same stage."""
    same = v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    return 64 if same else 32


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention",
                              "flash_attention/csrc/flash_attention.cu")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in ((lib.fa_forward_mma, [i32, p, p]),
                         (lib.fa_forward_tc, [i32, p, p]),
                         (lib.fa_forward_tc_wide, [i32, p, p]),
                         (lib.fa_forward_split, [i32, p, i32, p]),
                         (lib.fa_args_offsets, [p, i32])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    want = args_offsets()
    got = (ctypes.c_int64 * len(want))()
    n = lib.fa_args_offsets(ctypes.addressof(got), len(want))
    if n != len(want) or list(got) != want:
        raise RuntimeError(f"flash_attention: Args layout of the library "
                           f"({n} fields, offsets {list(got)}) differs from "
                           f"the packed one ({want})")
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
    dev = q.device
    if not on_card(q):
        if dev.type != "cpu":
            raise ValueError(f"flash_attention: q must be on a CUDA device "
                             f"or the CPU, got {dev}")
        PLAIN_CALLS["flash_attention"] += 1
        pos = (q_positions if q_positions is not None
               else torch.arange(q_offset, q_offset + Sq))
        return ref.attention_ref(q, k, v, pos, kv_valid, causal=causal,
                                 window=window)
    return _card(q, k, v, causal=causal, window=window, q_offset=q_offset,
                 kv_valid=kv_valid, q_positions=q_positions)


def takes_function(*tensors: torch.Tensor) -> bool:
    """Whether a card call goes through the autograd ``Function``: grad
    mode is on and some input requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, window: Optional[int], q_offset: int,
          kv_valid: Union[None, int, torch.Tensor],
          q_positions: Optional[torch.Tensor]) -> torch.Tensor:
    """A card call: :class:`FlashAttentionFn` under autograd, else the
    launch itself."""
    if takes_function(q, k, v):
        if kv_valid is not None:
            raise NotImplementedError(
                "flash_attention: no gradient through kv_valid (a KV "
                "cache); call it under torch.no_grad() or without kv_valid")
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      q_positions)
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   kv_valid=kv_valid, q_positions=q_positions)


class FlashAttentionFn(torch.autograd.Function):
    """The card's differentiable flash attention (every key valid): the
    forward kernels, then :func:`.backward.flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_positions):
        out = _launch(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, kv_valid=None,
                      q_positions=q_positions)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, window, q_offset, q_positions)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, window, q_offset, q_positions = ctx.args
        dq, dk, dv = backward.flash_attention_backward(
            q, k, v, out, dout, causal=causal, window=window,
            q_offset=q_offset, q_positions=q_positions)
        return dq, dk, dv, None, None, None, None


def _outputs(q: torch.Tensor, Sk: int, way: str
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """What a forward launch on route ``way`` allocates: the output, and on
    ``split_kv`` the fp32 partials of its chunks (``[rows, hd]`` then
    ``(m, l)`` a row) and their count."""
    B, Sq, H, hd = q.shape
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if way != "split_kv" or out.numel() == 0:
        return out, None, 0
    n_chunks = max(-(-Sk // split_chunk(q.dtype, hd)), 1)
    rows = n_chunks * B * Sq * H
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
    return out, part, n_chunks


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int], q_offset: int,
            kv_valid: Union[None, int, torch.Tensor],
            q_positions: Optional[torch.Tensor]) -> torch.Tensor:
    """One forward launch on the card (see :func:`flash_attention`); on a
    dry run's ``meta`` tensors its shape-only form."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dev = q.device
    if not on_card(q) or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q, k, v must share one CUDA "
                         f"device (or the CPU), got {dev}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16 on the card, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM} "
                         f"is not supported by the kernel")
    # the kernel takes any strides but a unit stride along hd
    if q.stride(3) != 1:
        q = q.contiguous()
    if k.stride(3) != 1:
        k = k.contiguous()
    if v.stride(3) != 1:
        v = v.contiguous()
    pos_ptr, valid_ptr, valid_n = None, None, Sk
    if q_positions is not None:
        q_positions = _int32_on(q_positions, dev, (Sq,))
        pos_ptr = q_positions.data_ptr()
    if isinstance(kv_valid, torch.Tensor):
        kv_valid = _int32_on(kv_valid, dev, (B,))
        valid_ptr = kv_valid.data_ptr()
    elif kv_valid is not None:
        valid_n = int(kv_valid)
    # 16-byte loads when every row of q, k, v starts 16-byte aligned (a
    # meta tensor's rows count as aligned)
    per16 = 16 // q.element_size()
    strides = q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
    vec = (hd % per16 == 0
           and all(x.data_ptr() % 16 == 0 for x in (q, k, v))
           and all(st % per16 == 0 for st in strides))
    way = route(q.dtype, Sq, H, KV, hd, vec, window)
    out, part, n_chunks = _outputs(q, Sk, way)
    if out.numel() == 0:
        return out
    if account("flash_attention", DRY_CALLS, way, q,
               lambda: attention_work(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, kv_valid=kv_valid,
                                      q_positions=q_positions)):
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    lib = _library()
    stream = _build.stream_handle()
    scalars = (B, Sq, Sk, H, KV, hd, *strides, pos_ptr or 0, int(q_offset),
               valid_ptr or 0, valid_n, int(bool(causal)),
               int(window is not None), int(window or 0), hd ** -0.5,
               int(vec))
    ml_ptr = acc_ptr = 0
    if part is not None:
        # each chunk's partial per output row: acc [rows, hd], then (m, l)
        acc_ptr = part.data_ptr()
        ml_ptr = acc_ptr + 4 * (part.numel() // (hd + 2)) * hd
    block = ctypes.create_string_buffer(_ARGS.size)
    _ARGS.pack_into(block, 0, *ptrs, *scalars, ml_ptr, acc_ptr)
    args = ctypes.addressof(block)
    if way == "split_kv":
        rc = lib.fa_forward_split(_DTYPES[q.dtype], args, n_chunks, stream)
    else:
        rc = getattr(lib, _ENTRY[way])(_DTYPES[q.dtype], args, stream)
    _build.check_launch(rc, f"flash_attention ({way})")
    LAUNCHES["flash_attention"] += 1
    ROUTE_CALLS[way] += 1
    return out
