"""Public flash attention op: the port's ``repro/kernels/flash_attention/
ops.py``, in model layout.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernels (``csrc/flash_attention.cu`` and ``csrc/flash_tc.cuh``, built at
first use by :mod:`repro_torch.kernels._build`) or raises; on a CPU tensor
it runs the plain version :func:`.ref.attention_ref`.  There is no fallback
from the card to the CPU and no library attention.

On the card :func:`route` picks one of three kernels by dtype and shape
alone (never by a failure):

* ``split_kv`` — at most 16 (query, head) rows per (batch, kv head), which
  is decode, fp32 or bf16: one block per (batch, kv head, chunk of
  :func:`split_chunk` keys) writes a partial softmax to fp32 scratch, and a
  second kernel merges the partials in chunk order (bitwise repeatable).
* ``tensor_core`` — bf16 prefill with hd <= 128 and a multiple of 16 and
  16-byte aligned rows: ``wgmma`` bf16 products with fp32 accumulators.
* ``cuda_core`` — everything else: fp32 prefill (full fp32 products), hd
  not a multiple of 16 or over 128, unaligned rows.

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

``LAUNCHES`` counts wrapper calls that launched (one per call, whichever
route; ``split_kv`` runs two device kernels), ``ROUTE_CALLS`` the same calls
by route, and ``PLAIN_CALLS`` calls that took the plain version (CPU
tensors); :func:`reset_launch_counts` zeroes all three.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import time
from typing import Dict, Optional, Union

import torch

from . import backward, ref
from .. import _build

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}
ROUTES = ("tensor_core", "split_kv", "cuda_core")
ROUTE_CALLS: Dict[str, int] = dict.fromkeys(ROUTES, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}          # csrc dtype codes
MAX_HEAD_DIM = 576
TC_MAX_HEAD_DIM = 128       # the tensor-core route's widest instance
SPLIT_MAX_ROWS = 16         # (query, head) rows per (batch, kv head)
SPLIT_CHUNK = 64            # keys per split-kv chunk (kChunk of the source)


def split_chunk(dtype: torch.dtype, hd: int) -> int:
    """Keys per split-kv chunk of the kernel instance for ``hd`` (the
    source's ``split_chunk``): half of ``SPLIT_CHUNK`` for float32 above
    hd 256, whose 64-key chunk would not fit a block's shared memory."""
    return SPLIT_CHUNK // 2 if dtype == torch.float32 and hd > 256 \
        else SPLIT_CHUNK


# ``Args`` of csrc/flash_attention.cu, field by field in declaration order
# (struct codes, native alignment): the tensor-core and split-kv entry
# points take it packed, and _library checks these offsets against the
# compiler's
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


def route(dtype: torch.dtype, Sq: int, H: int, KV: int, hd: int,
          vec: bool) -> str:
    """The kernel a card call takes, by dtype and shape alone."""
    if Sq * (H // KV) <= SPLIT_MAX_ROWS:
        return "split_kv"
    if (dtype == torch.bfloat16 and hd % 16 == 0 and hd <= TC_MAX_HEAD_DIM
            and vec):
        return "tensor_core"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention",
                              "flash_attention/csrc/flash_attention.cu")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    args = ([i32, p, p, p, p] + [i32] * 6 + [i64] * 9
            + [p, i32, p, i32, i32, i32, i32, ctypes.c_float, i32, p])
    for fn, argtypes in ((lib.fa_forward, args),
                         (lib.fa_forward_tc, [i32, p, p]),
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
    if dev.type == "cpu":
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int], q_offset: int,
            kv_valid: Union[None, int, torch.Tensor],
            q_positions: Optional[torch.Tensor]) -> torch.Tensor:
    """One forward launch on the card (see :func:`flash_attention`)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
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
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    # 16-byte loads when every row of q, k, v starts 16-byte aligned
    per16 = 16 // q.element_size()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
    vec = (hd % per16 == 0 and all(p % 16 == 0 for p in ptrs[:3])
           and all(st % per16 == 0 for st in strides))
    way = route(q.dtype, Sq, H, KV, hd, vec)
    lib = _library()
    stream = _build.stream_handle()
    scalars = (B, Sq, Sk, H, KV, hd, *strides, pos_ptr or 0, int(q_offset),
               valid_ptr or 0, valid_n, int(bool(causal)),
               int(window is not None), int(window or 0), hd ** -0.5,
               int(vec))
    if way == "cuda_core":
        rc = lib.fa_forward(_DTYPES[q.dtype], *ptrs, *scalars, stream)
    else:
        ml_ptr = acc_ptr = 0
        if way == "split_kv":
            n_chunks = max(-(-Sk // split_chunk(q.dtype, hd)), 1)
            rows = n_chunks * B * Sq * H
            # each chunk's partial per output row: acc [rows, hd], (m, l)
            part = torch.empty(rows * (hd + 2), dtype=torch.float32,
                               device=dev)
            acc_ptr = part.data_ptr()
            ml_ptr = acc_ptr + 4 * rows * hd
        block = ctypes.create_string_buffer(_ARGS.size)
        _ARGS.pack_into(block, 0, *ptrs, *scalars, ml_ptr, acc_ptr)
        if way == "split_kv":
            rc = lib.fa_forward_split(_DTYPES[q.dtype],
                                      ctypes.addressof(block), n_chunks,
                                      stream)
        else:
            rc = lib.fa_forward_tc(_DTYPES[q.dtype],
                                   ctypes.addressof(block), stream)
    _build.check_launch(rc, f"flash_attention ({way})")
    LAUNCHES["flash_attention"] += 1
    ROUTE_CALLS[way] += 1
    return out
