"""Public coded-combine ops: the port's counterparts of
``repro/kernels/coded_combine/ops.py``, name for name.

On a CUDA tensor each op launches its hand-written Hopper kernel
(``csrc/coded_combine.cu``, which includes the XOR kernel of
``csrc/xor_stream.cuh``; built at first use by
:mod:`repro_torch.kernels._build`) or raises; on a CPU tensor it uses the
plain version in :mod:`.ref`.  Nothing else selects the path: there is no
fallback from the card to the CPU, and no PyTorch op computes the result
on the card.

The JAX wrappers pad to 128 lanes and to ``block_t`` rows for the TPU's
tiling; the kernels here are elementwise over the flattened streams and
need no padding.  ``block_t`` is accepted so call sites keep the JAX
signatures, and is ignored.

Inside a dry run (:func:`repro_torch.kernels._card.dry_run`) a ``meta``
tensor takes the card's branch: the op allocates its output and launches
nothing.  A card call and a dry-run call report their work to an active
recorder (:func:`combine_work`: the bytes of their bound in ``PERF.md``).

``LAUNCHES`` counts kernel launches per op (CPU calls do not count),
``DRY_CALLS`` a dry run's shape-only calls per op;
:func:`reset_launch_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Sequence, Tuple, Union

import torch

from . import ref
from .. import _build
from .._card import account, on_card

Streams = Union[torch.Tensor, Sequence[torch.Tensor]]

LAUNCHES: Dict[str, int] = {"coded_encode": 0, "coded_decode": 0,
                            "xor_encode": 0, "xor_decode": 0}
DRY_CALLS: Dict[str, int] = {}

_LINEAR_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc dtype codes
_XOR_DTYPES = (torch.int32, torch.uint32)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    DRY_CALLS.clear()


def combine_work(n_streams: int, out: torch.Tensor) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) of one call that reads ``n_streams`` streams of
    ``out``'s shape and writes ``out``: the bytes of its bound in
    ``PERF.md``, (r + 1) streams moved once; no FLOPs (r - 1 adds or XORs
    an element, a bound by bytes alone)."""
    return 0.0, float((n_streams + 1) * out.numel() * out.element_size())


def _account(op: str, n_streams: int, out: torch.Tensor) -> bool:
    """:func:`repro_torch.kernels._card.account` of one call."""
    return account(op, DRY_CALLS, op, out,
                   lambda: combine_work(n_streams, out))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load_library("coded_combine",
                              "coded_combine/csrc/coded_combine.cu")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.cc_encode.argtypes = [i32, p, i64, i32, p, p, i64, p]
    lib.cc_decode.argtypes = [i32, p, p, i64, i32, p, p, i64, p]
    lib.cc_xor.argtypes = [p, p, i64, i32, p, i64, p]
    for fn in (lib.cc_encode, lib.cc_decode, lib.cc_xor):
        fn.restype = ctypes.c_int
    return lib


def build() -> float:
    """Build (or load) the kernels now; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _stack(streams: Streams, op: str) -> torch.Tensor:
    """r >= 1 tensors of one shape -> [r, ...]; a tensor is taken as
    already stacked along its leading axis (no copy)."""
    xs = streams if isinstance(streams, torch.Tensor) else \
        torch.stack(list(streams))
    if xs.dim() < 1 or xs.shape[0] < 1:
        raise ValueError(f"{op}: needs at least one stream")
    return xs


def _known_like(f: torch.Tensor, known: Streams, op: str) -> torch.Tensor:
    """The [r-1, ...] known streams, checked to match ``f`` (shape, dtype,
    device: the kernel reads them through raw pointers)."""
    ks = known if isinstance(known, torch.Tensor) else \
        torch.stack(list(known))
    if (ks.shape[1:] != f.shape or ks.dtype != f.dtype
            or ks.device != f.device):
        raise ValueError(f"{op}: known streams must match f in shape, "
                         f"dtype and device")
    return ks


def _on_card(x: torch.Tensor, dtypes, op: str) -> bool:
    """True for a CUDA tensor the kernel takes (or a dry run's ``meta``
    tensor), False for a CPU tensor; raises for anything else."""
    if x.device.type == "cpu":
        return False
    if not on_card(x):
        raise ValueError(f"{op}: tensors must be on a CUDA device or the "
                         f"CPU, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{op}: dtype {x.dtype} not supported on the card; "
                        f"expected one of {tuple(dtypes)}")
    return True


def _coeffs_on(coeffs, x: torch.Tensor, r: int, op: str) -> torch.Tensor:
    c = torch.as_tensor(coeffs, dtype=torch.float32, device=x.device)
    if c.shape != (r,):
        raise ValueError(f"{op}: expected {r} coefficients, got "
                         f"shape {tuple(c.shape)}")
    return c.contiguous()


def coded_encode(streams: Streams, coeffs, *,
                 block_t: int = 256) -> torch.Tensor:
    """f(v_1..v_r) = sum_i c_i v_i.  ``streams``: r tensors of equal shape
    (or one [r, ...] tensor); float32 or bfloat16, accumulated in fp32."""
    xs = _stack(streams, "coded_encode")
    r = xs.shape[0]
    if not _on_card(xs, _LINEAR_DTYPES, "coded_encode"):
        return ref.encode_ref(xs, torch.as_tensor(coeffs))
    xs = xs.contiguous()
    c = _coeffs_on(coeffs, xs, r, "coded_encode")
    out = torch.empty(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    n = out.numel()
    if n and not _account("coded_encode", r, out):
        rc = _library().cc_encode(_LINEAR_DTYPES[xs.dtype], xs.data_ptr(),
                                  n, r, c.data_ptr(), out.data_ptr(), n,
                                  _build.stream_handle())
        _build.check_launch(rc, "coded_encode")
        LAUNCHES["coded_encode"] += 1
    return out


def coded_decode(f: torch.Tensor, known: Streams, coeffs, *,
                 block_t: int = 256) -> torch.Tensor:
    """Recover the missing stream from packet ``f`` and the r-1 ``known``
    streams; ``coeffs[0]`` is the missing stream's coefficient."""
    ks = _known_like(f, known, "coded_decode")
    rm1 = ks.shape[0]
    if not _on_card(f, _LINEAR_DTYPES, "coded_decode"):
        return ref.decode_ref(f, ks, torch.as_tensor(coeffs))
    f, ks = f.contiguous(), ks.contiguous()
    c = _coeffs_on(coeffs, f, rm1 + 1, "coded_decode")
    out = torch.empty_like(f)
    n = out.numel()
    if n and not _account("coded_decode", rm1 + 1, out):
        rc = _library().cc_decode(_LINEAR_DTYPES[f.dtype], f.data_ptr(),
                                  ks.data_ptr(), n, rm1, c.data_ptr(),
                                  out.data_ptr(), n, _build.stream_handle())
        _build.check_launch(rc, "coded_decode")
        LAUNCHES["coded_decode"] += 1
    return out


def _xor(first: torch.Tensor, rest: torch.Tensor, op: str) -> torch.Tensor:
    """first ^ rest[0] ^ ... on the card (32-bit words)."""
    first, rest = first.contiguous(), rest.contiguous()
    out = torch.empty_like(first)
    n = out.numel()
    if n and not _account(op, rest.shape[0] + 1, out):
        rest_ptr = rest.data_ptr() if rest.shape[0] else first.data_ptr()
        rc = _library().cc_xor(first.data_ptr(), rest_ptr, n, rest.shape[0],
                               out.data_ptr(), n, _build.stream_handle())
        _build.check_launch(rc, op)
        LAUNCHES[op] += 1
    return out


def xor_encode(streams: Streams, *, block_t: int = 256) -> torch.Tensor:
    """v_1 ^ ... ^ v_r over int32 or uint32 streams (bit-exact)."""
    xs = _stack(streams, "xor_encode")
    if not _on_card(xs, _XOR_DTYPES, "xor_encode"):
        return ref.xor_encode_ref(xs)
    return _xor(xs[0], xs[1:], "xor_encode")


def xor_decode(f: torch.Tensor, known: Streams, *,
               block_t: int = 256) -> torch.Tensor:
    """f ^ x_1 ^ ... ^ x_{r-1}: the missing stream of a XOR packet."""
    ks = _known_like(f, known, "xor_decode")
    if not _on_card(f, _XOR_DTYPES, "xor_decode"):
        return ref.xor_decode_ref(f, ks)
    return _xor(f, ks, "xor_decode")
