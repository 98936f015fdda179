"""The plain version of the WKV backward's ``chunk`` route
(``ref.wkv_backward_chunk_ref``: chunks of 64 steps, blocks of 16, every
product between blocks with split TF32 operands as the kernel's tensor
cores take them, the diagonal blocks in fp32 with running-product gates)
against the JAX package on the CPU, with numpy inputs from a seed:
``jax.vjp`` of its ``chunked_linear_recurrence(mode="rwkv")`` at RWKV's
decays; at Hymba's (the SSM's WKV identity, log_w down to -16 softplus)
against a float64 step-by-step recurrence; and against the port's own plain
backward (``ref.wkv_backward_ref``).  Also the route by dtype and shape and
the ctypes arguments of a card call.  The CUDA kernels are held against
this plain version on the card in
tests/test_torch_wkv_backward_chunk_cuda.py."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linrec as j_linrec
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv_scan import backward, ref

# fp32 gradients relative to each gradient's largest |entry| (the card's
# gate, chip_smoke.py's BWD_TOL): the same function chunked and summed in
# other orders
TOL = 1e-4
# at Hymba's decays against float64: the mirror's worst on these draws was
# 8.1e-7 (its gates are sums of w over runs of steps, never differences;
# the JAX chunked form's, whose exponents are differences, 2.9e-5)
HYMBA_TOL = 1e-5

SEQS = (64, 65, 191, 130)          # C, C + 1, 3C - 1, 130
WIDTHS = ((16, 16), (16, 64), (64, 16), (64, 64))


def _inputs(B, S, h, Nk, Nv, seed, *, decay="rwkv"):
    """numpy inputs; ``decay='hymba'`` as the SSM hands them to the WKV op
    (log_w = dt A with A = -[1 .. 16], r = q exp(log_w), u = 0), ``'rwkv'``
    as RWKV6's time-mix (log_w = -exp(N(0, 1) - 1))."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    k, v, dout = 0.5 * f(B, S, h, Nk), f(B, S, h, Nv), f(B, S, h, Nv)
    if decay == "hymba":
        dt = np.logaddexp(0.0, f(B, S, h)).astype(np.float32)
        w = (dt[..., None] * -np.linspace(1.0, 16.0, Nk,
                                          dtype=np.float32))
        r = f(B, S, h, Nk) * np.exp(w)
        u = np.zeros((h, Nk), np.float32)
    else:
        w = -np.exp(f(B, S, h, Nk) - 1.0)
        r, u = 0.5 * f(B, S, h, Nk), 0.5 * f(h, Nk)
    return {"r": r.astype(np.float32), "k": k, "v": v,
            "w": w.astype(np.float32), "u": u, "dout": dout}


def _torch(x, dtype=torch.float32):
    return [torch.from_numpy(x[n]).to(dtype) for n in
            ("r", "k", "v", "w", "u", "dout")]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_grads(x):
    """jax.vjp of the JAX package's chunked recurrence (mode 'rwkv')."""
    f = lambda r, k, v, w, u: j_linrec.chunked_linear_recurrence(
        r, k, v, w, u=u, mode="rwkv")[0]
    _, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "rkvwu"))
    return vjp(jnp.asarray(x["dout"]))


def _recurrence64(r, k, v, log_w, u, dout):
    """The gradients of a float64 step-by-step recurrence."""
    xs = [t.double().requires_grad_() for t in (r, k, v, log_w, u)]
    r, k, v, log_w, u = xs
    B, S, h, Nk = r.shape
    state = torch.zeros(B, h, Nk, v.shape[-1], dtype=torch.float64)
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(((state + u[None, :, :, None] * kv)
                     * r[:, t, :, :, None]).sum(-2))
        state = torch.exp(log_w[:, t, :, :, None]) * state + kv
    return torch.autograd.grad(torch.stack(outs, 1), xs, dout.double())


@pytest.mark.parametrize("Nk,Nv", WIDTHS, ids=str)
@pytest.mark.parametrize("S", SEQS)
def test_mirror_matches_jax_vjp(S, Nk, Nv):
    x = _inputs(2, S, 2, Nk, Nv, seed=S + Nk + 3 * Nv)
    got = ref.wkv_backward_chunk_ref(*_torch(x))
    want = _jax_grads(x)
    for name, a, b in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _rel(a.numpy(), b) < TOL, (name, _rel(a.numpy(), b))


@pytest.mark.parametrize("S", (64, 130, 200))
def test_mirror_at_hymba_decays_matches_a_float64_recurrence(S):
    x = _inputs(1, S, 2, 16, 64, seed=7 * S, decay="hymba")
    t = _torch(x)
    got = ref.wkv_backward_chunk_ref(*t)
    want = _recurrence64(*t)
    for name, a, b in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert _rel(a.numpy(), b.numpy()) < HYMBA_TOL, name


@pytest.mark.parametrize("decay", ["rwkv", "hymba"])
@pytest.mark.parametrize("shape", [(2, 64, 3, 16, 64), (1, 150, 2, 64, 64),
                                   (2, 97, 2, 5, 7), (1, 128, 1, 32, 48)],
                         ids=str)
def test_mirror_matches_the_plain_backward(shape, decay):
    x = _inputs(*shape, seed=sum(shape), decay=decay)
    t = _torch(x)
    got = ref.wkv_backward_chunk_ref(*t)
    want = ref.wkv_backward_ref(*t, chunk=16)
    for name, a, b in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        assert _rel(a.numpy(), b.numpy()) < TOL, name


def test_mirror_in_bf16_returns_bf16_within_its_rounding():
    x = _inputs(1, 100, 2, 64, 64, seed=11)
    t = _torch(x)
    t16 = [a.to(torch.bfloat16) if i in (0, 1, 2, 5) else a
           for i, a in enumerate(t)]
    got = ref.wkv_backward_chunk_ref(*t16)
    want = ref.wkv_backward_ref(*(a.float() for a in t16))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == t16[i].dtype
        assert _rel(a.float().numpy(), b.numpy()) < 2e-2


@pytest.mark.parametrize("chunk,sub", [(32, 16), (64, 8), (128, 32)])
def test_other_chunks_and_blocks_agree(chunk, sub):
    """The chunk and block lengths the kernel may be built with compute
    the same gradients."""
    x = _inputs(1, 150, 2, 16, 64, seed=5, decay="hymba")
    want = ref.wkv_backward_chunk_ref(*_torch(x))
    got = ref.wkv_backward_chunk_ref(*_torch(x), chunk=chunk, sub=sub)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) < TOL


def test_mirror_rejects_blocks_that_do_not_divide_the_chunk():
    x = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError):
        ref.wkv_backward_chunk_ref(x, x, x, x, torch.zeros(1, 4), x,
                                   chunk=64, sub=24)


# ---------------------------------------------------------------------------
# the route and the card call's arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,S,Nk,Nv,want", [
    (torch.float32, 2048, 64, 64, "chunk"),     # RWKV6-3B's train step
    (torch.float32, 2560, 16, 64, "chunk"),     # Hymba's SSM
    (torch.bfloat16, 2048, 64, 64, "chunk"),
    (torch.float32, 64, 1, 1, "chunk"),         # one chunk
    (torch.float32, 63, 64, 64, "step"),        # under one chunk
    (torch.float32, 2048, 65, 64, "step"),
    (torch.float32, 2048, 64, 65, "step"),
    (torch.float32, 40, 128, 256, "step"),
    (torch.float16, 2048, 64, 64, "step"),      # the wrapper raises first
])
def test_route_by_dtype_and_shape(dtype, S, Nk, Nv, want):
    assert backward.route(dtype, S, Nk, Nv) == want


def test_route_constants_match_the_header():
    text = (_build.KERNELS_DIR / "rwkv_scan" / "csrc"
            / "wkv_backward_chunk.cuh").read_text()
    const = lambda n: int(re.search(rf"constexpr int {n} = (\d+);",
                                    text).group(1))
    assert (const("kC"), const("kL"), const("kNV")) == (
        backward.CHUNK, backward.BLOCK, backward.CHUNK_MAX_N)


def test_card_arguments_read_views_in_place():
    """The ctypes Args of a chunk call: each stream's (batch, time, head)
    strides as they are, 16-byte copies only where every fp32 stream's base
    and stride allow them, and the scratch the call reckons with."""
    B, S, h, Nk, Nv = 2, 130, 3, 16, 64
    wide = torch.zeros(B, S, h, 2 * Nk)
    r, k = wide[..., :Nk], wide[..., Nk:]
    v, dout = torch.zeros(B, S, h, Nv), torch.zeros(B, S, h, Nv)
    w, u = torch.zeros(B, S, h, Nk), torch.zeros(h, Nk)
    grads = (torch.empty(B, S, h, Nk), torch.empty(B, S, h, Nk),
             torch.empty(B, S, h, Nv), torch.empty(B, S, h, Nk),
             torch.empty(h, Nk))
    args, scratch = backward.chunk_args(r, k, v, w, u, dout, grads)
    assert list(args.sr) == list(r.stride()[:3]) == [S * h * 2 * Nk,
                                                     h * 2 * Nk, 2 * Nk]
    assert list(args.sd) == [S * h * Nv, h * Nv, Nv]
    assert (args.B, args.T, args.H, args.nk, args.nv) == (B, S, h, Nk, Nv)
    assert args.vec == int(all(x.data_ptr() % 16 == 0
                               for x in (r, k, v, w, dout)))
    assert args.dr == grads[0].data_ptr() and args.du == grads[4].data_ptr()
    # the chunks' states and gradient states, decays, Q and du partials
    chunks = -(-S // backward.CHUNK)
    assert [x.numel() for x in scratch] == [B * h * chunks * Nk * Nv] * 2 + [
        B * h * chunks * Nk] * 3
    # a view that starts 4 bytes in, and widths off 4, take 4-byte copies
    flat = torch.zeros(1 + B * S * h * Nk)
    off = flat[1:].view(B, S, h, Nk)
    assert backward.chunk_args(off, k, v, w, u, dout, grads)[0].vec == 0
    narrow = torch.zeros(B, S, h, 6)
    assert backward.chunk_args(narrow, narrow, v, narrow, u, dout,
                               grads)[0].vec == 0
    # bf16 streams are converted as they are staged: only log_w is copied
    r16 = off.to(torch.bfloat16)
    assert backward.chunk_args(r16, r16, v.to(torch.bfloat16), w, u,
                               dout.to(torch.bfloat16), grads)[0].vec == 1
    assert ctypes.sizeof(args) == ctypes.sizeof(backward._ChunkArgs)


def test_cpu_call_takes_the_plain_version_and_no_route():
    x = _inputs(1, 70, 2, 16, 64, seed=3)
    backward.reset_launch_counts()
    got = backward.wkv_scan_backward(*_torch(x))
    assert backward.PLAIN_CALLS["wkv_scan_backward"] == 1
    assert backward.LAUNCHES["wkv_scan_backward"] == 0
    assert backward.ROUTE_CALLS == dict.fromkeys(backward.ROUTES, 0)
    want = ref.wkv_backward_chunk_ref(*_torch(x))
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) < TOL
