"""The plain version of the WKV scan's ``chunk_f32`` route
(``ref.wkv_chunk_f32_ref``: chunks of 64 steps, blocks of 16 whose gates
are running products, exponents summed over runs of steps) against the
JAX package on the CPU, with numpy inputs from a seed: its
``chunked_linear_recurrence`` in both modes and ``wkv_scan`` (the Pallas
kernel in interpret mode) in mode 'rwkv'.  Also the op's inclusive mode on
the CPU, the ctypes arguments of a card call, and the SSM's card dispatch
(the inclusive kernels for a prefill without autograd, the WKV identity
for a decode step and under autograd) driven on CPU tensors with stand-in
launches.  The CUDA kernels are held against this plain version on the
card in tests/test_torch_wkv_chunk_f32_cuda.py."""
import ctypes
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import ops as j_ops
from repro.models import linrec as j_linrec
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv_scan import ops, ref
from repro_torch.models import linrec, lm, ssm
from repro_torch.serve.engine import ServeEngine

# fp32 on both sides, the same recurrence chunked and summed in other
# orders: the fp32 tolerance of tests/test_kernels.py and of the card's
# SSM_TOL.  The JAX side runs at chunk 16: its exponents are differences
# of running sums, which at Hymba's decays (|A| in the hundreds by a
# chunk's end) lose ~1e-3 at chunk 64, where the plain version's sums
# over runs of steps stay within ~1e-5 of a float64 recurrence
FP32_TOL = 3e-4

# (B, S, h, Nk, Nv): Hymba's head (state 16, head 64) and RWKV's (64, 64)
# at ragged S (17 below one chunk, 100 off it, 2065 over 32 chunks), the
# reduced Hymba's (4, 8), widths off the kernel's instances (20, 36)
SHAPES = {
    "hymba_100": (2, 100, 3, 16, 64),
    "hymba_17": (2, 17, 2, 16, 64),
    "hymba_2065": (1, 2065, 1, 16, 64),
    "rwkv_100": (1, 100, 2, 64, 64),
    "rwkv_2065": (1, 2065, 1, 64, 64),
    "reduced_hymba": (2, 50, 2, 4, 8),
    "odd_widths": (1, 70, 2, 20, 36),
}


def _inputs(B, S, h, Nk, Nv, seed, *, decay):
    """numpy inputs; ``decay='hymba'`` draws them as the SSM makes them
    (dt = softplus(.), log_w = dt * A with A = -[1 .. 16], down to
    -16 softplus(.), k = B dt), ``'rwkv'`` as RWKV's log_w = -exp(.)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(B, S, h, Nk), f(B, S, h, Nk), f(B, S, h, Nv)
    if decay == "hymba":
        dt = np.logaddexp(0.0, f(B, S, h)).astype(np.float32)
        A = -np.linspace(1.0, 16.0, Nk, dtype=np.float32)
        w = dt[..., None] * A
        k = k * dt[..., None]
    else:
        w = -np.exp(f(B, S, h, Nk))
    return {"q": q, "k": k, "v": v, "w": w.astype(np.float32),
            "u": 0.1 * f(h, Nk), "s0": 0.1 * f(B, h, Nk, Nv)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=FP32_TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _plain(x, mode, with_s0, **kw):
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    return ref.wkv_chunk_f32_ref(
        t["q"], t["k"], t["v"], t["w"], t["u"] if mode == "rwkv" else None,
        t["s0"] if with_s0 else None, mode=mode, **kw)


@pytest.mark.parametrize("decay", ["hymba", "rwkv"])
@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero_s0"])
@pytest.mark.parametrize("mode", ["inclusive", "rwkv"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_jax_chunked(shape, mode, with_s0, decay):
    B, S, h, Nk, Nv = SHAPES[shape]
    x = _inputs(B, S, h, Nk, Nv, seed=S + Nk + Nv, decay=decay)
    out, sT = _plain(x, mode, with_s0)
    assert out.shape == (B, S, h, Nv) and out.dtype == torch.float32
    assert sT.shape == (B, h, Nk, Nv) and sT.dtype == torch.float32
    jout, jsT = j_linrec.chunked_linear_recurrence(
        *(jnp.asarray(x[n]) for n in "qkvw"),
        u=jnp.asarray(x["u"]) if mode == "rwkv" else None,
        initial_state=jnp.asarray(x["s0"]) if with_s0 else None, mode=mode,
        chunk=16, return_state=True)
    _close(out, jout)
    _close(sT, jsT)


@pytest.mark.parametrize("decay", ["hymba", "rwkv"])
@pytest.mark.parametrize("shape", ["hymba_100", "hymba_17", "rwkv_100",
                                   "reduced_hymba"])
def test_plain_matches_jax_pallas_kernel(shape, decay):
    """Mode 'rwkv' against the Pallas kernel itself (interpret mode),
    which pads S to its chunk and carries the state across its grid."""
    B, S, h, Nk, Nv = SHAPES[shape]
    x = _inputs(B, S, h, Nk, Nv, seed=3 * S + Nk, decay=decay)
    out, sT = _plain(x, "rwkv", True)
    jout, jsT = j_ops.wkv_scan(*(jnp.asarray(x[n]) for n in
                                 ("q", "k", "v", "w", "u", "s0")), chunk=16)
    _close(out, jout)
    _close(sT, jsT)


@pytest.mark.parametrize("mode", ["inclusive", "rwkv"])
@pytest.mark.parametrize("chunk,block", [(32, 8), (32, 16), (64, 8),
                                         (128, 16)])
def test_other_chunks_and_blocks_agree(chunk, block, mode):
    """The chunk and block lengths the kernel may be built with compute
    the same function."""
    B, S, h, Nk, Nv = SHAPES["hymba_100"]
    x = _inputs(B, S, h, Nk, Nv, seed=5, decay="hymba")
    want = _plain(x, mode, True)
    got = _plain(x, mode, True, chunk=chunk, block=block)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_plain_version_rejects_blocks_that_do_not_divide_the_chunk():
    x = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError):
        ref.wkv_chunk_f32_ref(x, x, x, x, chunk=64, block=24)
    with pytest.raises(ValueError):
        ref.wkv_chunk_f32_ref(x, x, x, x, mode="exclusive")


def test_op_inclusive_scan_on_the_cpu_is_the_plain_chunked_form():
    x = _inputs(2, 40, 2, 16, 64, seed=7, decay="hymba")
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    ops.reset_launch_counts()
    out, sT = ops.inclusive_scan(t["q"], t["k"], t["v"], t["w"], t["s0"],
                                 chunk=8)
    want, want_sT = linrec.chunked_linear_recurrence(
        t["q"], t["k"], t["v"], t["w"], initial_state=t["s0"],
        mode="inclusive", chunk=8, return_state=True)
    assert torch.equal(out, want) and torch.equal(sT, want_sT)
    assert ops.PLAIN_CALLS["wkv_scan"] == 1 and ops.LAUNCHES["wkv_scan"] == 0
    assert ops.ROUTE_CALLS == dict.fromkeys(ops.ROUTES, 0)
    with pytest.raises(ValueError):
        ops.inclusive_scan(t["q"], t["k"][:, :-1], t["v"], t["w"])


def test_card_arguments_read_views_in_place():
    """The ctypes Args of a card call: each stream's (batch, time, head)
    strides as they are, 16-byte copies only where every base and stride
    allows them, and the scratch the call reckons with."""
    B, S, h, Nk, Nv = 2, 100, 3, 16, 64
    wide = torch.zeros(B, S, h, 2 * Nk)
    q, k = wide[..., :Nk], wide[..., Nk:]
    v, w = torch.zeros(B, S, h, Nv), torch.zeros(B, S, h, Nk)
    out, sT = torch.empty(B, S, h, Nv), torch.empty(B, h, Nk, Nv)
    args, scratch = ops.chunk_f32_args(q, k, v, w, None, None, out, sT)
    assert list(args.sq) == list(q.stride()[:3]) == [S * h * 2 * Nk,
                                                     h * 2 * Nk, 2 * Nk]
    assert list(args.sv) == [S * h * Nv, h * Nv, Nv]
    assert (args.B, args.T, args.H, args.nk, args.nv) == (B, S, h, Nk, Nv)
    assert args.u is None and args.s0 is None
    assert args.vec == int(all(x.data_ptr() % 16 == 0 for x in (q, k, v, w)))
    # each chunk's state and decay, fp32
    chunks = -(-S // ops.CHUNK_F32)
    assert [x.numel() for x in scratch] == [B * h * chunks * Nk * Nv,
                                            B * h * chunks * Nk]
    # a view that starts 4 bytes in, and widths off 4, take 4-byte copies
    flat = torch.zeros(1 + B * S * h * Nk)
    off = flat[1:].view(B, S, h, Nk)
    args, _ = ops.chunk_f32_args(off, k, v, w, None, None, out, sT)
    assert args.vec == 0
    narrow = torch.zeros(B, S, h, 6)
    args, _ = ops.chunk_f32_args(narrow, narrow, v, narrow, None, None, out,
                                 torch.empty(B, h, 6, Nv))
    assert args.vec == 0
    assert ctypes.sizeof(args) == ctypes.sizeof(ops._ChunkArgs)


def test_card_calls_raise_off_the_route():
    """A card call the chunk_f32 kernels do not take raises before any
    launch (here on CPU tensors, which no card call accepts)."""
    x = torch.zeros(1, 20, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops._launch_chunk(x, x, torch.zeros(1, 20, 1, 64), x, None, None,
                          True)


def test_build_hash_covers_the_f32_header(tmp_path):
    """Editing csrc/wkv_chunk_f32.cuh, which wkv_scan.cu includes,
    rebuilds."""
    src = _build.KERNELS_DIR / "rwkv_scan" / "csrc"
    for f in src.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = _build.source_digest(tmp_path / "wkv_scan.cu")
    header = tmp_path / "wkv_chunk_f32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_digest(tmp_path / "wkv_scan.cu") != before


# ---------------------------------------------------------------------------
# the SSM's card dispatch, on CPU tensors with stand-in launches
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _card_dispatch(monkeypatch):
    """Run the SSM's CPU tensors through its card dispatch (``ssm._card``)
    with stand-in launches that count like the real ones and compute the
    plain versions; yields the inclusive calls and the WKV Function's
    applications."""
    calls = {"inclusive": 0, "function": 0}

    def inclusive(q, k, v, log_w, initial_state=None, *, chunk=64):
        calls["inclusive"] += 1
        ops.LAUNCHES["wkv_scan"] += 1
        ops.ROUTE_CALLS["chunk_f32"] += 1
        return linrec.chunked_linear_recurrence(
            q, k, v, log_w, initial_state=initial_state, mode="inclusive",
            chunk=16, return_state=True)

    def wkv_launch(r, k, v, log_w, u, initial_state):
        ops.LAUNCHES["wkv_scan"] += 1
        ops.ROUTE_CALLS[ops.route(r.dtype, r.shape[1], r.shape[3],
                                  v.shape[3])] += 1
        return linrec.chunked_linear_recurrence(
            r, k, v, log_w, u=u, initial_state=initial_state,
            return_state=True)

    def wkv_scan(r, k, v, log_w, u, initial_state=None, *, chunk=64):
        return ops._card(r, k, v, log_w, u, initial_state)

    orig = ops.WkvScanFn.apply

    def apply(*args):
        calls["function"] += 1
        return orig(*args)

    monkeypatch.setattr(ops, "inclusive_scan", inclusive)
    monkeypatch.setattr(ops, "_launch", wkv_launch)
    monkeypatch.setattr(ops, "wkv_scan", wkv_scan)
    monkeypatch.setattr(ssm, "inclusive_scan", ssm._card)
    monkeypatch.setattr(ops.WkvScanFn, "apply", apply)
    ops.reset_launch_counts()
    yield calls


def _ssm_streams(B, S, h=3, Nk=16, Nv=64, seed=0):
    x = _inputs(B, S, h, Nk, Nv, seed=seed, decay="hymba")
    return [torch.from_numpy(x[n]) for n in ("q", "k", "v", "w", "s0")]


@pytest.mark.parametrize("S,want", [(ops.CHUNK_MIN_SEQ, "chunk_f32"),
                                    (100, "chunk_f32"),
                                    (ops.CHUNK_MIN_SEQ - 1, "step"),
                                    (1, "step")])
def test_ssm_scan_takes_the_inclusive_kernels_for_a_prefill(
        monkeypatch, S, want):
    """Without autograd a prefill (S >= 16) is one inclusive call, a
    shorter call (a decode step) the WKV identity on ``step``; both equal
    the plain inclusive recurrence."""
    q, k, v, w, s0 = _ssm_streams(2, S)
    with _card_dispatch(monkeypatch) as calls:
        with torch.no_grad():
            out, sT = ssm._card(q, k, v, w, s0)
        assert ops.LAUNCHES["wkv_scan"] == 1 and ops.ROUTE_CALLS[want] == 1
        assert calls == {"inclusive": int(want == "chunk_f32"),
                         "function": 0}
    o, s = linrec.naive_linear_recurrence(q, k, v, w, None, s0,
                                          mode="inclusive")
    _close(out, o)
    _close(sT, s)


def test_ssm_scan_under_autograd_takes_the_wkv_function(monkeypatch):
    """Under autograd the scan goes through the WKV op's Function (whose
    backward is the WKV backward kernel's), never the inclusive kernels;
    its gradients equal those of the plain inclusive recurrence."""
    q, k, v, w, _ = _ssm_streams(1, 40, h=2)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, w)]
    with _card_dispatch(monkeypatch) as calls:
        out, _ = ssm._card(*leaves, None)
        assert calls == {"inclusive": 0, "function": 1}
        assert ops.ROUTE_CALLS["chunk_f32"] == 1        # the fp32 forward
        grads = torch.autograd.grad(out.square().sum(), leaves)
    plain = [x.clone().requires_grad_() for x in (q, k, v, w)]
    o, _ = linrec.chunked_linear_recurrence(*plain, mode="inclusive",
                                            chunk=16)
    want = torch.autograd.grad(o.square().sum(), plain)
    for g, x in zip(grads, want):
        scale = float(x.abs().max())
        torch.testing.assert_close(g, x, rtol=1e-4, atol=1e-4 * scale)


def test_serving_hymba_launches_the_inclusive_kernels_at_prefill(
        monkeypatch):
    """ServeEngine on the reduced Hymba: each prefill's SSM layers are one
    inclusive call each, each decode step's the WKV identity on ``step``,
    and the tokens are those of the plain path."""
    cfg = get_arch("hymba-1.5b").reduced()
    params = lm.init_params(0, cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = ServeEngine(cfg, params, 2, 32, device="cpu").generate(prompts, 3)
    with _card_dispatch(monkeypatch) as calls:
        got = ServeEngine(cfg, params, 2, 32, device="cpu").generate(
            prompts, 3)
        L = cfg.n_layers
        # one prefill, then two decode steps
        assert calls == {"inclusive": L, "function": 0}
        assert ops.ROUTE_CALLS == {"tensor_core": 0, "chunk_f32": L,
                                   "step": 2 * L}
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
