"""The WKV scan's ``chunk_f32`` route (``csrc/wkv_chunk_f32.cuh``: each
chunk's state, the scan over chunks, the outputs; fp32 FMAs) on the card,
in both modes, against its plain version :func:`ref.wkv_chunk_f32_ref` and
the chunked recurrence at the fp32 tolerance; the same bits twice, views
read in place, the scratch it reckons with, and the step kernel's Nk = 16
instance (Hymba's decode).  Needs a CUDA card (the ``cuda`` marker;
skipped without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_wkv_chunk_f32_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.rwkv_scan import ops as rw
from repro_torch.kernels.rwkv_scan import ref as rw_ref
from repro_torch.models import linrec, ssm

# fp32 throughout, the same recurrence summed in other orders: the fp32
# tolerance of tests/test_torch_kernels_cuda.py and chip_smoke's SSM_TOL;
# the chunked recurrence runs at chunk 16 (at chunk 64 its differences of
# running sums lose ~1e-3 to cancellation at Hymba's decays)
TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _inputs(card, B, S, h, Nk, Nv, seed, *, decay="hymba"):
    """q (r), k, v, log_w, u, s0 drawn as the SSM makes them (log_w = dt A,
    A = -[1 .. 16], down to -16 softplus(.)) or as RWKV's -exp(.)."""
    g = torch.Generator(device=card).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=card)
    q, k, v = rnd(B, S, h, Nk), rnd(B, S, h, Nk), rnd(B, S, h, Nv)
    if decay == "hymba":
        dt = torch.nn.functional.softplus(rnd(B, S, h))
        log_w = dt[..., None] * -torch.linspace(1.0, 16.0, Nk, device=card)
        k = k * dt[..., None]
    else:
        log_w = -torch.exp(rnd(B, S, h, Nk))
    return q, k, v, log_w, 0.1 * rnd(h, Nk), 0.1 * rnd(B, h, Nk, Nv)


def _run(mode, q, k, v, log_w, u, s0):
    """One chunk_f32 call: the op's inclusive mode, or mode 'rwkv' through
    wkv_scan where the route takes it (Nk <= 32) and the launch itself at
    Nk 64, which the route leaves on step."""
    rw.reset_launch_counts()
    if mode == "inclusive":
        out, sT = rw.inclusive_scan(q, k, v, log_w, s0)
    elif q.shape[-1] <= rw.CHUNK_ROUTE_MAX_NK:
        out, sT = rw.wkv_scan(q, k, v, log_w, u, s0)
    else:
        out, sT = rw._launch_chunk(q, k, v, log_w, u, s0, False)
    torch.cuda.synchronize()
    assert rw.ROUTE_CALLS["chunk_f32"] == 1 and rw.LAUNCHES["wkv_scan"] == 1
    assert sum(rw.ROUTE_CALLS.values()) == 1
    assert rw.PLAIN_CALLS["wkv_scan"] == 0
    return out, sT


def _check(mode, out, sT, q, k, v, log_w, u, s0):
    uu = u if mode == "rwkv" else None
    po, ps = rw_ref.wkv_chunk_f32_ref(q, k, v, log_w, uu, s0, mode=mode)
    torch.testing.assert_close(out, po, **TOL)
    torch.testing.assert_close(sT, ps, **TOL)
    want, want_sT = linrec.chunked_linear_recurrence(
        q, k, v, log_w, u=uu, initial_state=s0, mode=mode, chunk=16,
        return_state=True)
    torch.testing.assert_close(out, want, **TOL)
    torch.testing.assert_close(sT, want_sT, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,h,Nk,Nv", [
    (2, 100, 3, 16, 64), (1, 16, 2, 16, 64), (2, 17, 2, 16, 64),
    (1, 2065, 2, 16, 64), (2, 100, 3, 64, 64), (1, 2065, 1, 64, 64),
    (2, 50, 2, 4, 8), (1, 70, 2, 20, 36), (1, 130, 2, 32, 30)])
@pytest.mark.parametrize("mode", ["inclusive", "rwkv"])
@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero_s0"])
def test_chunk_f32_matches_plain_and_recurrence(card, B, S, h, Nk, Nv, mode,
                                                with_s0):
    q, k, v, log_w, u, s0 = _inputs(card, B, S, h, Nk, Nv, seed=S + Nk)
    s0 = s0 if with_s0 else None
    out, sT = _run(mode, q, k, v, log_w, u, s0)
    assert out.shape == (B, S, h, Nv) and out.dtype == torch.float32
    _check(mode, out, sT, q, k, v, log_w, u, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inclusive", "rwkv"])
def test_chunk_f32_at_the_prefill_shapes(card, mode):
    """Hymba's SSM prefill (8 x 2,560, 25 heads, state 16, head 64) and
    RWKV6-3B's fp32 prefill (8 x 2,048, 40 heads of 64), the same bits
    twice."""
    for shape, decay in (((8, 2560, 25, 16, 64), "hymba"),
                         ((8, 2048, 40, 64, 64), "rwkv")):
        args = _inputs(card, *shape, seed=11, decay=decay)
        out, sT = _run(mode, *args)
        again, again_sT = _run(mode, *args)
        assert torch.equal(out, again) and torch.equal(sT, again_sT)
        _check(mode, out, sT, *args)


@pytest.mark.cuda
def test_chunk_f32_reads_views_in_place(card):
    """Strided views (q and k halves of one tensor, a head slice) and a view
    that starts 4 bytes in (the 4-byte copies) give the bits of contiguous
    copies."""
    B, S, h, Nk, Nv = 2, 150, 3, 16, 64
    q, k, v, log_w, _, s0 = _inputs(card, B, S, h, Nk, Nv, seed=5)
    qk = torch.cat([q, k], -1)
    vv = torch.cat([v, v], 2)[:, :, h:]
    flat = torch.cat([torch.zeros(1, device=card), log_w.flatten()])
    w_off = flat[1:].view(log_w.shape)
    assert w_off.data_ptr() % 16 != 0 and not vv.is_contiguous()
    got = _run("inclusive", qk[..., :Nk], qk[..., Nk:], vv, w_off, None, s0)
    want = _run("inclusive", q, k, v, log_w, None, s0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_chunk_f32_scratch_within_its_reckoning(card):
    """A call asks the allocator for its outputs and the chunk states and
    decays it reckons with (fp32, [B h, chunks, Nk, Nv + 1]), nothing more
    (the bytes requested, before the allocator rounds them to its
    blocks)."""
    B, S, h, Nk, Nv = 8, 2560, 25, 16, 64
    args = _inputs(card, B, S, h, Nk, Nv, seed=3)
    _run("inclusive", *args)
    torch.cuda.synchronize()
    key = "requested_bytes.all"
    base = torch.cuda.memory_stats()[key + ".current"]
    torch.cuda.reset_peak_memory_stats()
    out, sT = _run("inclusive", *args)
    peak = torch.cuda.memory_stats()[key + ".peak"] - base
    outputs = 4 * (out.numel() + sT.numel())
    scratch = 4 * B * h * 40 * Nk * (Nv + 1)        # 33.3 MB, 40 chunks
    assert peak <= outputs + scratch, (peak, outputs, scratch)


@pytest.mark.cuda
def test_chunk_f32_occupancy(card):
    """Hymba's instance (Nk 16): two blocks of the output kernel an SM."""
    smem_a, blocks_a, smem_c, blocks_c = rw.chunk_f32_occupancy(16)
    assert blocks_a >= 2 and blocks_c >= 2, rw.chunk_f32_occupancy(16)
    assert rw.chunk_f32_occupancy(64)[3] >= 1


@pytest.mark.cuda
def test_chunk_f32_raises_off_its_inputs(card):
    q, k, v, log_w, u, s0 = _inputs(card, 1, 40, 2, 16, 64, seed=1)
    with pytest.raises(TypeError):
        rw.inclusive_scan(q.bfloat16(), k, v, log_w)
    with pytest.raises(ValueError):
        rw.inclusive_scan(q, k, torch.zeros(1, 40, 2, 65, device=card),
                          log_w)
    with pytest.raises(NotImplementedError, match="gradient"):
        rw.inclusive_scan(q.requires_grad_(), k, v, log_w)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 15])
@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero_s0"])
def test_step_route_at_nk_16(card, S, with_s0):
    """Hymba's decode step (S = 1) and calls below the chunk route's 16
    steps take the step kernel, now with an Nk = 16 instance."""
    q, k, v, log_w, u, s0 = _inputs(card, 8, S, 25, 16, 64, seed=S)
    s0 = s0 if with_s0 else None
    rw.reset_launch_counts()
    out, sT = rw.wkv_scan(q, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    assert rw.ROUTE_CALLS["step"] == 1 and rw.LAUNCHES["wkv_scan"] == 1
    want, want_sT = linrec.chunked_linear_recurrence(
        q, k, v, log_w, u=u, initial_state=s0, mode="rwkv", chunk=16,
        return_state=True)
    torch.testing.assert_close(out, want, **TOL)
    torch.testing.assert_close(sT, want_sT, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("S,want", [(2560, "chunk_f32"), (16, "chunk_f32"),
                                    (1, "step")])
def test_ssm_scan_routes(card, S, want):
    """``ssm.inclusive_scan``: a prefill is one inclusive chunk_f32 call, a
    decode step the WKV identity on step; both within the fp32 tolerance
    of the plain inclusive recurrence."""
    q, k, v, log_w, _, s0 = _inputs(card, 8, S, 25, 16, 64, seed=S + 1)
    rw.reset_launch_counts()
    out, sT = ssm.inclusive_scan(q, k, v, log_w, s0)
    torch.cuda.synchronize()
    assert rw.ROUTE_CALLS[want] == 1 and rw.LAUNCHES["wkv_scan"] == 1
    o, s = linrec.chunked_linear_recurrence(
        q, k, v, log_w, initial_state=s0, mode="inclusive", chunk=16,
        return_state=True)
    torch.testing.assert_close(out, o, **TOL)
    torch.testing.assert_close(sT, s, **TOL)
