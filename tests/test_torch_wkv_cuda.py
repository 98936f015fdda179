"""The WKV scan's ``tensor_core`` route (``csrc/wkv_chunk.cuh``: chunks of
32 steps, 16-step sub-chunks, TF32 products with fp32 accumulators) on the
card, against its plain mirror :func:`ref.wkv_subchunk_ref` with the same
TF32 operand rounding, and against the chunked recurrence at the bf16
tolerance of tests/test_torch_kernels_cuda.py.  Needs a CUDA card (the
``cuda`` marker; skipped without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_wkv_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.rwkv_scan import ops as rw
from repro_torch.kernels.rwkv_scan import ref as rw_ref

# against the mirror (the same TF32 rounding, the same chunks): the two
# compute a TF32 operand from fp32 values that differ in the last bits
# (another order of the running sums, ex2.approx), so now and then one
# operand rounds the other way, which moves a product by one TF32 ulp,
# 2^-10 of it: 2e-2 for the products of order 20 these inputs give (the
# worst seen on the H100 was 1.46e-2, a product of 15); the bf16 output
# may also sit one ulp (2^-7 relative at most) apart
MIRROR_TOL = {"out": dict(rtol=2e-2, atol=2e-2),
              "state": dict(rtol=2e-2, atol=2e-2)}
# against the fp32 chunked recurrence: WKV_TOL[bf16] of
# tests/test_torch_kernels_cuda.py
WKV_TOL = dict(rtol=3e-2, atol=3e-2)


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


def _inputs(card, B, S, h, seed, *, strong=False):
    g = torch.Generator(device=card).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=card)
    N = rw.TC_WIDTH
    # strong decays: log_w = -exp(3 randn) reaches -1e4 and beyond
    log_w = -torch.exp((3.0 if strong else 1.0) * rnd(B, S, h, N))
    return (rnd(B, S, h, N).bfloat16(), rnd(B, S, h, N).bfloat16(),
            rnd(B, S, h, N).bfloat16(), log_w, 0.1 * rnd(h, N),
            0.1 * rnd(B, h, N, N))


def _run_tc(r, k, v, log_w, u, s0):
    rw.reset_launch_counts()
    out, sT = rw.wkv_scan(r, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    assert rw.ROUTE_CALLS["tensor_core"] == 1
    assert sum(rw.ROUTE_CALLS.values()) == 1
    assert rw.LAUNCHES["wkv_scan"] == 1 and rw.PLAIN_CALLS["wkv_scan"] == 0
    return out, sT


def _mirror(*args):
    return rw_ref.wkv_subchunk_ref(*args, chunk=rw.TC_CHUNK, sub=rw.TC_SUB,
                                   leaf=rw.TC_LEAF, tf32=True)


def _check(out, sT, r, k, v, log_w, u, s0):
    mo, ms = _mirror(r, k, v, log_w, u, s0)
    torch.testing.assert_close(out, mo, **MIRROR_TOL["out"])
    torch.testing.assert_close(sT, ms, **MIRROR_TOL["state"])
    want, want_sT = rw.chunked_linear_recurrence(
        r, k, v, log_w, u=u, initial_state=s0, mode="rwkv", chunk=64,
        return_state=True)
    torch.testing.assert_close(out, want, **WKV_TOL)
    torch.testing.assert_close(sT, want_sT, **WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,h", [
    (2, 100, 3), (1, 16, 2), (1, 17, 2), (2, 31, 2), (1, 33, 3),
    (1, 64, 2), (1, 2047, 2), (1, 2065, 2)])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero_s0"])
def test_tensor_core_route_matches_mirror_and_recurrence(card, B, S, h,
                                                         w_dtype, with_s0):
    r, k, v, log_w, u, s0 = _inputs(card, B, S, h, seed=S + 7 * h)
    log_w = log_w.to(w_dtype)
    s0 = s0 if with_s0 else None
    out, sT = _run_tc(r, k, v, log_w, u, s0)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, h, 64)
    _check(out, sT, r, k, v, log_w, u, s0)


@pytest.mark.cuda
def test_tensor_core_route_at_the_prefill_shape(card):
    """RWKV6-3B's prefill: 8 x 2048, 40 heads of 64, fp32 decay."""
    args = _inputs(card, 8, 2048, 40, seed=11)
    out, sT = _run_tc(*args)
    _check(out, sT, *args)


@pytest.mark.cuda
def test_tensor_core_route_reads_views_in_place(card):
    """Contiguous views that start off 16 bytes (a batch slice of an odd
    offset) are copied by the wrapper, and give the same result."""
    r, k, v, log_w, u, s0 = _inputs(card, 3, 40, 2, seed=5)
    flat = torch.cat([torch.zeros(1, device=card, dtype=r.dtype),
                      r.flatten()])
    r_off = flat[1:].view(r.shape)
    assert r_off.data_ptr() % 16 != 0
    out, sT = _run_tc(r_off, k, v, log_w, u, s0)
    want, want_sT = _run_tc(r, k, v, log_w, u, s0)
    assert torch.equal(out, want) and torch.equal(sT, want_sT)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 2065])
def test_tensor_core_route_stays_finite_at_strong_decays(card, S):
    """log_w down to -1e4 and below: every gate underflows to 0, none
    overflows; the fp32 chunked form itself drifts there, so finiteness
    and the mirror are what is checked."""
    r, k, v, log_w, u, s0 = _inputs(card, 2, S, 3, seed=S, strong=True)
    assert float(log_w.min()) < -1e4
    out, sT = _run_tc(r, k, v, log_w, u, s0)
    assert torch.isfinite(out.float()).all() and torch.isfinite(sT).all()
    mo, ms = _mirror(r, k, v, log_w, u, s0)
    assert torch.isfinite(mo.float()).all() and torch.isfinite(ms).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S,N,want", [
    (torch.float32, 2048, 64, "step"), (torch.bfloat16, 1, 64, "step"),
    (torch.bfloat16, 15, 64, "step"), (torch.bfloat16, 100, 32, "step"),
    (torch.bfloat16, 64, 16, "step"), (torch.bfloat16, 16, 64,
                                       "tensor_core"),
    (torch.float32, 100, 32, "chunk_f32")])
def test_each_call_takes_its_route(card, dtype, S, N, want):
    """Every card call launches exactly its route's kernel, and the step
    route still matches the recurrence."""
    g = torch.Generator(device=card).manual_seed(S + N)
    rnd = lambda *s: torch.randn(s, generator=g, device=card)
    r, k, v = (rnd(2, S, 2, N).to(dtype) for _ in range(3))
    log_w, u = -torch.exp(rnd(2, S, 2, N)), 0.1 * rnd(2, N)
    rw.reset_launch_counts()
    out, sT = rw.wkv_scan(r, k, v, log_w, u)
    torch.cuda.synchronize()
    assert rw.ROUTE_CALLS[want] == 1 and sum(rw.ROUTE_CALLS.values()) == 1
    assert rw.route(dtype, S, N, N) == want
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    o, s = rw.chunked_linear_recurrence(r, k, v, log_w, u=u, mode="rwkv",
                                        return_state=True)
    torch.testing.assert_close(out, o, rtol=tol, atol=tol)
    torch.testing.assert_close(sT, s, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_tensor_core_kernel_fits_three_blocks_an_sm(card):
    smem, blocks = rw.tc_occupancy()
    assert smem <= 227 * 1024 and blocks >= 3, (smem, blocks)
