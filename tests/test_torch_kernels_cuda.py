"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, on the grids of tests/test_kernels.py (plus the LM serving
path's decode shape).  Needs a CUDA card (the
``cuda`` marker; skipped without one) and imports no JAX, so it runs where
the port runs:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.coded_combine import ops, ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv_scan import ops as rw

SHAPES = [(64, 128), (100, 96), (257, 40), (1, 7), (300, 130),
          (17920, 2048)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("T,d", SHAPES)
def test_kernels_match_plain_versions_on_card(card, r, T, d):
    ops.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(1000 * r + T)
    coeffs = torch.arange(1.0, r + 1.0, device=card)
    for dt in (torch.float32, torch.bfloat16):
        xs = torch.randn(r, T, d, generator=g, device=card).to(dt)
        f = ops.coded_encode(xs, coeffs)
        torch.testing.assert_close(f, ref.encode_ref(xs, coeffs),
                                   rtol=0, atol=0)
        dec = ops.coded_decode(f, xs[1:], coeffs)
        torch.testing.assert_close(dec, ref.decode_ref(f, xs[1:], coeffs),
                                   rtol=0, atol=0)
    for dt in (torch.int32, torch.uint32):
        xs = torch.randint(0, 2 ** 30, (r, T, d), generator=g,
                           device=card, dtype=torch.int32).view(dt)
        f = ops.xor_encode(xs)
        assert torch.equal(f.view(torch.int32),
                           ref.xor_encode_ref(xs).view(torch.int32))
        dec = ops.xor_decode(f, xs[1:])
        assert torch.equal(dec.view(torch.int32), xs[0].view(torch.int32))
    torch.cuda.synchronize()
    assert all(v > 0 for v in ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# flash attention and the WKV scan (fp32 matmuls in full fp32 on both sides)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32(card):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield card
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# split-kv against the plain split-kv algorithm, which also computes in fp32
# and rounds once: about one bf16 ulp of the output
SPLIT_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
WKV_TOL = {torch.float32: 3e-4, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (2, 128, 128, 4, 4, 64), (1, 200, 200, 8, 2, 64),
    (2, 64, 256, 4, 1, 128), (2, 12, 40, 4, 1, 16),
    (2, 1, 2112, 12, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_version_on_card(no_tf32, B, Sq, Sk, H,
                                                       KV, hd, causal):
    fa.reset_launch_counts()
    g = torch.Generator(device=no_tf32).manual_seed(Sq + Sk + H)
    # a decode step reads the first kv_valid keys of a longer cache
    valid = 1500 if Sk == 2112 else None
    q_off = (valid - 1 if valid else Sk - Sq) if causal else 0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(s, generator=g, device=no_tf32).to(dt)
                   for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd)))
        out = fa.flash_attention(q, k, v, causal=causal, q_offset=q_off,
                                 kv_valid=valid)
        pos = torch.arange(q_off, q_off + Sq, device=no_tf32)
        want = fa_ref.attention_ref(q, k, v, pos, valid, causal=causal)
        torch.testing.assert_close(out, want, rtol=FLASH_TOL[dt],
                                   atol=FLASH_TOL[dt])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 2
    assert fa.PLAIN_CALLS["flash_attention"] == 0


@pytest.mark.cuda
def test_flash_attention_masks_on_card(no_tf32):
    """Window, tensor positions, per-batch valid lengths, and rows with no
    visible key (uniform weights, as the reference gives them)."""
    fa.reset_launch_counts()
    g = torch.Generator(device=no_tf32).manual_seed(5)
    q, k, v = (torch.randn(s, generator=g, device=no_tf32)
               for s in ((3, 70, 6, 64), (3, 160, 2, 64), (3, 160, 2, 64)))
    pos = torch.arange(50, 120, device=no_tf32)
    cases = [dict(window=32, kv_valid=None),
             dict(window=None, kv_valid=torch.tensor([64, 100, 160],
                                                     device=no_tf32)),
             dict(window=8, kv_valid=40)]           # rows 50.. see no key
    for kw in cases:
        out = fa.flash_attention(q, k, v, causal=True, q_positions=pos, **kw)
        want = fa_ref.attention_ref(q, k, v, pos, kw["kv_valid"],
                                    causal=True, window=kw["window"])
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,h,Nk,Nv", [
    (1, 64, 2, 16, 16), (2, 100, 3, 32, 32), (1, 128, 1, 64, 64),
    (8, 1, 40, 64, 64), (2, 77, 4, 16, 16)])
def test_wkv_scan_matches_plain_version_on_card(no_tf32, B, S, h, Nk, Nv):
    rw.reset_launch_counts()
    g = torch.Generator(device=no_tf32).manual_seed(S + h)
    rnd = lambda *s: torch.randn(s, generator=g, device=no_tf32)
    log_w = -torch.exp(rnd(B, S, h, Nk))
    u, s0 = 0.1 * rnd(h, Nk), 0.1 * rnd(B, h, Nk, Nv)
    r, k, v = rnd(B, S, h, Nk), rnd(B, S, h, Nk), rnd(B, S, h, Nv)
    for dt, w_dt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
        args = (r.to(dt), k.to(dt), v.to(dt), log_w.to(w_dt), u, s0)
        out, sT = rw.wkv_scan(*args)
        want, want_sT = rw.chunked_linear_recurrence(
            *args[:4], u=u, initial_state=s0, mode="rwkv", chunk=16,
            return_state=True)
        tol = WKV_TOL[dt]
        torch.testing.assert_close(out, want, rtol=tol, atol=tol)
        torch.testing.assert_close(sT, want_sT, rtol=tol, atol=tol)
    out0, _ = rw.wkv_scan(r, k, v, log_w, u)            # zero initial state
    torch.testing.assert_close(
        out0, rw.chunked_linear_recurrence(r, k, v, log_w, u=u,
                                           chunk=16)[0],
        rtol=3e-4, atol=3e-4)
    torch.cuda.synchronize()
    assert rw.LAUNCHES["wkv_scan"] == 4
    assert rw.PLAIN_CALLS["wkv_scan"] == 0


@pytest.mark.cuda
def test_flash_attention_unaligned_rows_on_card(no_tf32):
    """Rows that do not start 16-byte aligned take the kernel's
    element-wise staging; the result is the same function."""
    fa.reset_launch_counts()
    g = torch.Generator(device=no_tf32).manual_seed(9)
    for dt in (torch.float32, torch.bfloat16):
        # head dim 20 inside rows of 21: neither 16-byte rows nor strides
        q, k, v = (torch.randn(s + (21,), generator=g,
                               device=no_tf32).to(dt)[..., :20]
                   for s in ((2, 33, 4, ), (2, 70, 2), (2, 70, 2)))
        out = fa.flash_attention(q, k, v, causal=True, q_offset=37)
        pos = torch.arange(37, 70, device=no_tf32)
        torch.testing.assert_close(
            out, fa_ref.attention_ref(q, k, v, pos, None, causal=True),
            rtol=FLASH_TOL[dt], atol=FLASH_TOL[dt])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 2


# ---------------------------------------------------------------------------
# flash attention: each route (tensor_core, tensor_core_wide, split_kv,
# mma_tf32) and its edges, against attention_ref at FLASH_TOL; split_kv
# also against the plain split-kv algorithm at SPLIT_TOL
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd, causal, q positions start, kv_valid, window,
#  route for float32, route for bfloat16); kv_valid "per_batch" is a [B]
#  tensor on the card, and tensors for q positions are used throughout
ROUTE_CASES = {
    # Sq and Sk not multiples of the 64- / 128-row tiles, hd 64
    "ragged_prefill_hd64": (2, 200, 333, 8, 2, 64, True, 133, None, None,
                            "mma_tf32", "tensor_core"),
    # hd 128, no causal mask, Sq just over one 128-row tile
    "ragged_prefill_hd128": (1, 130, 195, 4, 2, 128, False, 0, None, None,
                             "mma_tf32", "tensor_core"),
    # runtime positions, per-batch valid lengths and a window; batch row 0
    # (valid 120) has rows that see no key (positions >= 183)
    "masks_hd128": (3, 100, 300, 6, 2, 128, True, 150, "per_batch", 64,
                    "mma_tf32", "tensor_core"),
    # every row fully masked: uniform weights over all Sk keys
    "all_masked": (2, 40, 90, 4, 2, 64, True, 60, 10, 8,
                   "mma_tf32", "tensor_core"),
    # 17 (query, head) rows per (batch, kv head): just above split_kv
    "boundary_17_rows": (2, 17, 80, 2, 2, 64, True, 63, None, None,
                         "mma_tf32", "tensor_core"),
    # 16 rows per (batch, kv head): the last shape split_kv takes
    "boundary_16_rows": (2, 8, 80, 4, 2, 64, True, 72, None, None,
                         "split_kv", "split_kv"),
    # decode with kv_valid smaller than one chunk of a 2,112-long cache
    "decode_short_valid": (8, 1, 2112, 12, 2, 128, True, 99, 100, None,
                           "split_kv", "split_kv"),
    # decode over the whole 2,112-long cache
    "decode_full_cache": (8, 1, 2112, 12, 2, 128, True, 2111, 2112, None,
                          "split_kv", "split_kv"),
    # decode with per-batch valid lengths (one row sees one key), a window
    # and chunks wholly past some rows' valid keys
    "decode_window": (4, 1, 700, 12, 2, 64, True, 349, "per_batch", 200,
                      "split_kv", "split_kv"),
    # decode, hd not a multiple of 16
    "decode_hd40": (3, 2, 300, 6, 3, 40, True, 250, 252, None,
                    "split_kv", "split_kv"),
    # MLA's absorbed width 576 (16 query heads on one latent kv head):
    # prefill on the TF32 mma route in fp32 and on the wide tensor-core route
    # in bf16, and decode split-kv (fp32 in 32-key chunks)
    "mla_prefill_hd576": (2, 160, 300, 16, 1, 576, True, 140, "per_batch",
                          None, "mma_tf32", "tensor_core_wide"),
    "mla_decode_hd576": (8, 1, 2112, 16, 1, 576, True, 2111, "per_batch",
                         None, "split_kv", "split_kv"),
    # hd 192 (MLA's nope + rope query width) with grouped heads
    "prefill_hd192": (2, 100, 230, 8, 2, 192, True, 130, "per_batch", None,
                      "mma_tf32", "mma_tf32"),
    "decode_hd192": (3, 2, 400, 8, 2, 192, True, 398, "per_batch", None,
                     "split_kv", "split_kv"),
}


def _route_inputs(card, dt, B, Sq, Sk, H, KV, hd, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).to(dt)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_flash_attention_routes_on_card(no_tf32, case):
    (B, Sq, Sk, H, KV, hd, causal, p0, valid, window, r32,
     r16) = ROUTE_CASES[case]
    pos = torch.arange(p0, p0 + Sq, device=no_tf32)
    if valid == "per_batch":
        valid = torch.linspace(1, Sk, B, device=no_tf32).round().int()
        valid[0] = 120 if Sq > 1 else 1
    for dt, want_route in ((torch.float32, r32), (torch.bfloat16, r16)):
        fa.reset_launch_counts()
        q, k, v = _route_inputs(no_tf32, dt, B, Sq, Sk, H, KV, hd,
                                len(case) + Sq)
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 kv_valid=valid, q_positions=pos)
        torch.cuda.synchronize()
        assert fa.ROUTE_CALLS[want_route] == 1, (dt, fa.ROUTE_CALLS)
        assert fa.LAUNCHES["flash_attention"] == 1
        assert fa.PLAIN_CALLS["flash_attention"] == 0
        assert out.shape == q.shape and out.dtype == dt
        want = fa_ref.attention_ref(q, k, v, pos, valid, causal=causal,
                                    window=window)
        torch.testing.assert_close(out, want, rtol=FLASH_TOL[dt],
                                   atol=FLASH_TOL[dt])
        if want_route == "split_kv":
            split = fa_ref.attention_split_ref(q, k, v, pos, valid,
                                               causal=causal, window=window,
                                               chunk=fa.split_chunk(dt, hd))
            torch.testing.assert_close(out, split, **SPLIT_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_is_bitwise_repeatable_on_card(no_tf32, dt):
    """The split-kv partials merge in a fixed chunk order: the same decode
    call twice gives the same bits."""
    fa.reset_launch_counts()
    q, k, v = _route_inputs(no_tf32, dt, 8, 1, 2112, 12, 2, 128, 77)
    kw = dict(causal=True, q_offset=1499, kv_valid=1500)
    first = fa.flash_attention(q, k, v, **kw)
    second = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert fa.ROUTE_CALLS["split_kv"] == 2
    assert fa.LAUNCHES["flash_attention"] == 2


# ---------------------------------------------------------------------------
# the XOR kernel at every boundary of its design: the scalar tail, one
# vector (4 words), one warp's vectors, one block's tile, several tiles
# ---------------------------------------------------------------------------

_TILE = 256 * 4     # one block's tile in words: kXorThreads 16-byte vectors
XOR_LENGTHS = [1, 3, 4, 5, 127, 128, 129, _TILE - 1, _TILE, _TILE + 1,
               3 * _TILE + 7, 7 * _TILE + 4, 50 * _TILE + 9]
# word offsets of (the encode's stacked streams and the decode's f, the
# decode's known streams): shared, then mixed
XOR_OFFSETS = [(0, 0), (1, 1), (2, 2), (3, 3), (0, 1), (1, 3), (3, 0),
               (2, 1)]


def _words_at(g, card, off, count, dt):
    """``count`` random words starting ``off`` words into a fresh buffer
    (whose base is 16-byte aligned), viewed as ``dt``."""
    buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (off + count + 4,),
                        generator=g, device=card, dtype=torch.int32)
    return buf[off:off + count].view(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dt", [torch.int32, torch.uint32])
def test_xor_kernel_bit_exact_at_every_boundary(card, r, dt):
    """r 1-4 run the compiled stream counts, 5 the runtime one; both ops
    are bit-equal to the plain versions, launch once a call, and give the
    same bits on a second call."""
    g = torch.Generator(device=card).manual_seed(31 * r)
    eq = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    for n in XOR_LENGTHS:
        for off_a, off_b in XOR_OFFSETS:
            xs = _words_at(g, card, off_a, r * n, dt).view(r, n)
            f = _words_at(g, card, off_a, n, dt)
            known = _words_at(g, card, off_b, (r - 1) * n, dt).view(r - 1, n)
            ops.reset_launch_counts()
            enc = ops.xor_encode(xs)
            dec = ops.xor_decode(f, known)
            torch.cuda.synchronize()
            assert ops.LAUNCHES == {"coded_encode": 0, "coded_decode": 0,
                                    "xor_encode": 1, "xor_decode": 1}
            where = f"r={r} n={n} offsets=({off_a}, {off_b}) {dt}"
            assert enc.dtype == dec.dtype == dt, where
            assert eq(enc, ref.xor_encode_ref(xs)), where
            assert eq(dec, ref.xor_decode_ref(f, known)), where
            assert eq(ops.xor_encode(xs), enc), where
            assert eq(ops.xor_decode(f, known), dec), where
            torch.cuda.synchronize()
            assert ops.LAUNCHES["xor_encode"] == 2, where
            assert ops.LAUNCHES["xor_decode"] == 2, where

