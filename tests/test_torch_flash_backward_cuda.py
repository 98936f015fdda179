"""The flash attention backward kernel (``flash_attention/csrc/
flash_backward.cu``: split-TF32 ``mma.sync`` products, ``cp.async`` tiles)
against autograd through its plain version, on the card.  Needs a CUDA
card (the ``cuda`` marker; skipped without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_flash_backward_cuda.py

Every case also calls the kernel twice and wants the same bits (no atomics:
one writer an output element, fixed-order loops).  Tolerances, gradients
relative to the largest |gradient| of the tensor, as in
tests/test_torch_train_cuda.py: 1e-4 in fp32 (split TF32 keeps fp32's
roundoff) and 2e-2 in bf16 (the gradients are rounded to bf16, 2^-8, and
the saved bf16 output enters D = dO . O).  With one key (Sk = 1) the
softmax is constant, so dQ = dK = 0 in exact arithmetic: what the kernel
and autograd leave there is the roundoff of dP - D, held against the
call's largest gradient (dV's).

The tiles of the hd-128 instance: 64 (query, head) rows and 16 keys a dq
block, 64 keys and 16 rows a dkdv block; the edge sizes straddle them."""
import pytest
import torch

from repro_torch.kernels.flash_attention import backward as fab
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
EDGES = (1, 15, 16, 17, 63, 64, 65, 129)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _check(q, k, v, dout, pos, causal, window):
    """The kernel against autograd through the plain version, twice."""
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 q_positions=pos)
    fab.reset_launch_counts()
    got = fab.flash_attention_backward(q, k, v, out, dout, causal=causal,
                                       window=window, q_positions=pos)
    again = fab.flash_attention_backward(q, k, v, out, dout, causal=causal,
                                         window=window, q_positions=pos)
    torch.cuda.synchronize()
    assert fab.LAUNCHES["flash_attention_backward"] == 2
    assert fab.PLAIN_CALLS["flash_attention_backward"] == 0
    want = fa_ref.attention_backward_ref(q, k, v, dout, pos, causal=causal,
                                         window=window)
    top = max(float(b.float().abs().max()) for b in want)
    for a, a2, b in zip(got, again, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        assert torch.equal(a, a2)
        err = (_rel(a, b) if k.shape[1] > 1 else
               float((a.float() - b.float()).abs().max()) / top)
        assert err < TOL[q.dtype], err
    return got


def _inputs(card, B, Sq, Sk, H, KV, hd, dtype, seed, scale=1.0):
    g = torch.Generator(device=card).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=card, generator=g)
    q, k = scale * mk(B, Sq, H, hd), scale * mk(B, Sk, KV, hd)
    return (q.to(dtype), k.to(dtype), mk(B, Sk, KV, hd).to(dtype),
            mk(B, Sq, H, hd).to(dtype))


# every edge of the hd-128 tiles, causal self attention and cross (Sq != Sk)
EDGE_CASES = ([(s, s, True) for s in EDGES]
              + [(s, t, False) for s, t in zip(EDGES, reversed(EDGES))])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", EDGE_CASES, ids=str)
def test_tile_edges(card, case, dtype):
    Sq, Sk, causal = case
    q, k, v, dout = _inputs(card, 2, Sq, Sk, 6, 2, 128, dtype, Sq * 131 + Sk)
    pos = torch.arange(Sq, device=card)
    _check(q, k, v, dout, pos, causal, None)


# every instance (HD 32, 64, 128, 256, 576), odd hd padded into them, G 1-16
HD_CASES = [(16, 1), (32, 2), (50, 6), (64, 8), (100, 1), (128, 8),
            (200, 2), (256, 6), (300, 1), (576, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", HD_CASES, ids=str)
def test_head_dims_and_groups(card, case, dtype):
    hd, G = case
    KV = 2 if G < 16 else 1
    q, k, v, dout = _inputs(card, 1, 70, 70, KV * G, KV, hd, dtype, hd + G)
    _check(q, k, v, dout, torch.arange(70, device=card), True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("hd", [64, 50])
def test_strided_views_of_packed_qkv(card, hd, dtype):
    """q, k and v as views of one packed [B, S, (H + 2 KV) hd] projection:
    rows 16-byte aligned at hd 64 in fp32 (cp.async), not at hd 50 (plain
    loads)."""
    B, S, H, KV = 2, 90, 6, 2
    g = torch.Generator(device=card).manual_seed(hd)
    qkv = torch.randn(B, S, (H + 2 * KV) * hd, device=card,
                      generator=g).to(dtype)
    q = qkv[..., :H * hd].view(B, S, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].view(B, S, KV, hd)
    v = qkv[..., (H + KV) * hd:].view(B, S, KV, hd)
    assert not q.is_contiguous()
    dout = torch.randn(B, S, H, hd, device=card, generator=g).to(dtype)
    _check(q, k, v, dout, torch.arange(S, device=card), True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("window", [None, 7, 40])
def test_windows_and_rows_that_see_no_key(card, window, dtype):
    """Shifted positions: the first ten queries sit before every key (no
    visible key: uniform weights, a share of dV only); a window too."""
    Sq = Sk = 100
    q, k, v, dout = _inputs(card, 2, Sq, Sk, 4, 2, 64, dtype, 7)
    pos = torch.arange(Sq, device=card) - 10
    _check(q, k, v, dout, pos, True, window)


@pytest.mark.cuda
def test_cross_attention_at_position_zero(card):
    """Whisper's cross attention: non-causal, every query at position 0."""
    q, k, v, dout = _inputs(card, 2, 33, 150, 4, 4, 64, torch.float32, 8)
    _check(q, k, v, dout, torch.zeros(33, dtype=torch.long, device=card),
           False, None)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 576])
def test_large_logits_stay_finite(card, hd):
    """q and k scaled by 3 (logits up to about 40): within the tolerance;
    scaled by 16 (logits near a thousand, a one-hot softmax, where fp32
    itself no longer resolves P to 1e-4): finite, and the same bits twice."""
    q, k, v, dout = _inputs(card, 1, 80, 80, 4, 1, hd, torch.float32, 9,
                            scale=3.0)
    _check(q, k, v, dout, torch.arange(80, device=card), True, None)
    q, k = 16.0 / 3.0 * q, 16.0 / 3.0 * k
    pos = torch.arange(80, device=card)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, q_positions=pos)
    got = fab.flash_attention_backward(q, k, v, out, dout, q_positions=pos)
    again = fab.flash_attention_backward(q, k, v, out, dout, q_positions=pos)
    for a, a2 in zip(got, again):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
