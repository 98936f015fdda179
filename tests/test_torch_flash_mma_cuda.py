"""The TF32 tensor-core flash kernel (``csrc/flash_mma.cuh``, route
``mma_tf32``: split-TF32 ``mma.sync`` products, ``cp.async`` tiles) on the
card, against the plain version ``attention_ref`` at FLASH_TOL (the fp32
gate 2e-5, bf16 2e-2) and against its plain mirror ``attention_mma_ref``
at the split-kv tolerance ((2e-5, 2e-5) in fp32, (1e-2, 1e-3) in bf16):
every head-dim instance (HD 32, 64, 128, 256, 576) in both dtypes, the
edges of its row blocks and key tiles, runtime positions, windows,
per-batch valid lengths with a batch row that sees no key, rows that are
not 16-byte aligned, v that is k and v that differs at MLA's hd 576, and a
train-mode call through ``FlashAttentionFn``.  Every call runs twice and
gives the same bits.  Needs a CUDA card (the ``cuda`` marker; skipped
without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_flash_mma_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MIRROR_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
# a head dim of each instance; bf16 off the wgmma routes: hd not a multiple
# of 16 below 128, hd 192, and hd 576 with a window
INSTANCE_HDS = (20, 50, 120, 192, 576)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _randn(g, card, dtype, *shape):
    return torch.randn(*shape, generator=g, device=card).to(dtype)


def _check(q, k, v, pos, valid, causal=True, window=None):
    """One launch on the mma route, repeated bit for bit, against the plain
    version and the mirror."""
    fa.reset_launch_counts()
    kw = dict(causal=causal, kv_valid=valid, q_positions=pos, window=window)
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.ROUTE_CALLS["mma_tf32"] == 2, fa.ROUTE_CALLS
    assert fa.LAUNCHES["flash_attention"] == 2
    assert fa.PLAIN_CALLS["flash_attention"] == 0
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.is_contiguous()
    assert torch.equal(out, again)
    want = fa_ref.attention_ref(q, k, v, pos, valid, causal=causal,
                                window=window)
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    mirror = fa_ref.attention_mma_ref(q, k, v, pos, valid, causal=causal,
                                      window=window)
    torch.testing.assert_close(out, mirror, **MIRROR_TOL[q.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", INSTANCE_HDS)
def test_every_instance_against_reference_and_mirror(card, hd, dtype):
    """Runtime positions (a cache's prefill from position 40), per-batch
    valid lengths, causal and a window at every instance."""
    g = torch.Generator(device=card).manual_seed(hd)
    B, Sq, Sk, H, KV = 2, 70, 150, 8, 2
    q = _randn(g, card, dtype, B, Sq, H, hd)
    k, v = (_randn(g, card, dtype, B, Sk, KV, hd) for _ in "kv")
    pos = torch.arange(40, 40 + Sq, device=card)
    valid = torch.tensor([150, 97], device=card)
    window = 33 if hd == 576 else None      # bf16 576: off the wide route
    _check(q, k, v, pos, valid, window=window)
    _check(q, k, v, pos, valid, causal=False, window=window)
    _check(q, k, v, pos, valid, window=17)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(6, 17), (17, 1), (31, 33), (64, 64),
                                   (65, 129), (129, 31)])
def test_row_block_and_key_tile_edges(card, Sq, Sk, dtype):
    """Sq and Sk around the 16-row groups, the row blocks and the 16- and
    32-key tiles, at hd 128 (fp32) and hd 40 (bf16), G = 3: a block's rows
    cut across positions."""
    hd = 128 if dtype == torch.float32 else 40
    g = torch.Generator(device=card).manual_seed(Sq * 1000 + Sk)
    q = _randn(g, card, dtype, 2, Sq, 6, hd)
    k, v = (_randn(g, card, dtype, 2, Sk, 2, hd) for _ in "kv")
    pos = torch.arange(Sk - Sq, Sk, device=card)
    _check(q, k, v, pos, None)
    _check(q, k, v, torch.zeros(Sq, dtype=torch.long, device=card), None,
           causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_that_see_no_key(card, dtype):
    """A batch row with valid length 0, queries before every key and a
    window past the valid keys: uniform weights over all Sk keys for those
    rows, beside rows of the same block that see keys (hd 64 in fp32, 40
    in bf16, which the wgmma route would take at 64)."""
    hd = 64 if dtype == torch.float32 else 40
    g = torch.Generator(device=card).manual_seed(7)
    q = _randn(g, card, dtype, 3, 40, 4, hd)
    k, v = (_randn(g, card, dtype, 3, 90, 2, hd) for _ in "kv")
    pos = torch.arange(-6, 34, device=card)
    _check(q, k, v, pos, torch.tensor([90, 20, 0], device=card))
    _check(q, k, v, pos + 50, 45, window=8)
    _check(q, k, v, torch.flip(pos, (0,)), None, window=5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 576])
def test_rows_not_16_byte_aligned(card, hd, dtype):
    """q, k and v as views of one packed projection at an odd element
    offset: plain loads instead of cp.async (route mma_tf32 in both
    dtypes)."""
    g = torch.Generator(device=card).manual_seed(hd)
    H, KV, S = 4, 2, 50
    qkv = _randn(g, card, dtype, 2, S, (H + 2 * KV) * hd + 1)
    q = qkv[..., 1:1 + H * hd].view(2, S, H, hd)
    k = qkv[..., 1 + H * hd:1 + (H + KV) * hd].view(2, S, KV, hd)
    v = qkv[..., 1 + (H + KV) * hd:].view(2, S, KV, hd)
    assert fa.route(dtype, S, H, KV, hd, False) == "mma_tf32"
    _check(q, k, v, torch.arange(S, device=card), None)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["v_is_k", "v_differs"])
def test_mla_prefill_shape_in_fp32(card, shared):
    """DeepSeek-V2-Lite's fp32 prefill at hd 576: 8 x 2,048 positions, 16
    heads on one latent kv head, into a 2,112-long cache of 2,048 valid
    keys, with v the same tensor as k (the model's call) and apart."""
    g = torch.Generator(device=card).manual_seed(576)
    q = _randn(g, card, torch.float32, 8, 2048, 16, 576)
    k = _randn(g, card, torch.float32, 8, 2112, 1, 576)
    v = k if shared else _randn(g, card, torch.float32, 8, 2112, 1, 576)
    _check(q, k, v, torch.arange(2048, device=card), 2048)


@pytest.mark.cuda
def test_train_mode_call_goes_through_the_function(card):
    """Under autograd the fp32 call runs through ``FlashAttentionFn`` on
    mma_tf32, and its gradients are the backward kernel's, against
    autograd through the plain version (1e-4 of the largest entry)."""
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(*s, generator=g, device=card).requires_grad_()
               for s in ((2, 100, 12, 128), (2, 100, 2, 128),
                         (2, 100, 2, 128)))
    dout = torch.randn(2, 100, 12, 128, generator=g, device=card)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert fa.ROUTE_CALLS["mma_tf32"] == 1 and fa.LAUNCHES[
        "flash_attention"] == 1
    out.backward(dout)
    pos = torch.arange(100, device=card)
    want = fa_ref.attention_ref(q.detach(), k.detach(), v.detach(), pos)
    torch.testing.assert_close(out.detach(), want, rtol=2e-5, atol=2e-5)
    grads = fa_ref.attention_backward_ref(q.detach(), k.detach(),
                                          v.detach(), dout, pos)
    for got, w in zip((q.grad, k.grad, v.grad), grads):
        assert float((got - w).abs().max() / w.abs().max()) < 1e-4
