"""The wide tensor-core flash kernel (``csrc/flash_tc_wide.cuh``: bf16
prefill at hd 576) on the card, against the plain version
``attention_ref`` at the bf16 tolerance 2e-2 and against its plain mirror
``attention_wide_ref`` (the kernel's blocks, tiles and roundings, fp32
sums) at the split-kv tolerance (1e-2, 1e-3): the edges of its 64-row
blocks and of its key tiles, v that is k and v that differs, two kv
heads, per-batch valid lengths with a batch row that sees no key, strided
views (q sliced from a wider tensor or transposed, k and v as MLA's cache
view) and DeepSeek-V2-Lite's prefill shape.  Every call runs twice and
gives the same bits.  Needs a CUDA card (the ``cuda`` marker; skipped
without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_flash_wide_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref

HD = 576
REF_TOL = 2e-2
MIRROR_TOL = dict(rtol=1e-2, atol=1e-3)

# folded (position, head) rows of one (batch, kv head) as (Sq, H): around
# the 64-row block
ROWS = {17: (17, 1), 63: (7, 9), 64: (4, 16), 65: (13, 5), 129: (129, 1)}
# keys: around the 64- and 32-key tiles, and the latent cache's length
SKS = [1, 63, 64, 65, 2112]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 references
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _randn(g, card, *shape):
    return torch.randn(*shape, generator=g, device=card).to(torch.bfloat16)


def _check(q, k, v, pos, valid, causal=True):
    """One launch on the wide route, repeated bit for bit, against the
    plain version and the mirror."""
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=causal, kv_valid=valid,
                             q_positions=pos)
    again = fa.flash_attention(q, k, v, causal=causal, kv_valid=valid,
                               q_positions=pos)
    torch.cuda.synchronize()
    assert fa.ROUTE_CALLS["tensor_core_wide"] == 2, fa.ROUTE_CALLS
    assert fa.LAUNCHES["flash_attention"] == 2
    assert fa.PLAIN_CALLS["flash_attention"] == 0
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    want = fa_ref.attention_ref(q, k, v, pos, valid, causal=causal)
    torch.testing.assert_close(out, want, rtol=REF_TOL, atol=REF_TOL)
    mirror = fa_ref.attention_wide_ref(q, k, v, pos, valid, causal=causal,
                                       key_tile=fa.wide_key_tile(k, v))
    torch.testing.assert_close(out, mirror, **MIRROR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["v_is_k", "v_differs"])
@pytest.mark.parametrize("Sk", SKS)
@pytest.mark.parametrize("rows", list(ROWS))
def test_wide_route_at_block_and_tile_edges(card, rows, Sk, shared):
    Sq, H = ROWS[rows]
    g = torch.Generator(device=card).manual_seed(rows * 10_000 + Sk)
    q = _randn(g, card, 2, Sq, H, HD)
    k = _randn(g, card, 2, Sk, 1, HD)
    v = k if shared else _randn(g, card, 2, Sk, 1, HD)
    # the last query sees every key
    p0 = max(Sk - Sq, 0)
    _check(q, k, v, torch.arange(p0, p0 + Sq, device=card), None)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shared", [True, False], ids=["v_is_k", "v_differs"])
def test_wide_route_per_batch_valid_and_two_kv_heads(card, shared, causal):
    """Two kv heads of 16 query heads; per-batch valid lengths, batch row
    2 sees no key (uniform weights over all Sk keys)."""
    g = torch.Generator(device=card).manual_seed(31 + causal)
    q = _randn(g, card, 3, 9, 32, HD)
    k = _randn(g, card, 3, 300, 2, HD)
    v = k if shared else _randn(g, card, 3, 300, 2, HD)
    valid = torch.tensor([300, 120, 0], device=card)
    _check(q, k, v, torch.arange(250, 259, device=card), valid, causal)


@pytest.mark.cuda
def test_wide_route_on_strided_views(card):
    """q sliced from a wider tensor and q transposed from [B, H, S, hd];
    k = v as MLA's view of its latent cache (64-key tiles), then k and v
    as two slices of one tensor (32-key tiles)."""
    g = torch.Generator(device=card).manual_seed(5)
    latent = _randn(g, card, 2, 160, HD)
    kv = latent[:, :, None, :]
    pos = torch.arange(100, 140, device=card)
    q_wide = _randn(g, card, 2, 40, 16, 640)[..., :HD]
    q_t = _randn(g, card, 2, 16, 40, HD).transpose(1, 2)
    assert fa.wide_key_tile(kv, kv) == 64
    for q in (q_wide, q_t):
        _check(q, kv, kv, pos, 140)
    both = _randn(g, card, 2, 160, 1, 2 * HD)
    k, v = both[..., :HD], both[..., HD:]
    assert fa.wide_key_tile(k, v) == 32
    _check(q_wide, k, v, pos, torch.tensor([140, 77], device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["v_is_k", "v_differs"])
def test_wide_route_at_the_mla_prefill_shape(card, shared):
    """DeepSeek-V2-Lite's prefill: q [8, 2048, 16, 576] into the 2,112-long
    latent cache with 2,048 valid keys."""
    g = torch.Generator(device=card).manual_seed(2048 + shared)
    q = _randn(g, card, 8, 2048, 16, HD)
    k = _randn(g, card, 8, 2112, 1, HD)
    v = k if shared else _randn(g, card, 8, 2112, 1, HD)
    _check(q, k, v, torch.arange(2048, device=card), 2048)
