"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, on the grid of tests/test_kernels.py.  Needs a CUDA card (the
``cuda`` marker; skipped without one) and imports no JAX, so it runs where
the port runs:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.coded_combine import ops, ref

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
