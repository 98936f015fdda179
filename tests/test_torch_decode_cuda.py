"""The linear decode kernel (``csrc/linear_decode.cuh``) bit for bit against
its plain version on the card: r = 1..5 (the compiled stream counts and
the runtime one), float32 and bfloat16, unit and other coefficients, at
every boundary of its split between vectors of 4 elements and single ones
(lengths 0, 1 and 2 below and above multiples of a block's tile, and the
main path's [17920, 2048]), and on views that start off 16 bytes.  Needs
a CUDA card (the ``cuda`` marker; skipped without one) and imports no
JAX:

    python -m pytest -q -m cuda tests/test_torch_decode_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.coded_combine import ops, ref

DTYPES = [torch.float32, torch.bfloat16]
VEC = 4                           # elements a thread (float4, or 4 bf16)
TILE = 256 * VEC                  # elements a block (kDecodeThreads)
# lengths around the vector and around one, two and seven tiles
LENGTHS = sorted({1, 2, 3, VEC - 1, VEC, VEC + 1} | {
    m + k for m in (TILE, 2 * TILE, 7 * TILE) for k in (-2, -1, 0, 1, 2)})


def _per16(dt):
    return 16 // torch.empty((), dtype=dt).element_size()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _coeffs(card, r, unit):
    return (torch.ones(r, device=card) if unit
            else torch.tensor([3.0, -1.5, 0.7, 2.25, -0.3][:r], device=card))


def _at(g, card, dt, off, shape):
    """A view of ``shape`` starting ``off`` elements into a fresh buffer
    (whose base is 16-byte aligned)."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.randn(off + n + 8, generator=g, device=card).to(dt)
    return buf[off:off + n].view(shape)


def _decode_once(f, known, c):
    """One kernel call: launched and counted once, bit-equal to the plain
    version."""
    ops.reset_launch_counts()
    out = ops.coded_decode(f, known, c)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"coded_encode": 0, "coded_decode": 1,
                            "xor_encode": 0, "xor_decode": 0}
    assert out.dtype == f.dtype and out.shape == f.shape
    assert torch.equal(out, ref.decode_ref(f, known, c))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [True, False], ids=["unit", "coeffs"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
def test_decode_kernel_bit_exact_at_every_boundary(card, r, dt, unit):
    g = torch.Generator(device=card).manual_seed(17 * r)
    c = _coeffs(card, r, unit)
    for n in LENGTHS:
        f = torch.randn(n, generator=g, device=card).to(dt)
        known = torch.randn(r - 1, n, generator=g, device=card).to(dt)
        _decode_once(f, known, c)
    ops.reset_launch_counts()
    empty = torch.empty(0, device=card, dtype=dt)
    assert ops.coded_decode(empty, torch.empty(r - 1, 0, device=card,
                                               dtype=dt), c).numel() == 0
    assert ops.LAUNCHES["coded_decode"] == 0      # nothing to launch


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
def test_decode_kernel_bit_exact_at_the_main_path_shape(card, r, dt):
    """[17920, 2048], the shuffle's r = 2 launch shape, with unit and other
    coefficients; the round trip from the encode gives stream 0 back
    within tests/test_kernels.py's tolerance."""
    g = torch.Generator(device=card).manual_seed(r)
    xs = torch.randn(r, 17920, 2048, generator=g, device=card).to(dt)
    for unit in (True, False):
        c = _coeffs(card, r, unit)
        f = ops.coded_encode(xs, c)
        dec = _decode_once(f, xs[1:], c)
        rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 0.15)
        torch.testing.assert_close(dec, xs[0], rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("r", [1, 2, 4, 5])
def test_decode_kernel_bit_exact_on_misaligned_views(card, r, dt):
    """f or the known streams off 16 bytes by 1..3 (fp32) or 1..7 (bf16)
    elements (every element then goes singly), shared or mixed offsets."""
    g = torch.Generator(device=card).manual_seed(100 + r)
    c = _coeffs(card, r, False)
    v = _per16(dt)
    offsets = [(o, o) for o in range(1, v)] + [(0, 1), (1, 0), (v - 1, 2)]
    # a stream stride (n elements) of whole vectors, then one off 16 bytes
    for n in (3 * TILE, 3 * TILE + 5):
        for off_f, off_k in offsets:
            f = _at(g, card, dt, off_f, (n,))
            known = _at(g, card, dt, off_k, (r - 1, n))
            _decode_once(f, known, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_decode_kernel_repeats_its_bits(card, dt):
    g = torch.Generator(device=card).manual_seed(5)
    xs = torch.randn(5, 999, 37, generator=g, device=card).to(dt)
    c = _coeffs(card, 5, False)
    first = _decode_once(xs[0], xs[1:], c)
    assert torch.equal(_decode_once(xs[0], xs[1:], c), first)


@pytest.mark.cuda
def test_plain_decode_divides_truly_on_card(card):
    """The plain version divides by c0 as a device tensor, which ATen
    divides truly (a CPU scalar would become a multiply by its
    reciprocal): its result is the correctly rounded quotient, which a
    multiply by 1/3 misses for some elements."""
    g = torch.Generator(device=card).manual_seed(3)
    f = torch.randn(1 << 16, generator=g, device=card)
    none = torch.empty(0, 1 << 16, device=card)
    c = torch.tensor([3.0], device=card)
    plain = ref.decode_ref(f, none, c)
    exact = (f.double() / 3.0).float()
    assert torch.equal(plain, exact)
    assert not torch.equal(f * (1.0 / 3.0), exact)
    assert torch.equal(ops.coded_decode(f, none, c), exact)
