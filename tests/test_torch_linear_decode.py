"""The port's ``coded_decode`` on the CPU against the JAX package's (the
Pallas kernel in interpret mode) at the arities and widths
tests/test_torch_coded_combine.py leaves out: r = 5 (the CUDA kernel's
runtime stream count) and widths that are not multiples of the TPU's 128
lanes; and on misaligned views.  Integer-valued payloads are bit-exact,
random ones within the tolerances of tests/test_kernels.py.  The CUDA
kernel itself is held bit for bit against the plain version on the card,
at every boundary of its split between 16-byte vectors and single
elements, in tests/test_torch_decode_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_combine import ops as j_ops
from repro_torch.kernels.coded_combine import ops, ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# no width a multiple of the TPU's 128 lanes
SHAPES = [(3, 7), (65, 130), (9, 200), (40, 257)]
# tests/test_kernels.py's decode tolerances (rtol, atol)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 0.15)}


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


def _to_np(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _coeffs(r, unit):
    return (np.ones(r, np.float32) if unit
            else np.arange(2.0, r + 2.0, dtype=np.float32))


def _jax_decode(f, known, c, jdt):
    return np.asarray(j_ops.coded_decode(
        jnp.asarray(_to_np(f)).astype(jdt),
        [jnp.asarray(_to_np(x)).astype(jdt) for x in known],
        jnp.asarray(c)).astype(jnp.float32))


@pytest.mark.parametrize("unit", [True, False], ids=["unit", "coeffs"])
@pytest.mark.parametrize("T,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_integer_payloads_bit_exact_with_jax_at_r5(dtype, T, d, unit):
    """Integer-valued streams and packet: every product, difference and the
    division by c0 = 1 or 2 is exact in fp32 and in bf16, so both packages
    give the same bits."""
    tdt, jdt = DTYPES[dtype]
    r = 5
    c = _coeffs(r, unit)
    rng = np.random.default_rng(T * d + r)
    # |f| <= 8 * (2 + ... + 6) = 160: every integer bf16 holds exactly
    x = rng.integers(-8, 9, size=(r, T, d)).astype(np.float32)
    # the packet of integers whose decode is x[0] exactly: sum_i c_i x_i
    f_np = np.tensordot(c, x, axes=1).astype(np.float32)
    f = torch.from_numpy(f_np).to(tdt)
    known = torch.from_numpy(x[1:]).to(tdt)
    dec = ops.coded_decode(f, known, torch.from_numpy(c))
    assert dec.dtype == tdt and dec.shape == (T, d)
    np.testing.assert_array_equal(_to_np(dec), x[0])
    np.testing.assert_array_equal(_to_np(dec), _jax_decode(f, known, c, jdt))


@pytest.mark.parametrize("unit", [True, False], ids=["unit", "coeffs"])
@pytest.mark.parametrize("T,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_random_payloads_match_jax_at_r5(dtype, T, d, unit):
    tdt, jdt = DTYPES[dtype]
    r = 5
    c = _coeffs(r, unit)
    x = np.random.default_rng(7 * T + d).normal(size=(r, T, d)).astype(
        np.float32)
    xs = torch.from_numpy(x).to(tdt)
    f = ops.coded_encode(xs, torch.from_numpy(c))
    dec = ops.coded_decode(f, xs[1:], torch.from_numpy(c))
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(_to_np(dec), _jax_decode(f, xs[1:], c, jdt),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(_to_np(dec), _to_np(xs[0]), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_r1_divides_the_packet(dtype):
    """r = 1: no known stream, the packet over c0 (the JAX op cannot stack
    zero known streams, so the plain version is the reference)."""
    tdt, _ = DTYPES[dtype]
    f = torch.from_numpy(np.random.default_rng(1).normal(
        size=(33, 130)).astype(np.float32)).to(tdt)
    known = torch.empty((0, 33, 130), dtype=tdt)
    c = torch.tensor([3.0])
    dec = ops.coded_decode(f, known, c)
    assert torch.equal(dec, (f.float() / 3.0).to(tdt))
    assert torch.equal(dec, ref.decode_ref(f, known, c))


@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_on_misaligned_cpu_views(r, dtype):
    """Views that start 1..V-1 elements into a buffer (V = 4 fp32, 8 bf16
    elements per 16 bytes) take the plain version on the CPU and give its
    bits."""
    tdt, _ = DTYPES[dtype]
    per16 = 16 // torch.empty((), dtype=tdt).element_size()
    rng = np.random.default_rng(r)
    n = 61
    buf = torch.from_numpy(rng.normal(size=(r + 1) * n + per16).astype(
        np.float32)).to(tdt)
    c = torch.from_numpy(_coeffs(r, False))
    for off in range(per16):
        f = buf[off:off + n]
        known = buf[off + n:off + r * n].view(r - 1, n)
        np.testing.assert_array_equal(
            _to_np(ops.coded_decode(f, known, c)),
            _to_np(ref.decode_ref(f, known, c)))
