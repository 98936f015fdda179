"""The port's coded-combine ops against the JAX package's (Pallas kernels in
interpret mode) and against their plain versions, on the grid and
tolerances of tests/test_kernels.py.  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_combine import ops as j_ops
from repro_torch.kernels.coded_combine import ops, ref

SHAPES = [(64, 128), (100, 96), (257, 40), (1, 7), (300, 130)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
INT_DTYPES = {"int32": np.int32, "uint32": np.uint32}


def _streams(r, T, d, seed):
    return np.random.default_rng(seed).normal(size=(r, T, d)).astype(
        np.float32)


def _to_np(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("T,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_coded_encode_decode_match_jax(r, T, d, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _streams(r, T, d, seed=100 * r + T)
    coeffs = np.arange(1.0, r + 1.0, dtype=np.float32)
    ts = [torch.from_numpy(v).to(tdt) for v in x]
    js = [jnp.asarray(v).astype(jdt) for v in x]
    f = ops.coded_encode(ts, torch.from_numpy(coeffs))
    jf = j_ops.coded_encode(js, jnp.asarray(coeffs))
    assert f.shape == (T, d) and f.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_to_np(f), np.asarray(jf, np.float32),
                               rtol=tol, atol=tol)
    # the stacked [r, T, d] form is the same op with no stacking copy
    np.testing.assert_array_equal(
        _to_np(ops.coded_encode(torch.stack(ts), coeffs)), _to_np(f))
    np.testing.assert_array_equal(
        _to_np(f), _to_np(ref.encode_ref(torch.stack(ts),
                                         torch.from_numpy(coeffs))))
    # decode stream 0 from f + streams[1:] (tolerances of test_kernels)
    dec = ops.coded_decode(f, ts[1:], torch.from_numpy(coeffs))
    rtol, atol = (1e-2, 0.15) if dtype == "bfloat16" else (1e-4, 1e-4)
    np.testing.assert_allclose(_to_np(dec), _to_np(ts[0]), rtol=rtol,
                               atol=atol)
    jdec = j_ops.coded_decode(jnp.asarray(_to_np(f)).astype(jdt), js[1:],
                              jnp.asarray(coeffs))
    np.testing.assert_allclose(_to_np(dec), np.asarray(jdec, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("T,d", [(64, 128), (1, 7), (257, 40)])
def test_unit_coefficient_f32_is_exact(r, T, d):
    """The shuffle's case: unit coefficients on integer-valued float32 are
    exact in every order, so port and JAX agree bit for bit."""
    x = np.random.default_rng(r).integers(-1000, 1000, size=(r, T, d)
                                          ).astype(np.float32)
    ones = np.ones(r, np.float32)
    f = ops.coded_encode(torch.from_numpy(x), torch.from_numpy(ones))
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(j_ops.coded_encode(list(x), jnp.asarray(ones))))
    dec = ops.coded_decode(f, torch.from_numpy(x[1:]), ones)
    np.testing.assert_array_equal(dec.numpy(), x[0])


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("T,d", [(80, 64), (1, 7), (257, 40)])
@pytest.mark.parametrize("dtype", list(INT_DTYPES))
def test_xor_roundtrip_matches_jax(r, T, d, dtype):
    x = np.random.default_rng(10 + r).integers(
        0, 2 ** 30, size=(r, T, d)).astype(INT_DTYPES[dtype])
    ts = [torch.from_numpy(v) for v in x]
    f = ops.xor_encode(ts)
    assert f.dtype == ts[0].dtype
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(j_ops.xor_encode([jnp.asarray(v) for v in x])))
    np.testing.assert_array_equal(
        f.numpy(), ref.xor_encode_ref(torch.from_numpy(x)).numpy())
    dec = ops.xor_decode(f, ts[1:])
    np.testing.assert_array_equal(dec.numpy(), x[0])
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(j_ops.xor_decode(jnp.asarray(f.numpy()),
                                                 [jnp.asarray(v)
                                                  for v in x[1:]])))


def test_ops_raise_off_cpu_and_cuda():
    """No silent path: a tensor on neither the CPU nor a CUDA device is
    refused, as are known streams that do not match f and an empty
    stream stack."""
    x = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        ops.coded_encode(x, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        ops.xor_encode(x.to(torch.int32))
    with pytest.raises(ValueError, match="match f"):
        ops.coded_decode(torch.zeros(4, 8), torch.zeros(1, 4, 9),
                         torch.ones(2))
    with pytest.raises(ValueError, match="match f"):
        ops.xor_decode(torch.zeros(4, 8, dtype=torch.int32),
                       torch.zeros(1, 4, 8, dtype=torch.int32,
                                   device="meta"))
    with pytest.raises(ValueError, match="at least one stream"):
        ops.coded_encode(torch.zeros(0, 4, 8), torch.ones(0))
