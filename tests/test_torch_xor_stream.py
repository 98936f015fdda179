"""The port's XOR ops on the CPU against the JAX package's (Pallas kernels
in interpret mode) at the arities tests/test_torch_coded_combine.py does
not cover, and on misaligned views.  The CUDA kernel itself is held
against the plain versions on the card, at every boundary of its split
between 16-byte vectors and single words, in
tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_combine import ops as j_ops
from repro_torch.kernels.coded_combine import ops, ref

INT_DTYPES = {"int32": np.int32, "uint32": np.uint32}
# no width a multiple of the TPU's 128 lanes
SHAPES = [(3, 7), (65, 130), (9, 200)]


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)


@pytest.mark.parametrize("r", [1, 4, 5])
@pytest.mark.parametrize("T,d", SHAPES)
@pytest.mark.parametrize("dtype", list(INT_DTYPES))
def test_xor_ops_match_jax(r, T, d, dtype):
    x = np.random.default_rng(100 * r + T).integers(
        0, 2 ** 32, size=(r, T, d), dtype=np.uint64).astype(
            INT_DTYPES[dtype])
    f = ops.xor_encode(torch.from_numpy(x))
    assert f.dtype == torch.from_numpy(x).dtype and f.shape == (T, d)
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(j_ops.xor_encode([jnp.asarray(v) for v in x])))
    dec = ops.xor_decode(f, torch.from_numpy(x[1:]))
    np.testing.assert_array_equal(dec.numpy(), x[0])
    if r > 1:       # the JAX op cannot stack zero known streams
        np.testing.assert_array_equal(
            dec.numpy(), np.asarray(j_ops.xor_decode(
                jnp.asarray(f.numpy()), [jnp.asarray(v) for v in x[1:]])))


@pytest.mark.parametrize("r", [1, 2, 5])
def test_xor_ops_on_misaligned_cpu_views(r):
    """Views that start 1-3 words into a buffer take the plain version on
    the CPU and give its bits."""
    rng = np.random.default_rng(r)
    buf = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=4 * r * 51 + 8,
                                        dtype=np.int64).astype(np.int32))
    for off in range(4):
        xs = buf[off:off + r * 51].view(r, 51)
        np.testing.assert_array_equal(
            ops.xor_encode(xs).numpy(), ref.xor_encode_ref(xs).numpy())
        np.testing.assert_array_equal(
            ops.xor_decode(xs[0], xs[1:]).numpy(),
            ref.xor_decode_ref(xs[0], xs[1:]).numpy())
