"""The WKV backward's ``chunk`` route on the card
(``csrc/wkv_backward_chunk.cuh``) against its plain versions: the mirror
``ref.wkv_backward_chunk_ref`` (the same chunks, blocks and split TF32
rounding) and autograd through the chunked recurrence
(``ref.wkv_backward_ref``), at ragged sequence lengths, on strided views,
at RWKV's and Hymba's decays, bit for bit twice, with its launch and route
counts.  Needs a CUDA card (the ``cuda`` marker; skipped without one) and
imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_wkv_backward_chunk_cuda.py

Tolerances: gradients relative to the tensor's largest |gradient|: 1e-4
against autograd in fp32 (chip_smoke.py's BWD_TOL), 2e-5 against the
mirror (the same arithmetic but for the tensor cores' accumulation order
and exp2f's last bits), 2e-2 in bf16 (gradients rounded to 2^-8)."""
import pytest
import torch

from repro_torch.kernels.rwkv_scan import backward as rwb
from repro_torch.kernels.rwkv_scan import ref as rw_ref

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MIRROR_TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _inputs(card, B, S, h, Nk, Nv, seed, decay="rwkv",
            dtype=torch.float32):
    g = torch.Generator(device=card).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=card, generator=g)
    k, v, dout = 0.5 * mk(B, S, h, Nk), mk(B, S, h, Nv), mk(B, S, h, Nv)
    if decay == "hymba":
        dt = torch.nn.functional.softplus(mk(B, S, h))
        log_w = dt[..., None] * -torch.linspace(1.0, 16.0, Nk, device=card)
        r = mk(B, S, h, Nk) * torch.exp(log_w)
        u = torch.zeros(h, Nk, device=card)
    else:
        log_w = -torch.exp(mk(B, S, h, Nk) - 1.0)
        r, u = 0.5 * mk(B, S, h, Nk), 0.5 * mk(h, Nk)
    return (r.to(dtype), k.to(dtype), v.to(dtype), log_w, u,
            dout.to(dtype))


SHAPES = [  # B, S, h, Nk, Nv: one chunk, ragged, RWKV's and Hymba's heads,
    # widths off the kernel's instances and off 4
    (1, 64, 2, 16, 64), (2, 65, 3, 64, 64), (1, 127, 2, 16, 16),
    (2, 130, 2, 64, 64), (1, 1000, 2, 16, 64), (1, 2049, 1, 64, 64),
    (2, 97, 2, 5, 7), (1, 200, 2, 32, 48), (1, 150, 2, 40, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["rwkv", "hymba"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_route_matches_its_plain_versions(card, shape, decay):
    x = _inputs(card, *shape, seed=sum(shape), decay=decay)
    rwb.reset_launch_counts()
    got = rwb.wkv_scan_backward(*x)
    again = rwb.wkv_scan_backward(*x)
    assert rwb.LAUNCHES["wkv_scan_backward"] == 2
    assert rwb.ROUTE_CALLS == {"chunk": 2, "step": 0}
    assert rwb.PLAIN_CALLS["wkv_scan_backward"] == 0
    mirror = rw_ref.wkv_backward_chunk_ref(*x)
    plain = rw_ref.wkv_backward_ref(*x, chunk=16)
    for a, a2, m, p in zip(got, again, mirror, plain):
        assert a.dtype == p.dtype and a.shape == p.shape
        assert a.is_contiguous()
        assert torch.equal(a, a2)
        assert _rel(a, m) < MIRROR_TOL
        assert _rel(a, p) < TOL[torch.float32]


@pytest.mark.cuda
def test_chunk_route_reads_strided_views_as_their_copies(card):
    """Views of fused projections (strides of batch, time and head as they
    are, a base off 16 bytes) give the bits of their contiguous copies."""
    B, S, h, Nk, Nv = 2, 300, 3, 64, 64
    g = torch.Generator(device=card).manual_seed(9)
    fused = 0.5 * torch.randn(B, S, h, 2 * Nk + 1, device=card,
                              generator=g)
    r, k = fused[..., 1:Nk + 1], fused[..., Nk + 1:]
    log_w = -torch.exp(torch.randn(B, S, h, Nk, device=card, generator=g)
                       - 1.0)
    vd = torch.randn(B, S, 2 * h, Nv, device=card, generator=g)
    v, dout = vd[:, :, :h], vd[:, :, h:]
    u = 0.5 * torch.randn(h, Nk, device=card, generator=g)
    assert not any(t.is_contiguous() for t in (r, k, v, dout))
    got = rwb.wkv_scan_backward(r, k, v, log_w, u, dout)
    want = rwb.wkv_scan_backward(*(t.contiguous() for t in
                                   (r, k, v, log_w, u, dout)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 67, 2, 64, 64), (1, 300, 2, 16, 64)],
                         ids=str)
def test_chunk_route_in_bf16(card, shape):
    x = _inputs(card, *shape, seed=5, dtype=torch.bfloat16)
    rwb.reset_launch_counts()
    got = rwb.wkv_scan_backward(*x)
    assert rwb.ROUTE_CALLS == {"chunk": 1, "step": 0}
    want = rw_ref.wkv_backward_ref(*x)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert _rel(a, b) < TOL[torch.bfloat16]


@pytest.mark.cuda
def test_shapes_off_the_route_take_the_step_kernels(card):
    rwb.reset_launch_counts()
    for shape in [(1, 63, 2, 64, 64), (1, 100, 1, 128, 64),
                  (1, 100, 1, 64, 100)]:
        x = _inputs(card, *shape, seed=1)
        got = rwb.wkv_scan_backward(*x)
        want = rw_ref.wkv_backward_ref(*x)
        for a, b in zip(got, want):
            assert _rel(a, b) < TOL[torch.float32]
    assert rwb.ROUTE_CALLS == {"chunk": 0, "step": 3}


@pytest.mark.cuda
def test_train_shape_matches_the_plain_version(card):
    """RWKV6-3B's microbatch in its full-width train step."""
    x = _inputs(card, 4, 2048, 40, 64, 64, seed=3)
    got = rwb.wkv_scan_backward(*x)
    want = rw_ref.wkv_backward_ref(*x, chunk=16)
    for a, b in zip(got, want):
        assert _rel(a, b) < TOL[torch.float32]


def _recurrence64(r, k, v, log_w, u, dout):
    """The gradients of a float64 step-by-step recurrence."""
    xs = [t.double().requires_grad_() for t in (r, k, v, log_w, u)]
    r, k, v, log_w, u = xs
    B, S, h, Nk = r.shape
    state = torch.zeros(B, h, Nk, v.shape[-1], dtype=torch.float64,
                        device=r.device)
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(((state + u[None, :, :, None] * kv)
                     * r[:, t, :, :, None]).sum(-2))
        state = torch.exp(log_w[:, t, :, :, None]) * state + kv
    return torch.autograd.grad(torch.stack(outs, 1), xs, dout.double())


@pytest.mark.cuda
def test_strong_decays_stay_finite(card):
    """log_w = -exp(4 N(0, 1)) reaches -1e5: every gate underflows to 0
    and nothing is divided by one.  Held to a float64 recurrence: the
    plain chunked form's exponents are differences of running sums, which
    at these decays cancel."""
    x = list(_inputs(card, 1, 200, 2, 64, 64, seed=4))
    g = torch.Generator(device=card).manual_seed(4)
    x[3] = -torch.exp(4.0 * torch.randn(x[3].shape, device=card,
                                        generator=g))
    got = rwb.wkv_scan_backward(*x)
    mirror = rw_ref.wkv_backward_chunk_ref(*x)
    want = _recurrence64(*x)
    for a, m, b in zip(got, mirror, want):
        assert torch.isfinite(a).all()
        assert _rel(a, m) < MIRROR_TOL
        assert _rel(a, b) < TOL[torch.float32]
