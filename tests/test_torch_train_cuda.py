"""Training on the card: the two LM kernels' autograd ``Function``s and
their hand-written backward kernels (``flash_attention/csrc/
flash_backward.cu``, ``rwkv_scan/csrc/wkv_backward.cu``) against autograd
through the plain versions, and one train step on the card against the
CPU.  Needs a CUDA card (the ``cuda`` marker; skipped without one) and
imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances: gradients relative to the largest |gradient| of the tensor,
1e-4 in fp32 (fp32 FMAs in other orders; the worst seen on the H100 was
6.6e-6) and 2e-2 in bf16 (the gradients are rounded to bf16, 2^-8, and the
saved bf16 output enters D = dO . O)."""
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels.flash_attention import backward as fab
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv_scan import backward as rwb
from repro_torch.kernels.rwkv_scan import ops as rw
from repro_torch.kernels.rwkv_scan import ref as rw_ref
from repro_torch.train import trainer
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       make_train_step)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


@pytest.mark.cuda
def test_flash_attention_is_differentiable_on_the_card(card):
    """The fault this slice repairs: the card's output was written through
    ctypes into a tensor autograd did not know.  Now autograd.grad of the
    op's sum reaches q, k and v through the backward kernel."""
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(2, 40, 6, 32, device=card, generator=g,
                    requires_grad=True)
    k = torch.randn(2, 40, 2, 32, device=card, generator=g,
                    requires_grad=True)
    v = torch.randn(2, 40, 2, 32, device=card, generator=g,
                    requires_grad=True)
    fab.reset_launch_counts()
    got = torch.autograd.grad(fa.flash_attention(q, k, v).sum(), (q, k, v))
    assert fab.LAUNCHES["flash_attention_backward"] == 1
    pos = torch.arange(40, device=card)
    want = torch.autograd.grad(fa_ref.attention_ref(q, k, v, pos).sum(),
                               (q, k, v))
    for a, b in zip(got, want):
        assert _rel(a, b) < TOL[torch.float32]


FLASH_CASES = [  # B, Sq, Sk, H, KV, hd, causal, window, positions, dtype
    (2, 37, 37, 6, 2, 50, True, None, None, torch.float32),
    (1, 70, 45, 4, 4, 16, False, None, None, torch.float32),   # cross
    (2, 33, 33, 8, 1, 576, True, None, None, torch.float32),   # MLA hd
    (2, 45, 45, 4, 2, 200, True, 7, None, torch.bfloat16),     # window
    (1, 20, 30, 2, 1, 64, True, None, "shifted", torch.float32),
    (1, 17, 17, 2, 2, 128, True, 5, None, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_plain(card, case):
    B, Sq, Sk, H, KV, hd, causal, window, pos, dtype = case
    g = torch.Generator(device=card).manual_seed(1)
    mk = lambda *s: torch.randn(*s, device=card, generator=g).to(dtype)
    q, k, v, dout = mk(B, Sq, H, hd), mk(B, Sk, KV, hd), mk(B, Sk, KV, hd), \
        mk(B, Sq, H, hd)
    # "shifted": the first queries sit before every key (no visible key:
    # uniform weights in the forward, a share of dV only)
    qp = (torch.arange(Sq, device=card) - 10 if pos == "shifted"
          else torch.arange(Sq, device=card))
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 q_positions=qp)
    got = fab.flash_attention_backward(q, k, v, out, dout, causal=causal,
                                       window=window, q_positions=qp)
    again = fab.flash_attention_backward(q, k, v, out, dout, causal=causal,
                                         window=window, q_positions=qp)
    want = fa_ref.attention_backward_ref(q, k, v, dout, qp, causal=causal,
                                         window=window)
    for a, a2, b in zip(got, again, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, a2)
        assert _rel(a, b) < TOL[dtype]


WKV_CASES = [  # B, S, h, Nk, Nv, dtype
    (2, 45, 3, 5, 7, torch.float32), (1, 100, 2, 16, 64, torch.float32),
    (2, 67, 2, 64, 64, torch.bfloat16), (1, 40, 1, 128, 256, torch.float32),
    (1, 33, 2, 64, 200, torch.float32), (1, 50, 1, 128, 100, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_backward_matches_plain(card, case):
    B, S, h, Nk, Nv, dtype = case
    g = torch.Generator(device=card).manual_seed(2)
    mk = lambda *s: torch.randn(*s, device=card, generator=g)
    r, k = (0.5 * mk(B, S, h, Nk)).to(dtype), (0.5 * mk(B, S, h, Nk)).to(
        dtype)
    v, dout = mk(B, S, h, Nv).to(dtype), mk(B, S, h, Nv).to(dtype)
    log_w, u = -torch.exp(mk(B, S, h, Nk) - 1.0), 0.5 * mk(h, Nk)
    got = rwb.wkv_scan_backward(r, k, v, log_w, u, dout)
    again = rwb.wkv_scan_backward(r, k, v, log_w, u, dout)
    want = rw_ref.wkv_backward_ref(r, k, v, log_w, u, dout)
    for a, a2, b in zip(got, again, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, a2)
        assert _rel(a, b) < TOL[dtype]


@pytest.mark.cuda
def test_wkv_strong_decays_stay_finite(card):
    """log_w = -exp(w0 + lora) is unbounded below: exp(log_w) underflows
    to 0 and the backward never divides by it."""
    g = torch.Generator(device=card).manual_seed(3)
    mk = lambda *s: torch.randn(*s, device=card, generator=g)
    r, k, v, dout = mk(1, 64, 2, 16), mk(1, 64, 2, 16), mk(1, 64, 2, 16), \
        mk(1, 64, 2, 16)
    log_w = -torch.exp(4.0 * mk(1, 64, 2, 16))
    for x in rwb.wkv_scan_backward(r, k, v, log_w, 0.1 * mk(2, 16), dout):
        assert torch.isfinite(x).all()


@pytest.mark.cuda
def test_wkv_is_differentiable_on_the_card(card):
    g = torch.Generator(device=card).manual_seed(4)
    mk = lambda *s: torch.randn(*s, device=card, generator=g,
                                requires_grad=True)
    r, k, v = mk(2, 40, 3, 16), mk(2, 40, 3, 16), mk(2, 40, 3, 16)
    lw = (-torch.exp(torch.randn(2, 40, 3, 16, device=card,
                                 generator=g))).requires_grad_()
    u = mk(3, 16)
    rwb.reset_launch_counts()
    out, _ = rw.wkv_scan(r, k, v, lw, u)
    got = torch.autograd.grad(out.square().sum(), (r, k, v, lw, u))
    assert rwb.LAUNCHES["wkv_scan_backward"] == 1
    from repro_torch.models.linrec import chunked_linear_recurrence
    o2, _ = chunked_linear_recurrence(r, k, v, lw, u=u)
    want = torch.autograd.grad(o2.square().sum(), (r, k, v, lw, u))
    for a, b in zip(got, want):
        assert _rel(a, b) < TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b", "hymba-1.5b"])
def test_train_step_card_against_cpu(card, arch, monkeypatch):
    """One AdamW step of the reduced model from the same weights and batch:
    loss within 1e-5; the gradients each step hands its optimizer, each
    leaf within 1e-4 of its own largest entry (or of 1e-3 of the tree's
    largest, where the leaf is smaller); the card's updated parameters
    within 1e-4 of each leaf's update of the CPU optimizer fed the card's
    gradients, and within 1e-4 of the CPU's step (Adam's first step
    normalises each gradient element, so near-zero gradients carry the
    devices' roundoff into the step: see tests/test_torch_train.py); and
    the card's step through the kernels."""
    seen = []
    real_update = trainer.optimizer_update

    def recording_update(grads, *rest):
        seen.append(grads)
        return real_update(grads, *rest)
    monkeypatch.setattr(trainer, "optimizer_update", recording_update)
    cfg = get_arch(arch).reduced()
    tc = TrainConfig(n_microbatches=2, remat=True, dense_moe=True,
                     opt=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                         decay_steps=50))
    cpu = init_train_state(0, cfg, tc, device="cpu")
    gpu = _to(cpu, card)
    batch = SyntheticPipeline(cfg, 4, 32, device="cpu").batch_at(0)
    step = make_train_step(cfg, tc)
    new_cpu, m_cpu = step(cpu, batch)
    for mod in (fa, rw, fab, rwb):
        mod.reset_launch_counts()
    new_gpu, m_gpu = step(gpu, _to(batch, card))
    torch.cuda.synchronize()
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= 1e-5 * abs(
        float(m_cpu["loss"]))
    bwd = (fab.LAUNCHES["flash_attention_backward"]
           + rwb.LAUNCHES["wkv_scan_backward"])
    assert bwd > 0 and not any(fa.PLAIN_CALLS.values())
    g_cpu, g_gpu = (tree_leaves(g) for g in seen)
    floor = 1e-3 * max(float(w.abs().max()) for w in g_cpu)
    for a, w in zip(g_gpu, g_cpu):
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), floor)
    ref, _, _ = real_update(_to(seen[1], "cpu"), cpu["opt"], cpu["params"],
                            tc.opt)
    for a, r, o in zip(tree_leaves(new_gpu["params"]), tree_leaves(ref),
                       tree_leaves(cpu["params"])):
        assert float((a.cpu() - r).abs().max()) <= 1e-4 * max(
            float((r - o).abs().max()), 1e-3 * tc.opt.lr)
    for a, b in zip(tree_leaves(new_gpu["params"]),
                    tree_leaves(new_cpu["params"])):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
