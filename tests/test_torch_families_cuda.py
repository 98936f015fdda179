"""Hymba, Whisper and LLaVA on the card, held against the CPU's plain
path.  Needs a CUDA card (the ``cuda`` marker; skipped without one) and
imports no JAX, so it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_families_cuda.py

* The SSM's scan on the WKV kernel (``wkv_inclusive``, the ``step``
  route) against the plain ``chunked_linear_recurrence(mode="inclusive")``
  at Hymba's head widths (Nk 16, Nv 64), prefill and decode's S = 1, fp32:
  3e-4, the WKV step kernel's fp32 tolerance in chip_smoke.py.
* The ring decode on flash's ``split_kv`` route (``ring_decode_attention``)
  against the position-masked ``ring_cache_attention`` at every step
  across two wraps, fp32: 2e-5.
* Flash at the three families' new masks: a sliding window over a prompt
  longer than the window, bidirectional at one query head per kv head over
  a key count off the 64-key tile, cross attention with every query at
  position 0 (no causal cut), bf16 on the tensor cores: 2e-2.
* The reduced hymba, whisper and llava models, fp32 with TF32 off: the
  same greedy tokens on card and CPU and logits within 1e-4; per forward
  one flash launch per attention (whisper: encoder, self and cross) and
  one WKV launch per Hymba layer, and no plain call.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv_scan import ops as rw
from repro_torch.models import attention, frontends, linrec, lm, ssm
from repro_torch.serve import engine

FAMILIES = ("hymba-1.5b", "whisper-large-v3", "llava-next-34b")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(card):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield card
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(2, 300), (4, 1)])
def test_wkv_inclusive_on_card_matches_plain(no_tf32, B, S):
    h, Nk, Nv = 5, 16, 64
    g = torch.Generator(device=no_tf32).manual_seed(S)
    rnd = lambda *s: torch.randn(s, generator=g, device=no_tf32)
    q = rnd(B, S, h, Nk)
    dt = torch.nn.functional.softplus(rnd(B, S, h))
    A = -torch.linspace(1.0, float(Nk), Nk, device=no_tf32)
    k, v = rnd(B, S, h, Nk) * dt[..., None], rnd(B, S, h, Nv)
    log_w, s0 = dt[..., None] * A, 0.1 * rnd(B, h, Nk, Nv)
    rw.reset_launch_counts()
    out, st = ssm.inclusive_scan(q, k, v, log_w, s0)
    # a prefill on the inclusive chunk_f32 kernels, a decode step on step
    want = "chunk_f32" if S >= rw.CHUNK_MIN_SEQ else "step"
    assert rw.LAUNCHES["wkv_scan"] == 1 and rw.ROUTE_CALLS[want] == 1
    assert rw.PLAIN_CALLS["wkv_scan"] == 0
    want, want_st = linrec.chunked_linear_recurrence(
        q, k, v, log_w, initial_state=s0, mode="inclusive", chunk=16,
        return_state=True)
    torch.testing.assert_close(out, want, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(st, want_st, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_ring_decode_on_split_kv_matches_ring_attention(no_tf32):
    B, Wc, KV, G, hd, n_pre, S = 2, 32, 2, 5, 64, 40, 110
    g = torch.Generator(device=no_tf32).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=no_tf32)
    k_all, v_all = rnd(B, S, KV, hd), rnd(B, S, KV, hd)
    ring_k, ring_v = (torch.zeros(B, Wc, KV, hd, device=no_tf32)
                      for _ in range(2))
    kpos = torch.full((Wc,), -1, dtype=torch.int32, device=no_tf32)
    pw = torch.arange(n_pre, device=no_tf32)[-Wc:]
    ring_k[:, pw % Wc], ring_v[:, pw % Wc] = k_all[:, pw], v_all[:, pw]
    kpos[pw % Wc] = pw.int()
    for pos in range(n_pre, S):
        ring_k[:, pos % Wc], ring_v[:, pos % Wc] = k_all[:, pos], \
            v_all[:, pos]
        kpos[pos % Wc] = pos
        q = rnd(B, 1, KV * G, hd)
        fa.reset_launch_counts()
        got = attention.ring_decode_attention(q, ring_k, ring_v, pos)
        assert fa.ROUTE_CALLS["split_kv"] == 1
        want = attention.ring_cache_attention(
            q, ring_k, ring_v, kpos, torch.tensor([pos], device=no_tf32),
            window=Wc)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# (B, Sq, Sk, H, KV, hd, causal, window, q_positions): Hymba's window
# biting over a longer prompt, Whisper's bidirectional encoder at G = 1
# over 1,500 keys and its cross attention (all queries at 0)
MASK_CASES = [(1, 640, 640, 25, 5, 64, True, 512, None),
              (1, 1500, 1500, 20, 20, 64, False, None, None),
              (2, 100, 1500, 20, 20, 64, False, None, "zeros")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MASK_CASES)
def test_flash_family_masks_match_plain(card, case):
    B, Sq, Sk, H, KV, hd, causal, window, qp = case
    g = torch.Generator(device=card).manual_seed(Sq)
    q, k, v = (torch.randn(B, n, h, hd, generator=g, device=card)
               .bfloat16() for n, h in ((Sq, H), (Sk, KV), (Sk, KV)))
    pos = (torch.zeros(Sq, dtype=torch.int64, device=card) if qp
           else torch.arange(Sq, device=card))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_positions=pos)
    assert fa.ROUTE_CALLS["tensor_core"] == 1
    want = fa_ref.attention_ref(q, k, v, pos, None, causal=causal,
                                window=window)
    torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)


def _flash_per_forward(cfg):
    return (cfg.encoder_layers + 2 * cfg.n_layers
            if cfg.family == "encdec" else cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_family_on_card_matches_cpu(no_tf32, name):
    cfg = get_arch(name).reduced()
    p_cpu = lm.init_params(0, cfg, device="cpu")
    p_gpu = _to(p_cpu, no_tf32)
    front = frontends.frontend_inputs(torch.Generator().manual_seed(1),
                                      cfg, 2)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    toks = torch.as_tensor(prompts).long()
    with torch.inference_mode():
        want = lm.forward(p_cpu, cfg, toks, **front)[0]
        for m in (fa, rw):
            m.reset_launch_counts()
        got = lm.forward(p_gpu, cfg, toks.to(no_tf32),
                         **_to(front, no_tf32))[0]
    assert fa.LAUNCHES["flash_attention"] == (
        0 if cfg.attn_free else _flash_per_forward(cfg))
    assert rw.LAUNCHES["wkv_scan"] == (cfg.n_layers if cfg.ssm else 0)
    assert fa.PLAIN_CALLS["flash_attention"] == rw.PLAIN_CALLS["wkv_scan"] \
        == 0
    assert float((got.cpu() - want).abs().max()) < 1e-4
    # greedy through the engines; hymba's 40-token prompts and 30 new
    # tokens wrap its 16-slot ring
    cpu_eng = engine.ServeEngine(cfg, p_cpu, 2, 96, device="cpu")
    gpu_eng = engine.ServeEngine(cfg, p_gpu, 2, 96)
    a = cpu_eng.generate(prompts, 30, **front)
    for m in (fa, rw):
        m.reset_launch_counts()
    b = gpu_eng.generate(prompts, 30, **front)
    np.testing.assert_array_equal(a, b)
    assert fa.PLAIN_CALLS["flash_attention"] == rw.PLAIN_CALLS["wkv_scan"] \
        == 0
