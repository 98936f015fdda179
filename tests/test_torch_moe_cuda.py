"""The MoE family on the card: MLA attention through the flash kernel and
the sorted expert dispatch, held against the CPU's plain path.  Needs a
CUDA card (the ``cuda`` marker; skipped without one) and imports no JAX,
so it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

* MLA prefill and decode at deepseek-v2-lite's ``reduced()`` config on
  the card (flash on ``mma_tf32`` and ``split_kv``) against the CPU plain
  path, fp32 with TF32 off, within 1e-4.
* The sorted dispatch at deepseek-v2-lite's full layer widths in bf16
  (64 experts, top 6, d 2048; prefill and decode token counts) gives
  bit-identical outputs over two runs: it gathers, never adds atomically.
* One flash launch per layer per forward, prefill and decode step, and no
  plain call; the reduced MoE models' greedy tokens equal on card and CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import lm, mla, moe
from repro_torch.serve import engine

MOE_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")


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
def test_mla_prefill_and_decode_on_card_match_cpu(no_tf32):
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    p = mla.init_mla_params(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu")
    pg = _to(p, no_tf32)
    B, S, n_dec, max_seq = 2, 37, 3, 48
    x = torch.randn(B, S + n_dec, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    caches = [mla.init_mla_cache(cfg, B, max_seq, torch.float32, dev)
              for dev in ("cpu", no_tf32)]
    for start, n in [(0, S)] + [(S + i, 1) for i in range(n_dec)]:
        pos = torch.arange(start, start + n)
        want, caches[0] = mla.mla_attention(p, cfg, x[:, start:start + n],
                                            pos, cache=caches[0],
                                            cache_index=start)
        fa.reset_launch_counts()
        got, caches[1] = mla.mla_attention(
            pg, cfg, x[:, start:start + n].to(no_tf32), pos.to(no_tf32),
            cache=caches[1], cache_index=start)
        torch.cuda.synchronize()
        route = "mma_tf32" if n > 1 else "split_kv"
        assert fa.LAUNCHES["flash_attention"] == 1
        assert fa.ROUTE_CALLS[route] == 1 and fa.PLAIN_CALLS[
            "flash_attention"] == 0
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(caches[1]["latent"].cpu(),
                                   caches[0]["latent"], rtol=1e-5,
                                   atol=1e-5)
    # no cache: the prompt's own latent
    want, _ = mla.mla_attention(p, cfg, x, torch.arange(S + n_dec))
    got, _ = mla.mla_attention(pg, cfg, x.to(no_tf32),
                               torch.arange(S + n_dec, device=no_tf32))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 2048])
def test_sorted_dispatch_is_bitwise_repeatable_on_card(card, T):
    """Full deepseek-v2-lite layer widths, bf16: at T = 8 (decode slots,
    capacity 1, collisions drop) and T = 2048 (prefill)."""
    full = ARCHS["deepseek-v2-lite-16b"]
    gen = torch.Generator(device=card).manual_seed(T)
    p = moe.init_moe_params(gen, full, torch.bfloat16, card)
    assert p["router"].dtype == torch.float32
    x = torch.randn(T, full.d_model, generator=gen, device=card).to(
        torch.bfloat16)
    a = moe.moe_ffn_sorted(p, full.moe, x)
    b = moe.moe_ffn_sorted(p, full.moe, x)
    torch.cuda.synchronize()
    assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)
    # the card's placement of the same ids is the CPU's
    _, ids = moe.route(p["router"], x, full.moe.top_k)
    C = min(max(int(T * full.moe.top_k * full.moe.capacity_factor
                    / full.moe.n_routed), 1), T * full.moe.top_k)
    slot, keep = moe.sorted_dispatch(ids, full.moe.n_routed, 1, C)
    s_cpu, k_cpu = moe.sorted_dispatch(ids.cpu(), full.moe.n_routed, 1, C)
    assert torch.equal(slot.cpu(), s_cpu) and torch.equal(keep.cpu(), k_cpu)
    assert T > 8 or not bool(keep.all())        # decode: C = 1 drops


@pytest.mark.cuda
@pytest.mark.parametrize("dense_moe", [False, True])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_one_flash_launch_per_layer_and_card_matches_cpu(no_tf32, name,
                                                         dense_moe):
    cfg = get_arch(name).reduced()
    p_cpu = lm.init_params(0, cfg, device="cpu")
    p_gpu = _to(p_cpu, no_tf32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)))
    fa.reset_launch_counts()
    with torch.inference_mode():
        lg, _, aux = lm.forward(p_gpu, cfg, toks.to(no_tf32),
                                dense_moe=dense_moe)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
        assert fa.PLAIN_CALLS["flash_attention"] == 0
        want, _, want_aux = lm.forward(p_cpu, cfg, toks, dense_moe=dense_moe)
    torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)
    prompts = toks.numpy().astype(np.int32)
    cpu_eng = engine.ServeEngine(cfg, p_cpu, 2, 40, dense_moe=dense_moe,
                                 device="cpu")
    gpu_eng = engine.ServeEngine(cfg, p_gpu, 2, 40, dense_moe=dense_moe)
    fa.reset_launch_counts()
    got = gpu_eng.generate(prompts, 8)
    assert fa.LAUNCHES["flash_attention"] == 8 * cfg.n_layers
    np.testing.assert_array_equal(got, cpu_eng.generate(prompts, 8))


@pytest.mark.cuda
def test_bf16_params_keep_a_float32_router_on_card(card):
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    params = lm.init_params(0, cfg, torch.bfloat16, device=card)
    layer = params["group1"][0]
    assert layer["moe"]["router"].dtype == torch.float32
    assert layer["moe"]["w1"].dtype == torch.bfloat16
    cache = lm.init_cache(cfg, 2, 16, torch.bfloat16, device=card)
    toks = torch.zeros((2, 5), dtype=torch.long, device=card)
    with torch.inference_mode():
        lg, cache = lm.prefill(params, cfg, toks, cache)
        lg, cache = lm.decode_step(params, cfg, lg.argmax(-1), cache, 5)
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(lg).all())
