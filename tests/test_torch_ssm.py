"""Hymba's pieces in the port against the JAX package's on the CPU: the
selective SSM (``_causal_conv`` with a carry, ``_selective_terms``,
``ssm_forward`` with and without a carried state, ``ssm_step``), the
identity that runs its scan on the WKV kernel (exact step by step, rtol =
atol = 1e-5 in fp32; through the WKV op's plain version against
``chunked_linear_recurrence(mode="inclusive")`` at the same chunk, rtol
1e-5 and atol 1e-5 of the output's scale), the ring cache (``ring_cache_attention``, and
its card formulation ``ring_decode_attention`` through flash's plain
version at every step across two wraps, exact up to the softmax's
summation order: 1e-6), and the reduced hymba-1.5b model (forward,
prefill, decode across two ring wraps) from the same weights within 1e-4
(XLA and ATen sum in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro.models import ssm as j_ssm
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv_scan import ops as rw_ops
from repro_torch.models import attention, linrec, lm, ssm
from repro_torch.models.convert import params_from_jax

NAME = "hymba-1.5b"
TOL = 1e-4
ID_TOL = 1e-5
# one compile for every decode step of the wrap tests
_j_decode = jax.jit(j_lm.decode_step, static_argnums=1)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _jax_params(cfg, seed=0):
    """JAX parameters with every leaf perturbed (zero biases carry real
    values through both packages)."""
    params = j_lm.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_arch(NAME).reduced(), J_ARCHS[NAME].reduced()
    jparams = _jax_params(jcfg)
    return cfg, jcfg, jparams, params_from_jax(jparams, cfg, device="cpu")


@pytest.fixture(scope="module")
def ssm_layer(model):
    """Layer 0's SSM parameters, numpy (JAX) and torch."""
    cfg, jcfg, jparams, params = model
    jp = {k: np.asarray(v)[0] for k, v in jparams["group0"]["ssm"].items()}
    return cfg, jcfg, jp, params["group0"][0]["ssm"]


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    fa_ops.reset_launch_counts()
    rw_ops.reset_launch_counts()
    yield
    assert fa_ops.LAUNCHES["flash_attention"] == 0
    assert rw_ops.LAUNCHES["wkv_scan"] == 0


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the SSM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_jax(carry):
    x, w, b = _rand(2, 7, 12), _rand(4, 12, seed=1), _rand(12, seed=2)
    prev = _rand(2, 3, 12, seed=3) if carry else None
    y, c = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b),
                            None if prev is None else torch.from_numpy(prev))
    jy, jc = j_ssm._causal_conv(x, w, b, prev)
    _close(y, jy, 1e-6)
    _close(c, jc, 0.0)


def test_causal_conv_carry_streams():
    """Two calls with the carry equal one call over the whole sequence."""
    x, w, b = _rand(2, 11, 12), _rand(4, 12, seed=1), _rand(12, seed=2)
    t = torch.from_numpy
    whole, _ = ssm._causal_conv(t(x), t(w), t(b), None)
    y1, c = ssm._causal_conv(t(x[:, :6]), t(w), t(b), None)
    y2, _ = ssm._causal_conv(t(x[:, 6:]), t(w), t(b), c)
    _close(torch.cat([y1, y2], 1), whole, 1e-6)


def test_selective_terms_match_jax(ssm_layer):
    cfg, jcfg, jp, tp = ssm_layer
    u = _rand(2, 5, cfg.n_heads * cfg.head_dim, seed=4)
    got = ssm._selective_terms(tp, cfg, torch.from_numpy(u))
    want = j_ssm._selective_terms(jp, jcfg, u)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    assert all(g.dtype == torch.float32 for g in got)


@pytest.mark.parametrize("stateful", [False, True])
def test_ssm_forward_matches_jax(ssm_layer, stateful):
    cfg, jcfg, jp, tp = ssm_layer
    inner = cfg.n_heads * cfg.head_dim
    x = _rand(2, 13, cfg.d_model, seed=5)
    st = ({"conv": _rand(2, 3, inner, seed=6),
           "ssm": _rand(2, cfg.n_heads, 4, cfg.head_dim, seed=7, scale=0.1)}
          if stateful else None)
    out, new = ssm.ssm_forward(tp, cfg, torch.from_numpy(x),
                               None if st is None else _t(st), chunk=4)
    jout, jnew = j_ssm.ssm_forward(jp, jcfg, x, st, chunk=4)
    _close(out, jout)
    assert (new is None) == (not stateful)
    if stateful:
        _close(new["conv"], jnew["conv"], 0.0)
        _close(new["ssm"], jnew["ssm"])


def test_ssm_step_matches_jax_and_forward(ssm_layer):
    """``ssm_step`` equals the JAX step, and steps carrying the state equal
    one stateful ``ssm_forward`` over the same tokens."""
    cfg, jcfg, jp, tp = ssm_layer
    x = _rand(2, 6, cfg.d_model, seed=8)
    st0 = ssm.init_ssm_state(cfg, 2, torch.float32, "cpu")
    jst = j_ssm.init_ssm_state(jcfg, 2, jnp.float32)
    st, outs = st0, []
    for t in range(6):
        o, st = ssm.ssm_step(tp, cfg, torch.from_numpy(x[:, t]), st)
        jo, jst = j_ssm.ssm_step(jp, jcfg, x[:, t], jst)
        _close(o, jo)
        _close(st["ssm"], jst["ssm"])
        outs.append(o)
    whole, wst = ssm.ssm_forward(
        tp, cfg, torch.from_numpy(x),
        ssm.init_ssm_state(cfg, 2, torch.float32, "cpu"), chunk=4)
    _close(torch.stack(outs, 1), whole)
    _close(st["ssm"], wst["ssm"])
    _close(st["conv"], wst["conv"], 1e-6)


def _inclusive_inputs(B, S, h, Nk, Nv, seed):
    """Streams as the SSM makes them: dt = softplus(.), log_w = dt * A with
    A = -[1..Nk], k = dt * B_t."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, h, Nk, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, h, generator=g))
    A = -torch.linspace(1.0, float(Nk), Nk)
    k = torch.randn(B, S, h, Nk, generator=g) * dt[..., None]
    v = torch.randn(B, S, h, Nv, generator=g)
    return q, k, v, dt[..., None] * A, 0.1 * torch.randn(B, h, Nk, Nv,
                                                         generator=g)


IDENTITY_SHAPES = [(2, 70, 3, 16, 64), (1, 1, 2, 16, 64), (2, 33, 2, 4, 16)]


@pytest.mark.parametrize("B,S,h,Nk,Nv", IDENTITY_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_inclusive_identity_is_exact(B, S, h, Nk, Nv, with_state):
    """inclusive(q, k, v, w)_t = rwkv(r = q * exp(w), k, v, w, u = 0)_t
    + (q_t . k_t) v_t, with the same states, step by step in fp32."""
    q, k, v, log_w, s0 = _inclusive_inputs(B, S, h, Nk, Nv, seed=S + Nk)
    s0 = s0 if with_state else None
    out, st = linrec.naive_linear_recurrence(
        q * torch.exp(log_w), k, v, log_w, torch.zeros(h, Nk), s0,
        mode="rwkv")
    out = out + (q * k).sum(-1, keepdim=True) * v
    want, want_st = linrec.naive_linear_recurrence(q, k, v, log_w, None, s0,
                                                   mode="inclusive")
    torch.testing.assert_close(out, want, rtol=ID_TOL, atol=ID_TOL)
    torch.testing.assert_close(st, want_st, rtol=ID_TOL, atol=ID_TOL)


@pytest.mark.parametrize("B,S,h,Nk,Nv", IDENTITY_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_inclusive_matches_chunked_inclusive(B, S, h, Nk, Nv,
                                                 with_state):
    """``wkv_inclusive`` through the WKV op's plain version (the chunked
    rwkv form) against the chunked inclusive form at the same chunk:
    rtol 1e-5 and atol 1e-5 of the output's largest magnitude (each
    chunked form rounds its in-chunk decays on its own; at chunk 16 both
    sit within 1e-4 of a float64 recurrence at |out| ~ 50)."""
    q, k, v, log_w, s0 = _inclusive_inputs(B, S, h, Nk, Nv, seed=S + Nk)
    s0 = s0 if with_state else None
    out, st = ssm.wkv_inclusive(q, k, v, log_w, s0, chunk=16)
    assert rw_ops.PLAIN_CALLS["wkv_scan"] == 1
    want, want_st = linrec.chunked_linear_recurrence(
        q, k, v, log_w, initial_state=s0, mode="inclusive", chunk=16,
        return_state=True)
    torch.testing.assert_close(out, want, rtol=ID_TOL,
                               atol=ID_TOL * float(want.abs().max()))
    torch.testing.assert_close(st, want_st, rtol=ID_TOL,
                               atol=ID_TOL * float(want_st.abs().max()))


def test_inclusive_scan_on_the_cpu_is_the_plain_chunked_form():
    q, k, v, log_w, s0 = _inclusive_inputs(2, 20, 2, 4, 8, seed=1)
    out, st = ssm.inclusive_scan(q, k, v, log_w, s0, chunk=8)
    want, want_st = linrec.chunked_linear_recurrence(
        q, k, v, log_w, initial_state=s0, mode="inclusive", chunk=8,
        return_state=True)
    assert torch.equal(out, want) and torch.equal(st, want_st)
    assert rw_ops.PLAIN_CALLS["wkv_scan"] == 1


def test_log_a_stays_float32(model):
    cfg, _, jparams, _ = model
    bf = params_from_jax(jparams, cfg, device="cpu", dtype=torch.bfloat16)
    mine = lm.init_params(0, cfg, torch.bfloat16, device="cpu")
    for params in (bf, mine):
        p = params["group0"][0]["ssm"]
        assert p["log_a"].dtype == torch.float32
        assert p["w_in"].dtype == p["d_skip"].dtype == p["dt_bias"].dtype \
            == torch.bfloat16
    np.testing.assert_array_equal(
        bf["group0"][1]["ssm"]["log_a"].numpy(),
        np.asarray(jparams["group0"]["ssm"]["log_a"])[1])
    # the bf16 layer runs, its conv carry in bf16 and the SSM state in fp32
    st = ssm.init_ssm_state(cfg, 2, torch.bfloat16, "cpu")
    x = torch.from_numpy(_rand(2, 5, cfg.d_model, seed=9)).bfloat16()
    out, new = ssm.ssm_forward(mine["group0"][0]["ssm"], cfg, x, st, chunk=4)
    assert out.dtype == new["conv"].dtype == torch.bfloat16
    assert new["ssm"].dtype == torch.float32
    assert torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

def test_ring_cache_attention_matches_jax():
    B, Wc, KV, G, hd = 2, 8, 2, 3, 16
    q = _rand(B, 2, KV * G, hd, seed=10)
    k, v = _rand(B, Wc, KV, hd, seed=11), _rand(B, Wc, KV, hd, seed=12)
    kpos = np.array([16, 17, 18, 11, 12, -1, 14, 15], np.int32)
    qpos = np.array([17, 18])
    for window in (None, 5):
        got = attention.ring_cache_attention(
            *(torch.from_numpy(a) for a in (q, k, v, kpos, qpos)),
            window=window)
        _close(got, j_attn.ring_cache_attention(q, k, v, kpos, qpos,
                                                window=window), 1e-6)


@pytest.mark.parametrize("max_seq,window,n_pre", [(40, 16, 5), (40, 16, 24),
                                                  (12, 16, 3)])
def test_ring_decode_formulation_across_two_wraps(max_seq, window, n_pre):
    """Fill a ring as prefill and decode do (only the last Wc keys of the
    prefill, then one key a step); at every decode step flash over the
    first min(pos + 1, Wc) slots with no mask (the card formulation, here
    through flash's plain version) equals the position-masked ring
    attention, through two wraps of the ring."""
    Wc = min(max_seq, window)
    B, KV, G, hd = 2, 2, 2, 16
    g = torch.Generator().manual_seed(Wc + n_pre)
    k_all = torch.randn(B, max_seq, KV, hd, generator=g)
    v_all = torch.randn(B, max_seq, KV, hd, generator=g)
    ring_k = torch.zeros(B, Wc, KV, hd)
    ring_v = torch.zeros(B, Wc, KV, hd)
    kpos = torch.full((Wc,), -1, dtype=torch.int32)
    pw = torch.arange(n_pre)[-Wc:]
    ring_k[:, pw % Wc], ring_v[:, pw % Wc] = k_all[:, pw], v_all[:, pw]
    kpos[pw % Wc] = pw.int()
    steps = 0
    for pos in range(n_pre, max_seq):
        ring_k[:, pos % Wc], ring_v[:, pos % Wc] = k_all[:, pos], \
            v_all[:, pos]
        kpos[pos % Wc] = pos
        q = torch.randn(B, 1, KV * G, hd, generator=g)
        want = attention.ring_cache_attention(
            q, ring_k, ring_v, kpos, torch.tensor([pos]), window=window)
        fa_ops.reset_launch_counts()
        got = attention.ring_decode_attention(q, ring_k, ring_v, pos)
        assert fa_ops.PLAIN_CALLS["flash_attention"] == 1
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        # and the positions the mask keeps are the whole window's
        lo = max(0, pos - window + 1)
        dense = attention.dense_attention(
            q, k_all[:, lo:pos + 1], v_all[:, lo:pos + 1],
            torch.tensor([pos - lo]), causal=True)
        torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)
        steps += 1
    assert steps + n_pre >= 2 * Wc or max_seq < 2 * Wc


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    toks = _tokens(cfg, 2, 40)
    logits, _, aux = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                                mixer_chunk=8)
    jlogits, _, _ = j_lm.forward(jparams, jcfg, jnp.asarray(toks),
                                 mixer_chunk=8)
    _close(logits, jlogits)
    assert float(aux) == 0.0
    assert rw_ops.PLAIN_CALLS["wkv_scan"] == cfg.n_layers
    assert fa_ops.PLAIN_CALLS["flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("n_pre", [8, 24])
def test_prefill_and_decode_across_two_wraps_match_jax(model, n_pre):
    """The counterpart of the JAX package's ring-cache test: a prefill
    shorter and one longer than the ring, then decode steps through two
    wraps of the 16-slot ring; every step's logits equal the JAX package's
    (whose decode reads ``ring_cache_attention``) and the full forward's."""
    cfg, jcfg, jparams, params = model
    B, S = 2, n_pre + 34
    Wc = cfg.sliding_window
    toks = _tokens(cfg, B, S, seed=n_pre)
    full, _, _ = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                            mixer_chunk=4)
    cache = lm.init_cache(cfg, B, S + 4, torch.float32, device="cpu")
    jcache = j_lm.init_cache(jcfg, B, S + 4, jnp.float32)
    assert cache["group0"][0]["attn"]["k"].shape[1] == Wc
    lg, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :n_pre])
                           .long(), cache, mixer_chunk=4)
    jlg, jcache = j_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :n_pre]),
                               jcache, mixer_chunk=4)
    _close(lg, jlg)
    _close(lg, full[:, n_pre - 1], 2e-3)
    _close(cache["group0"][1]["attn"]["kpos"],
           np.asarray(jcache["group0"]["attn"]["kpos"])[1], 0.0)
    for pos in range(n_pre, S):
        tok = toks[:, pos]
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   cache, pos)
        jlg, jcache = _j_decode(jparams, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(pos, jnp.int32))
        _close(lg, jlg)
        _close(lg, full[:, pos], 2e-3)
    assert S - n_pre >= 2 * Wc
    ring = cache["group0"][0]["attn"]
    assert sorted(ring["kpos"].tolist()) == list(range(S - Wc, S))
    _close(ring["k"], np.asarray(jcache["group0"]["attn"]["k"])[0])
    _close(cache["group0"][0]["ssm"]["ssm"],
           np.asarray(jcache["group0"]["ssm"]["ssm"])[0])


def test_window_longer_than_the_cache(model):
    """max_seq below the window: the ring is max_seq long and never wraps."""
    cfg, jcfg, jparams, params = model
    cfg2 = dataclasses.replace(cfg, sliding_window=64)
    toks = _tokens(cfg, 1, 20, seed=5)
    full, _, _ = lm.forward(params, cfg2, torch.from_numpy(toks).long())
    cache = lm.init_cache(cfg2, 1, 20, torch.float32, device="cpu")
    assert cache["group0"][0]["attn"]["k"].shape[1] == 20
    lg, cache = lm.prefill(params, cfg2, torch.from_numpy(toks[:, :12])
                           .long(), cache)
    for pos in range(12, 20):
        lg, cache = lm.decode_step(params, cfg2,
                                   torch.from_numpy(toks[:, pos]).long(),
                                   cache, pos)
        _close(lg, full[:, pos], 2e-3)
