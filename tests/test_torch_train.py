"""The port's training stack against the JAX package's on the CPU, at the
``reduced()`` configs: ``lm_loss`` and its gradients for all ten archs
(the same perturbed weights and the same batch, fp32; MoE through the
capacity-less dispatch), microbatch accumulation, remat (bit for bit on
the CPU, both levels), three optimizer steps from the same train state
(AdamW and Adafactor), and the loss falling.  Also the card dispatch of
the two LM kernels: under ``torch.no_grad`` (serving) the launch is called
directly, under autograd the ``autograd.Function`` — driven here on CPU
tensors through each op's ``_card`` with a stand-in launch that counts
like the real one and computes the plain version."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import lm as j_lm
from repro.train import optimizer as j_opt
from repro.train import trainer as j_tr
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels.flash_attention import backward as fab
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv_scan import backward as rwb
from repro_torch.kernels.rwkv_scan import ops as rw_ops
from repro_torch.models import attention, lm, ssm
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.linrec import chunked_linear_recurrence
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.trainer import (TrainConfig, accumulate_grads,
                                       init_train_state, make_train_step,
                                       value_and_grad)

ARCH_NAMES = sorted(ARCHS)
# fp32 on both sides; XLA and ATen sum in other orders
LOSS_RTOL = 1e-5
# relative to the largest |gradient| of the tree: a leaf's own largest can
# be roundoff (Whisper's key biases have a zero gradient: ~1e-10 here)
GRAD_RTOL = 1e-5
# and each leaf against its own largest |gradient|, or 1e-3 of the tree's
# where the leaf is smaller (zero up to roundoff), so that a wrong gradient
# of a small leaf cannot hide under the tree's scale; RWKV6's worst leaf
# reads 1.24e-5 (its chunked recurrence rounds each chunk's decays)
LEAF_RTOL = 5e-5
# Parameters after three optimizer steps (lr 3e-3): within 1e-4, 1.1 % of
# the most an element moves in three steps.  Adam's first steps normalise
# each element's gradient (m / sqrt(v) ~ sign(g)), so where a gradient is
# near zero the two packages' roundoff is a visible share of the step (the
# worst element reads 5.3e-5 here while the losses agree to 1e-7); the
# optimizer state within 2e-4 of its tree's largest entry.
STEP_ATOL = 1e-4
STATE_RTOL = 2e-4


def _jax_params(cfg, seed=0):
    """JAX parameters with every leaf perturbed, so zero-initialised biases
    and mixes carry real values through both packages."""
    params = j_lm.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


def _jax_batch(jcfg, batch, seq, step=0):
    b = JPipeline(jcfg, global_batch=batch, seq_len=seq).batch_at(step)
    return {k: np.asarray(v) for k, v in b.items()}


def _torch_batch(np_batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tc(**kw):
    base = dict(n_microbatches=1, remat=False, dense_moe=True,
                opt=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                    decay_steps=50))
    base.update(kw)
    return TrainConfig(**base)


def _jtc(**kw):
    opt = kw.pop("opt", None)
    base = dict(n_microbatches=1, remat=False, dense_moe=True,
                opt=opt or j_opt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                 decay_steps=50))
    base.update(kw)
    return j_tr.TrainConfig(**base)


# ---------------------------------------------------------------------------
# lm_loss and its gradients, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_loss_and_grads_match_jax(arch):
    jcfg = J_ARCHS[arch].reduced()
    cfg = get_arch(arch).reduced()
    jparams = _jax_params(jcfg)
    seq = 16 + (jcfg.n_frontend_tokens if jcfg.frontend == "vision" else 0)
    np_batch = _jax_batch(jcfg, 2, seq)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: j_lm.lm_loss(p, jcfg, np_batch, dense_moe=True),
        has_aux=True)(jparams)
    params = params_from_jax(jparams, cfg, device="cpu")
    tc = _tc()
    loss, grads = value_and_grad(params, cfg, tc, _torch_batch(np_batch))
    assert _rel(float(loss), float(jloss)) < LOSS_RTOL
    want = tree_leaves(params_from_jax(_np_tree(jgrads), cfg, device="cpu"))
    assert len(want) == len(grads)
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(grads, want))
    assert worst < GRAD_RTOL * scale, (arch, worst / scale)
    leaf = [float((g - w).abs().max()) / max(float(w.abs().max()),
                                             1e-3 * scale)
            for g, w in zip(grads, want)]
    assert max(leaf) < LEAF_RTOL, (arch, max(leaf), leaf.index(max(leaf)))
    if cfg.moe:
        _, m = lm.lm_loss(params, cfg, _torch_batch(np_batch),
                          dense_moe=True)
        assert _rel(float(m["moe_aux"]), float(jm["moe_aux"])) < LOSS_RTOL


# ---------------------------------------------------------------------------
# accumulation and remat
# ---------------------------------------------------------------------------

CFG = get_arch("qwen2-1.5b").reduced()


def _pipe_batch(batch, seq, step=0, cfg=CFG):
    return SyntheticPipeline(cfg, batch, seq, device="cpu").batch_at(step)


def test_grad_accum_equals_full_batch():
    """n_microbatches grads == single-shot grads (uniform loss masks)."""
    batch = _pipe_batch(8, 16)
    params = init_train_state(0, CFG, _tc(), device="cpu")["params"]
    g1, l1 = accumulate_grads(params, CFG, _tc(), batch)
    g4, l4 = accumulate_grads(params, CFG, _tc(n_microbatches=4), batch)
    assert abs(float(l1) - float(l4)) < 1e-5
    for a, b in zip(tree_leaves(g1), tree_leaves(g4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b",
                                  "whisper-large-v3", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("remat_blocks", [1, 2])
def test_remat_is_bitwise_on_cpu(arch, remat_blocks):
    """remat (one level, and two with remat_blocks=2) recomputes the same
    activations on the CPU: loss and gradients bit for bit."""
    cfg = get_arch(arch).reduced()
    seq = 16 + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    batch = _pipe_batch(2, seq, cfg=cfg)
    params = init_train_state(1, cfg, _tc(), device="cpu")["params"]
    l0, g0 = value_and_grad(params, cfg, _tc(), batch)
    l1, g1 = value_and_grad(params, cfg,
                            _tc(remat=True, remat_blocks=remat_blocks),
                            batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# three optimizer steps from the same state, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_three_steps_match_jax(kind, arch):
    jcfg = J_ARCHS[arch].reduced()
    cfg = get_arch(arch).reduced()
    jopt = j_opt.OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=1,
                                 decay_steps=50)
    opt = OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=1,
                          decay_steps=50)
    jtc = _jtc(opt=jopt, n_microbatches=2, remat=True)
    tc = _tc(opt=opt, n_microbatches=2, remat=True)
    jstate = j_tr.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    jstate = {**jstate, "params": _jax_params(jcfg)}
    jstate["opt"] = j_opt.init_opt_state(jstate["params"], jopt)
    state = train_state_from_jax(_np_tree(jstate), cfg, device="cpu")
    jstep = j_tr.make_train_step(jcfg, jtc, donate=False)
    step = make_train_step(cfg, tc)
    for i in range(3):
        np_batch = _jax_batch(jcfg, 4, 16, step=i)
        jstate, jm = jstep(jstate, np_batch)
        state, m = step(state, _torch_batch(np_batch))
        assert _rel(float(m["loss"]), float(jm["loss"])) < LOSS_RTOL
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) < 1e-4
    want = train_state_from_jax(_np_tree(jstate), cfg, device="cpu")
    for got, w in zip(tree_leaves(state["params"]),
                      tree_leaves(want["params"])):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.double().numpy(),
                                   w.double().numpy(), rtol=0,
                                   atol=STEP_ATOL)
    for name in ("m", "v"):
        if name not in want["opt"]:
            continue
        got, w = tree_leaves(state["opt"][name]), tree_leaves(
            want["opt"][name])
        assert [x.shape for x in got] == [x.shape for x in w]
        scale = max(float(x.abs().max()) for x in w)
        worst = max(float((a - b).abs().max()) for a, b in zip(got, w))
        assert worst <= STATE_RTOL * scale, (name, worst / scale)
    assert int(state["opt"]["count"]) == int(jstate["opt"]["count"]) == 3
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_loss_decreases():
    """The port's counterpart of tests/test_train.py::test_loss_decreases:
    its own pipeline, two microbatches, remat."""
    tc = _tc(n_microbatches=2, remat=True)
    state = init_train_state(0, CFG, tc, device="cpu")
    pipe = SyntheticPipeline(CFG, global_batch=8, seq_len=32, device="cpu")
    step = make_train_step(CFG, tc)
    losses = []
    for i in range(6):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_lm_loss_masks_and_prefix():
    """loss_mask weights the positions; a VLM's prefix positions carry no
    loss (the logits are cut to the text positions)."""
    cfg = get_arch("llava-next-34b").reduced()
    seq = 16 + cfg.n_frontend_tokens
    batch = _pipe_batch(2, seq, cfg=cfg)
    params = init_train_state(0, cfg, _tc(), device="cpu")["params"]
    full, _ = lm.lm_loss(params, cfg, batch)
    mask = batch["loss_mask"].clone()
    mask[:, 8:] = 0
    half, _ = lm.lm_loss(params, cfg, {**batch, "loss_mask": mask})
    logits, _, _ = lm.forward(params, cfg, batch["tokens"],
                              prefix_embeds=batch["prefix_embeds"])
    logits = logits[:, cfg.n_frontend_tokens:].float()
    nll = (torch.logsumexp(logits, -1)
           - logits.gather(-1, batch["targets"][..., None].long())[..., 0])
    assert torch.allclose(full, nll.mean(), rtol=1e-6)
    assert torch.allclose(half, nll[:, :8].mean(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the card dispatch: direct launch when serving, the Function under grad
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _card_dispatch(monkeypatch):
    """Run the models' CPU tensors through the ops' card dispatch
    (``_card``) with stand-in launches that count like the real ones and
    compute the plain versions; yields the Function.apply call counts."""
    applied = {"flash": 0, "wkv": 0}

    def flash_launch(q, k, v, *, causal, window, q_offset, kv_valid,
                     q_positions):
        B, Sq, H, hd = q.shape
        fa_ops.LAUNCHES["flash_attention"] += 1
        fa_ops.ROUTE_CALLS[fa_ops.route(q.dtype, Sq, H, k.shape[2], hd,
                                        True)] += 1
        pos = (q_positions if q_positions is not None
               else torch.arange(q_offset, q_offset + Sq))
        return fa_ref.attention_ref(q, k, v, pos, kv_valid, causal=causal,
                                    window=window)

    def wkv_launch(r, k, v, log_w, u, initial_state):
        rw_ops.LAUNCHES["wkv_scan"] += 1
        rw_ops.ROUTE_CALLS[rw_ops.route(r.dtype, r.shape[1], r.shape[3],
                                        v.shape[3])] += 1
        return chunked_linear_recurrence(r, k, v, log_w, u=u,
                                         initial_state=initial_state,
                                         return_state=True)

    def blockwise(q, k, v, q_positions, kv_valid_len=None, *, causal=True,
                  window=None, kv_block=512, unroll=False):
        return fa_ops._card(q, k, v, causal=causal, window=window,
                            q_offset=0, kv_valid=kv_valid_len,
                            q_positions=q_positions)

    def wkv_scan(r, k, v, log_w, u, initial_state=None, *, chunk=64):
        return rw_ops._card(r, k, v, log_w, u, initial_state)

    def spy(cls, key):
        orig = cls.apply

        def apply(*args):
            applied[key] += 1
            return orig(*args)
        return apply

    monkeypatch.setattr(fa_ops, "_launch", flash_launch)
    monkeypatch.setattr(rw_ops, "_launch", wkv_launch)
    monkeypatch.setattr(attention, "blockwise_attention", blockwise)
    monkeypatch.setattr(lm, "blockwise_attention", blockwise)
    monkeypatch.setattr(rw_ops, "wkv_scan", wkv_scan)
    monkeypatch.setattr(ssm, "inclusive_scan", ssm.wkv_inclusive)
    monkeypatch.setattr(fa_ops.FlashAttentionFn, "apply",
                        spy(fa_ops.FlashAttentionFn, "flash"))
    monkeypatch.setattr(rw_ops.WkvScanFn, "apply",
                        spy(rw_ops.WkvScanFn, "wkv"))
    for mod in (fa_ops, rw_ops, fab, rwb):
        mod.reset_launch_counts()
    yield applied


@pytest.mark.parametrize("arch,kernel,per_forward",
                         [("qwen2-1.5b", "flash_attention", 2),
                          ("rwkv6-3b", "wkv_scan", 2),
                          ("hymba-1.5b", "wkv_scan", 2)])
def test_serving_takes_the_direct_launch(monkeypatch, arch, kernel,
                                         per_forward):
    """ServeEngine (inference mode) and forward under torch.no_grad call
    the launch directly, never the Function: the launch counts are the
    serving path's, whatever the parameters' requires_grad."""
    cfg = get_arch(arch).reduced()
    params = lm.init_params(0, cfg, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    ops = fa_ops if kernel == "flash_attention" else rw_ops
    with _card_dispatch(monkeypatch) as applied:
        with torch.no_grad():
            lm.forward(params, cfg, torch.zeros((2, 8), dtype=torch.long))
        assert ops.LAUNCHES[kernel] == per_forward
        prompts = np.zeros((2, 8), dtype=np.int32)
        ServeEngine(cfg, params, 2, 16, device="cpu").generate(prompts, 3)
        assert applied == {"flash": 0, "wkv": 0}
        # one prefill and two decode steps, each a forward's launches
        assert ops.LAUNCHES[kernel] == 4 * per_forward
        assert sum(ops.ROUTE_CALLS.values()) == ops.LAUNCHES[kernel]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b", "hymba-1.5b"])
def test_training_takes_the_function(monkeypatch, arch):
    """Under autograd every kernel call goes through its Function, whose
    backward is the backward op (its plain version on the CPU), and the
    gradients equal those of the plain path."""
    cfg = get_arch(arch).reduced()
    batch = _pipe_batch(2, 16, cfg=cfg)
    params = init_train_state(0, cfg, _tc(), device="cpu")["params"]
    want_loss, want = value_and_grad(params, cfg, _tc(), batch)
    with _card_dispatch(monkeypatch) as applied:
        loss, grads = value_and_grad(params, cfg, _tc(remat=True), batch)
        # every launch went through a Function; remat runs each layer's
        # forward twice (the recompute), its backward once
        assert applied["flash"] == fa_ops.LAUNCHES["flash_attention"]
        assert applied["wkv"] == rw_ops.LAUNCHES["wkv_scan"]
        assert applied["flash"] + applied["wkv"] == 2 * cfg.n_layers * (
            2 if cfg.family == "hybrid" else 1)
        assert (fab.PLAIN_CALLS["flash_attention_backward"]
                == applied["flash"] // 2)
        assert rwb.PLAIN_CALLS["wkv_scan_backward"] == applied["wkv"] // 2
    assert torch.allclose(loss, want_loss, rtol=1e-5)
    for g, w in zip(grads, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-6)


def test_no_gradient_through_a_cache_or_a_state(monkeypatch):
    """kv_valid, an initial state and the final state have no gradient
    yet: each raises, none returns a detached tensor."""
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 6, 1, 8, requires_grad=True)
    v = torch.randn(1, 6, 1, 8, requires_grad=True)
    r, kk, lw = (torch.randn(1, 5, 2, 4, requires_grad=True)
                 for _ in range(3))
    vv = torch.randn(1, 5, 2, 3, requires_grad=True)
    u = torch.randn(2, 4)
    with _card_dispatch(monkeypatch):
        with pytest.raises(NotImplementedError, match="kv_valid"):
            fa_ops._card(q, k, v, causal=True, window=None, q_offset=0,
                         kv_valid=4, q_positions=None)
        with pytest.raises(NotImplementedError, match="initial state"):
            rw_ops._card(r, kk, vv, -torch.exp(lw), u,
                         torch.zeros(1, 2, 4, 3))
        out, sT = rw_ops._card(r, kk, vv, -torch.exp(lw), u, None)
        with pytest.raises(NotImplementedError, match="final state"):
            (out.sum() + sT.sum()).backward()
