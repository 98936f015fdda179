"""The port's serving engine against the JAX package's on the CPU, at every
architecture's ``reduced()`` config and the same weights (carried by
``params_from_jax``): greedy ``generate`` (with the same numpy frontend
inputs for whisper and llava) and ``serve`` give the same tokens; an
enc-dec model's ``serve``, which carries no frontend inputs, raises.  Temperature sampling cannot match JAX's bits; it is checked to be
deterministic per (seed, pos).  Entry points given no device raise on a
host without a card."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import lm as j_lm
from repro.serve import engine as j_engine
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine

ARCH_NAMES = sorted(ARCHS)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def engines(request):
    jcfg = J_ARCHS[request.param].reduced()
    jparams = j_lm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_arch(request.param).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return (engine.ServeEngine(cfg, params, batch_slots=2, max_seq=64,
                               device="cpu"),
            j_engine.ServeEngine(jcfg, jparams, batch_slots=2, max_seq=64))


def _prompts(cfg, B, L, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def _front(cfg, B, seed=9):
    """Stub frontend inputs as numpy arrays (both engines take them)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)) * 0.02
    if cfg.family == "encdec":
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)) * 0.02
    return {k: v.astype(np.float32) for k, v in out.items()}


def _requests(cfg, request_cls, seed):
    rng = np.random.default_rng(seed)
    return [request_cls(rng.integers(0, cfg.vocab_size,
                                     rng.integers(3, 12)).astype(np.int32),
                        int(rng.integers(2, 7)))
            for _ in range(5)]


def test_generate_greedy_matches_jax(engines):
    eng, jeng = engines
    prompts = _prompts(eng.cfg, 2, 9, seed=0)
    front = _front(eng.cfg, 2)
    out = eng.generate(prompts, 8, **front)
    assert out.shape == (2, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(
        out, jeng.generate(prompts, 8,
                           **{k: jax.numpy.asarray(v)
                              for k, v in front.items()}))
    np.testing.assert_array_equal(out, eng.generate(prompts, 8, **front))


def test_serve_greedy_matches_jax(engines):
    eng, jeng = engines
    if eng.cfg.family == "encdec":
        with pytest.raises(ValueError, match="enc_frames"):
            eng.serve(_requests(eng.cfg, engine.Request, seed=1))
        return
    mine = eng.serve(_requests(eng.cfg, engine.Request, seed=1))
    theirs = jeng.serve(_requests(eng.cfg, j_engine.Request, seed=1))
    assert all(r.done and len(r.out_tokens) == r.max_new_tokens
               for r in mine)
    assert [r.out_tokens for r in mine] == [r.out_tokens for r in theirs]


def test_greedy_matches_argmax_forward(engines):
    """First generated token == argmax of the full-forward logits."""
    eng, _ = engines
    prompts = _prompts(eng.cfg, 2, 8, seed=2)
    front = _front(eng.cfg, 2)
    logits, _, _ = lm.forward(eng.params, eng.cfg,
                              torch.from_numpy(prompts).long(),
                              **{k: torch.from_numpy(v)
                                 for k, v in front.items()})
    np.testing.assert_array_equal(eng.generate(prompts, 1, **front)[:, 0],
                                  logits[:, -1].argmax(-1).numpy())


def test_temperature_sampling_is_deterministic_per_seed_and_pos(engines):
    eng, _ = engines
    prompts = _prompts(eng.cfg, 2, 6, seed=3)
    front = _front(eng.cfg, 2)
    a = eng.generate(prompts, 6, temperature=1.5, **front)
    np.testing.assert_array_equal(a, eng.generate(prompts, 6,
                                                  temperature=1.5, **front))
    assert ((a >= 0) & (a < eng.cfg.vocab_size)).all()
    other = engine.ServeEngine(eng.cfg, eng.params, 2, 64, seed=1,
                               device="cpu")
    assert not np.array_equal(a, other.generate(prompts, 6,
                                                temperature=1.5, **front))
    # one draw depends on (seed, pos) only
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    draw = lambda seed, pos: engine.sample_token(
        logits, engine.step_generator(seed, pos, "cpu"), 1.0)
    assert torch.equal(draw(0, 7), draw(0, 7))
    assert not all(torch.equal(draw(0, p), draw(0, 7)) for p in range(8))
    assert engine.sample_token(torch.tensor([[0.0, 10.0, 0.0]]), None,
                               0.0).tolist() == [1]


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_arch("qwen2-1.5b").reduced()
    params = lm.init_params(0, cfg, device="cpu")
    for call in (lambda: lm.init_params(0, cfg),
                 lambda: lm.init_cache(cfg, 1, 8, torch.float32),
                 lambda: params_from_jax({}, cfg),
                 lambda: engine.ServeEngine(cfg, params, 1, 8),
                 lambda: launch_serve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b",
                                  "whisper-large-v3", "llava-next-34b"])
def test_launcher_runs_on_the_cpu(capsys, arch):
    launch_serve.main(["--arch", arch, "--requests", "3", "--slots",
                       "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s on cpu" in out
    assert out.count(" -> [") == 3
