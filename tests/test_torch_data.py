"""The port's data pipeline on the CPU: every batch a pure function of
(seed, step); per arch family the JAX ``SyntheticPipeline``'s keys,
shapes and dtypes; tokens in [0, V) with the zipf-like marginal; and
``shuffled_epoch_order`` equal to the JAX package's, with and without the
MapReduce shuffle behind it.  The token bits are not ``jax.random``'s (a
deliberate difference: the parity tests feed JAX's batches to both
trainers)."""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.params import SchemeParams as JSchemeParams
from repro.data import pipeline as j_pipe
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.params import SchemeParams
from repro_torch.data.pipeline import (PipelineState, SyntheticPipeline,
                                       shuffled_epoch_order)

ARCH_NAMES = sorted(ARCHS)


def _seq(cfg):
    return 24 + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_keys_shapes_dtypes_match_jax(arch):
    jcfg, cfg = J_ARCHS[arch].reduced(), get_arch(arch).reduced()
    want = j_pipe.SyntheticPipeline(jcfg, 3, _seq(jcfg)).batch_at(0)
    got = SyntheticPipeline(cfg, 3, _seq(cfg), device="cpu").batch_at(0)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].numpy().dtype == w.dtype, k
    toks = got["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert torch.equal(got["tokens"][:, 1:], got["targets"][:, :-1])


def test_batch_is_a_function_of_seed_and_step():
    cfg = get_arch("whisper-large-v3").reduced()
    pipe = SyntheticPipeline(cfg, 4, 32, seed=3, device="cpu")
    a, b = pipe.batch_at(5), pipe.batch_at(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    again = SyntheticPipeline(cfg, 4, 32, seed=3, device="cpu").batch_at(5)
    assert all(torch.equal(a[k], again[k]) for k in a)
    other_step = pipe.batch_at(6)
    other_seed = SyntheticPipeline(cfg, 4, 32, seed=4,
                                   device="cpu").batch_at(5)
    assert not torch.equal(a["tokens"], other_step["tokens"])
    assert not torch.equal(a["enc_frames"], other_seed["enc_frames"])
    it = iter(pipe)
    first, second = next(it), next(it)
    assert torch.equal(first["tokens"], pipe.batch_at(0)["tokens"])
    assert torch.equal(second["tokens"], pipe.batch_at(1)["tokens"])


def test_token_marginal_is_the_zipf_map():
    """min((u^-0.7 - 1) V / 100, V - 1) with u uniform on [1e-6, 1): the
    same marginal as the JAX pipeline's, compared by quantiles."""
    cfg = get_arch("qwen2-1.5b").reduced()
    jcfg = J_ARCHS["qwen2-1.5b"].reduced()
    got = SyntheticPipeline(cfg, 64, 256, device="cpu").batch_at(0)
    want = np.asarray(j_pipe.SyntheticPipeline(jcfg, 64, 256).batch_at(0)
                      ["tokens"])
    q = [0.1, 0.5, 0.9]
    np.testing.assert_allclose(np.quantile(got["tokens"].numpy(), q),
                               np.quantile(want, q), rtol=0.25, atol=1)
    frac_cap = float((got["tokens"] == cfg.vocab_size - 1).float().mean())
    assert abs(frac_cap - float((want == jcfg.vocab_size - 1).mean())) < 0.02


def test_pipeline_state_round_trip():
    st = PipelineState(12)
    assert PipelineState.from_dict(st.to_dict()).step == 12
    assert st.to_dict()["step"].dtype == torch.int32


@pytest.mark.parametrize("n,epoch,seed", [(96, 0, 0), (200, 3, 7),
                                          (48, 1, 2)])
def test_shuffled_epoch_order_matches_jax(n, epoch, seed):
    np.testing.assert_array_equal(
        shuffled_epoch_order(n, epoch, seed=seed),
        j_pipe.shuffled_epoch_order(n, epoch, seed=seed))


def test_shuffled_epoch_order_through_the_engine_matches_jax():
    kw = dict(K=8, P=4, Q=16, N=48, r=2)
    got = shuffled_epoch_order(200, 1, SchemeParams(**kw), seed=5,
                               device="cpu")
    want = j_pipe.shuffled_epoch_order(200, 1, JSchemeParams(**kw), seed=5)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(200))
