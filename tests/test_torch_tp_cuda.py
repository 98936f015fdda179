"""Tensor parallelism on the card: ``chip_smoke.py`` phase 10 (a) and (c)
at small widths.  Four ranks over gloo on ``cuda:0`` hold a dense model of
32 query heads on 4 kv heads (hd 64, so each rank's flash calls run 8
query heads on 1 kv head, G = 8, as qwen2-72b's do at model 4): fp32
prefill and decode logits against the unsharded run on the card, bf16
prefill on the tensor-core route and decode on split-kv, and one AdamW
step on (data 2, model 2) and on (data 1, model 4) with sequence TP
against the unsharded full-batch step.  Needs a CUDA card (the ``cuda``
marker; skipped without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_tp_cuda.py

Tolerances: fp32 logits within 1e-4 of the largest |logit|; the loss
within 1e-5 relative; each gradient leaf within 1e-4 of its own largest
entry (as tests/test_torch_train_cuda.py); each updated parameter within
1e-6 of the leaf's largest, against the unsharded AdamW fed the gathered
gradient."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

RANKS = 4
B, S, NEW = 2, 64, 4
TRAIN = (((2, 2), False), ((1, 4), True))
TC = tr.TrainConfig(n_microbatches=1, remat=True,
                    opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                            decay_steps=50))


def _cfg():
    return dataclasses.replace(get_arch("qwen2-72b").reduced(),
                               d_model=512, n_heads=32, n_kv_heads=4,
                               head_dim=64, d_ff=1024, vocab_size=2048)


def _greedy(params, cfg, prompts, dtype, dev):
    with torch.inference_mode():
        cache = lm.init_cache(cfg, B, S + NEW, dtype, device=dev)
        lg, cache = lm.prefill(params, cfg, prompts, cache)
        steps = [lg.float()]
        for i in range(NEW):
            lg, cache = lm.decode_step(params, cfg, steps[-1].argmax(-1),
                                       cache, S + i)
            steps.append(lg.float())
        return torch.stack(steps).cpu()


def _rank(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg()
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    mesh = make_process_mesh((1, RANKS), ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    out = {}
    with sh.use_policy(pol):
        for dtype in (torch.float32, torch.bfloat16):
            params = tpl.init_shard_params(0, cfg, pol, dtype, device=dev)
            fa.reset_launch_counts()
            out[dtype] = _greedy(params, cfg, prompts, dtype, dev)
            out[(dtype, "routes")] = dict(fa.ROUTE_CALLS)
    full = tr.init_train_state(0, cfg, TC, device=dev)["params"]
    batch = SyntheticPipeline(cfg, 8, 32, device=dev).batch_at(0)
    for shape, seq in TRAIN:
        tmesh = make_process_mesh(shape, ("data", "model"), device=dev)
        rules = sh.default_rules(False, fsdp=False)
        tpol = sh.ShardingPolicy(tmesh, sh.with_sequence_tp(rules)
                                 if seq else rules)
        local = opt.tree_map(lambda x: x.clone(),
                             tpl.shard_params(full, cfg, tpol))
        state = {"params": local, "opt": opt.init_opt_state(local, TC.opt),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        with sh.use_policy(tpol):
            new, m = tr.make_train_step(cfg, TC)(state, batch)
            grads, _ = tr._policy_grads(local, cfg, TC, batch, tpol)
            grads = tpl.gather_params(grads, cfg, tpol)
            params = tpl.gather_params(new["params"], cfg, tpol)
        out[(shape, seq)] = (float(m["loss"]),
                             [g.cpu() for g in opt.tree_leaves(grads)],
                             [p.cpu() for p in opt.tree_leaves(params)])
    return out


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import backward as fab
    fa.build()
    fab.build()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def ranks(card):
    return run_ranks(_rank, RANKS, backend="gloo", device="cuda",
                     timeout_s=600)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
def test_flash_takes_tensor_core_at_g8(card):
    """The local heads of qwen2-72b at model 4 (16 on 2, hd 128): bf16
    prefill on the tensor cores, decode on split-kv, fp32 on the CUDA
    cores; the launch agrees with the plain version."""
    assert fa.route(torch.bfloat16, 1024, 16, 2, 128, True) == "tensor_core"
    assert fa.route(torch.bfloat16, 1, 16, 2, 128, True) == "split_kv"
    assert fa.route(torch.float32, 256, 16, 2, 128, True) == "cuda_core"
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(2, 256, 16, 128, generator=g, device=card,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(2, 256, 2, 128, generator=g, device=card,
                        dtype=torch.bfloat16) for _ in range(2))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.ROUTE_CALLS["tensor_core"] == 1
    want = fa.ref.attention_ref(q.cpu().float(), k.cpu().float(),
                                v.cpu().float(), torch.arange(256), None,
                                causal=True)
    assert _rel(out.cpu(), want) < 2e-2


@pytest.mark.cuda
def test_tp_serving_matches_the_unsharded_run(card, ranks):
    cfg = _cfg()
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1)
                            ).to(card)
    params = lm.init_params(0, cfg, torch.float32, device=card)
    want = _greedy(params, cfg, prompts, torch.float32, card)
    for res in ranks:
        got = res[torch.float32]
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert torch.equal(res[torch.bfloat16], ranks[0][torch.bfloat16])
        assert res[(torch.float32, "routes")] == {
            "tensor_core": 0, "split_kv": 2 * NEW, "cuda_core": 2}
        assert res[(torch.bfloat16, "routes")] == {
            "tensor_core": 2, "split_kv": 2 * NEW, "cuda_core": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seq", TRAIN)
def test_tp_train_step_matches_the_unsharded_step(card, ranks, shape, seq):
    cfg = _cfg()
    state = tr.init_train_state(0, cfg, TC, device=card)
    batch = SyntheticPipeline(cfg, 8, 32, device=card).batch_at(0)
    want_g, _ = tr.accumulate_grads(state["params"], cfg, TC, batch)
    _, m = tr.make_train_step(cfg, TC)(state, batch)
    for res in ranks:
        loss, grads, params = res[(shape, seq)]
        assert abs(loss - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
        assert max(_rel(a, b.cpu()) for a, b in zip(
            grads, opt.tree_leaves(want_g))) <= 1e-4
        tree = [g.to(card) for g in grads]
        upd, _, _ = opt.adamw_update(
            opt.tree_unflatten(state["params"], tree),
            opt.init_opt_state(state["params"], TC.opt), state["params"],
            TC.opt)
        assert max(_rel(a, b.cpu()) for a, b in zip(
            params, opt.tree_leaves(upd))) <= 1e-6
    assert np.isfinite(float(m["loss"]))
