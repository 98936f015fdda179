"""Tensor parallelism of the MoE family on gloo ranks on the CPU, held
against the unsharded port and the JAX package.

Three configs: reduced deepseek-v2-lite-16b (MLA with 4 heads on the one
latent head, 4 routed experts and a shared one, a dense first layer),
reduced grok-1-314b (GQA, 8 query heads on 2 kv heads: duplicated at model
4, 4 experts top-2) and reduced grok-1-314b with 6 experts
(``dataclasses.replace`` on both sides), which model 4 does not divide, so
its experts split by their FFN dim (the spec resolver's fall-through);
model 2 splits them whole.  The JAX package's weights are carried over
shard by shard (``params_from_jax(..., policy=)``) onto ('data', 'model')
meshes (1, 2), (1, 4) and (2, 4) under ``default_rules(fsdp=False)``, and
(1, 4) with ``with_sequence_tp``; every case under the sorted dispatch and
under ``dense_moe``.  One world a mesh shape, the three spawned once for
the module and run side by side while this process computes the JAX
references; every rank runs all its cases on the whole batch (the tokens
entering a MoE block are whole over 'model', as in the JAX program, so
each rank routes and places every token alike), and the train step splits
the batch over 'data' itself.

Tolerances, those of tests/test_torch_tensor_parallel.py (fp32; the
sharded products and the rank-order sums add in other orders than one
matmul): logits within 2e-5 of the largest |logit|; the loss, the
load-balance loss included, within 1e-5 relative; each gathered gradient
leaf within 1e-5 of that leaf's largest entry; each updated parameter
within 1e-6 of the leaf's largest.  Greedy tokens, ``generate``'s tokens,
the round trip ``gather_params(shard_params(p))`` and the agreement of
the ranks of a model axis are exact.  The rank function imports no JAX."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import MeshShape, make_process_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as serve
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

pytestmark = pytest.mark.slow

# name -> (arch, routed experts: None keeps reduced()'s 4)
CONFIGS = {"deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", None),
           "grok-1-314b": ("grok-1-314b", None),
           "grok-1-314b-e6": ("grok-1-314b", 6)}
NAMES = tuple(CONFIGS)
SHAPES = ((1, 2), (1, 4), (2, 4))
MESHES = [(s, False) for s in SHAPES] + [((1, 4), True)]
CASES = [(n, s, seq, dense) for n in NAMES for s, seq in MESHES
         for dense in (False, True)]
B, S, N_DEC = 4, 16, 4
LOGIT_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 2e-5, 1e-5, 1e-5, 1e-6
TC = tr.TrainConfig(n_microbatches=1, remat=True, dense_moe=True,
                    opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                            decay_steps=50))


def _config(name, archs):
    """The reduced config ``name`` from ``archs`` (the port's or the JAX
    package's registry)."""
    arch, n_routed = CONFIGS[name]
    cfg = archs[arch].reduced()
    if n_routed is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_routed=n_routed))
    return cfg


def _port_config(name):
    from repro_torch.configs import ARCHS
    return _config(name, ARCHS)


def _tokens(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return toks.astype(np.int32)


def _batch(toks):
    t = torch.from_numpy(toks).long()
    return {"tokens": t[:, :-1], "targets": t[:, 1:],
            "loss_mask": torch.ones((B, S))}


def _leaves(tree):
    return [x.detach().clone() for x in opt.tree_leaves(tree)]


def _run_model(params, cfg, toks, dense, dev):
    """forward logits, prefill + N_DEC greedy decode logits and tokens,
    ``generate``'s tokens, the loss (the balance loss included) and its
    gradients (as a tree), under one dispatch."""
    batch = _batch(toks)
    logits = lm.forward(params, cfg, batch["tokens"], dense_moe=dense)[0]
    cache = lm.init_cache(cfg, B, S + N_DEC, torch.float32, device=dev)
    lg, cache = lm.prefill(params, cfg, batch["tokens"], cache,
                           dense_moe=dense)
    steps, tokens = [lg], [lg.argmax(-1)]
    for i in range(N_DEC):
        lg, cache = lm.decode_step(params, cfg, tokens[-1], cache, S + i,
                                   dense_moe=dense)
        steps.append(lg)
        tokens.append(lg.argmax(-1))
    gen = serve.ServeEngine(cfg, params, B, S + N_DEC, torch.float32,
                            dense_moe=dense, device=dev).generate(
        toks[:, :-1], N_DEC + 1)
    loss, grads = tr.value_and_grad(params, cfg, dataclasses.replace(
        TC, remat=False, dense_moe=dense), batch)
    return {"logits": logits.detach(), "steps": torch.stack(steps),
            "tokens": torch.stack(tokens), "generate": gen,
            "loss": float(loss),
            "grads": opt.tree_unflatten(params, grads)}


def _rank(dev, shape, data):
    """Every case of one mesh shape in this rank."""
    mesh = make_process_mesh(shape, ("data", "model"), device=dev)
    out = {}
    for name in NAMES:
        np_params, toks = data[name]
        cfg = _port_config(name)
        full = params_from_jax(np_params, cfg, "cpu")
        for seq in ((False, True) if shape == (1, 4) else (False,)):
            rules = sh.default_rules(False, fsdp=False)
            pol = sh.ShardingPolicy(mesh, sh.with_sequence_tp(rules)
                                    if seq else rules)
            local = params_from_jax(np_params, cfg, "cpu", policy=pol)
            for dense in (False, True):
                with sh.use_policy(pol):
                    got = _run_model(local, cfg, toks, dense, dev)
                    got["grads"] = _leaves(tpl.gather_params(
                        got["grads"], cfg, pol))
                out[(name, seq, dense)] = got
            back = tpl.gather_params(tpl.shard_params(full, cfg, pol), cfg,
                                     pol)
            out[(name, seq, "round_trip")] = all(
                torch.equal(a, b) for a, b in zip(opt.tree_leaves(back),
                                                  opt.tree_leaves(full)))
        if shape == (2, 4):
            pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
            local = params_from_jax(np_params, cfg, "cpu", policy=pol)
            state = {"params": local,
                     "opt": opt.init_opt_state(local, TC.opt),
                     "step": torch.zeros((), dtype=torch.int32)}
            with sh.use_policy(pol):
                new, m = tr.make_train_step(cfg, TC)(state, _batch(toks))
                params = tpl.gather_params(new["params"], cfg, pol)
                grads, _ = tr._policy_grads(local, cfg, TC, _batch(toks),
                                            pol)
                grads = tpl.gather_params(grads, cfg, pol)
            out[(name, "step")] = (_leaves(params), float(m["loss"]),
                                   float(m["grad_norm"]), _leaves(grads))
        if shape == (1, 4) and name != "grok-1-314b-e6":
            # Adafactor under TP: two steps on the shards of one gradient
            # against the unsharded update
            pol = sh.ShardingPolicy(mesh, sh.default_rules(False,
                                                           fsdp=False))
            g, _ = tr.accumulate_grads(full, cfg, TC, _batch(toks))
            ocfg = opt.OptimizerConfig(kind="adafactor", lr=1e-3,
                                       warmup_steps=2, decay_steps=50)
            runs = {}
            for run, p, grads, lay in (
                    ("tp", tpl.shard_params(full, cfg, pol),
                     tpl.shard_params(g, cfg, pol), tpl.layout(cfg, pol)),
                    ("full", full, g, None)):
                st = opt.init_opt_state(p, ocfg)
                with sh.use_policy(pol):
                    for _ in range(2):
                        p, st, _ = opt.adafactor_update(grads, st, p, ocfg,
                                                        lay)
                    if lay is not None:
                        p = tpl.gather_params(p, cfg, pol)
                runs[run] = _leaves(p)
            out[(name, "adafactor")] = runs
    return out


def _jax_params(name, i):
    import jax

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import lm as j_lm
    jp = j_lm.init_params(jax.random.PRNGKey(i), _config(name, J_ARCHS))
    return jp, jax.tree.map(np.asarray, jp)


def _jax_refs(name, jp, toks):
    """The JAX package's outputs of one config, under each dispatch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import lm as j_lm
    jcfg = _config(name, J_ARCHS)
    cfg = _port_config(name)
    tok, tgt = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    ref = {}
    for dense in (False, True):
        logits = j_lm.forward(jp, jcfg, tok, dense_moe=dense)[0]
        cache = j_lm.init_cache(jcfg, B, S + N_DEC, jnp.float32)
        lg, cache = j_lm.prefill(jp, jcfg, tok, cache, dense_moe=dense)
        steps = [lg]
        for j in range(N_DEC):
            nxt = jnp.argmax(steps[-1], -1).astype(jnp.int32)
            lg, cache = j_lm.decode_step(jp, jcfg, nxt, cache,
                                         jnp.asarray(S + j, jnp.int32),
                                         dense_moe=dense)
            steps.append(lg)
        jbatch = {"tokens": tok, "targets": tgt,
                  "loss_mask": jnp.ones((B, S), jnp.float32)}
        (loss, _), grads = jax.value_and_grad(
            lambda p: j_lm.lm_loss(p, jcfg, jbatch, dense_moe=dense),
            has_aux=True)(jp)
        grads = params_from_jax(jax.tree.map(np.asarray, grads), cfg, "cpu")
        ref[dense] = {"logits": np.asarray(logits),
                      "steps": np.stack([np.asarray(s) for s in steps]),
                      "tokens": np.stack([np.argmax(np.asarray(s), -1)
                                          for s in steps]),
                      "loss": float(loss),
                      "grads": [g.numpy() for g in opt.tree_leaves(grads)]}
    return ref


@pytest.fixture(scope="module")
def sides():
    """(the ranks' results by mesh shape, the JAX references): the worlds
    run while this process computes the references."""
    data, jps = {}, {}
    for i, name in enumerate(NAMES):
        jps[name], np_params = _jax_params(name, i)
        data[name] = (np_params, _tokens(_port_config(name), i))
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {shape: pool.submit(run_ranks, _rank, shape[0] * shape[1],
                                   backend="gloo", device="cpu",
                                   args=(shape, data), timeout_s=500)
                for shape in SHAPES}
        ref = {name: _jax_refs(name, jps[name], data[name][1])
               for name in NAMES}
        ranks = {shape: f.result() for shape, f in futs.items()}
    return data, ranks, ref


@pytest.fixture(scope="module")
def ranks(sides):
    return sides[1]


@pytest.fixture(scope="module")
def jax_ref(sides):
    return sides[2]


@pytest.fixture(scope="module")
def port_side(sides):
    """The unsharded port on the same weights: the model's outputs under
    each dispatch, and one full-batch train step's gradient, loss and
    norm."""
    data = sides[0]
    out = {}
    for name in NAMES:
        np_params, toks = data[name]
        cfg = _port_config(name)
        params = params_from_jax(np_params, cfg, "cpu")
        for dense in (False, True):
            got = _run_model(params, cfg, toks, dense, "cpu")
            got["grads"] = _leaves(got["grads"])
            got["generate_by_data_rank"] = np.concatenate([
                serve.ServeEngine(cfg, params, B // 2, S + N_DEC,
                                  torch.float32, dense_moe=dense,
                                  device="cpu").generate(
                    toks[rows, :-1], N_DEC + 1)
                for rows in (slice(0, B // 2), slice(B // 2, B))])
            out[(name, dense)] = got
        state = {"params": params, "opt": opt.init_opt_state(params, TC.opt),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, m = tr.make_train_step(cfg, TC)(state, _batch(toks))
        grads, _ = tr.accumulate_grads(params, cfg, TC, _batch(toks))
        out[(name, "step")] = (_leaves(grads), float(m["loss"]),
                               float(m["grad_norm"]), _leaves(params))
        out[(name, "tree")] = params
    return out


def _worst(got, want) -> float:
    """Largest |got - want| over the leaves, each against its own largest
    |want|."""
    return max(float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), 1e-30))
               for a, b in zip(got, want))


def _ids(case):
    name, shape, seq, dense = case
    return (f"{name}-{shape[0]}x{shape[1]}" + ("-seq_tp" if seq else "")
            + ("-dense" if dense else "-sorted"))


def _router_leaves(name):
    """The routers' places in ``tree_leaves`` order."""
    paths = opt.tree_leaves(sh.map_with_path(
        lambda path, leaf, _: path,
        lm.init_params(0, _port_config(name), device="meta")))
    return [i for i, p in enumerate(paths) if p.endswith("moe/router")]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_logits(case, ranks, port_side, jax_ref):
    name, shape, seq, dense = case
    for want in (port_side[(name, dense)]["logits"].numpy(),
                 jax_ref[name][dense]["logits"]):
        for res in ranks[shape]:
            got = res[(name, seq, dense)]["logits"].numpy()
            assert got.shape == want.shape
            assert _worst([got], [want]) <= LOGIT_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode(case, ranks, port_side, jax_ref):
    name, shape, seq, dense = case
    first = ranks[shape][0][(name, seq, dense)]
    for want in (port_side[(name, dense)], jax_ref[name][dense]):
        steps = want["steps"]
        steps = steps.numpy() if isinstance(steps, torch.Tensor) else steps
        tokens = np.asarray(want["tokens"])
        for res in ranks[shape]:
            got = res[(name, seq, dense)]
            assert _worst([got["steps"].numpy()], [steps]) <= LOGIT_TOL
            assert np.array_equal(got["tokens"].numpy(), tokens)
            assert torch.equal(got["steps"], first["steps"])   # every rank


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_generate_tokens(case, ranks, port_side):
    """``ServeEngine.generate`` under the model axis gives the unsharded
    engine's greedy tokens, on every rank.  On (data 2, model 4) the engine
    splits the slots over 'data', and the sorted dispatch's group is then
    each data rank's rows (its capacity theirs): the reference is the
    unsharded engine on each half of the slots."""
    name, shape, seq, dense = case
    want = port_side[(name, dense)]["generate"]
    assert np.array_equal(want, port_side[(name, dense)]["tokens"].numpy().T)
    if shape[0] > 1:
        want = port_side[(name, dense)]["generate_by_data_rank"]
        if dense:
            assert np.array_equal(want, port_side[(name, dense)]["generate"])
    for res in ranks[shape]:
        assert np.array_equal(res[(name, seq, dense)]["generate"], want)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_gradients(case, ranks, port_side, jax_ref):
    name, shape, seq, dense = case
    for want in (port_side[(name, dense)], jax_ref[name][dense]):
        grads = [np.asarray(g) for g in want["grads"]]
        for res in ranks[shape]:
            got = res[(name, seq, dense)]
            assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(
                want["loss"])
            assert _worst([g.numpy() for g in got["grads"]],
                          grads) <= GRAD_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_router_gradient(case, ranks, port_side, jax_ref):
    """The router's gathered gradient: each rank's combine holds only its
    experts' choices (summed over 'model'), the load-balance loss's part
    is whole on every rank (counted once)."""
    name, shape, seq, dense = case
    idx = _router_leaves(name)
    assert idx
    for want in (port_side[(name, dense)], jax_ref[name][dense]):
        grads = [np.asarray(want["grads"][i]) for i in idx]
        for res in ranks[shape]:
            got = [res[(name, seq, dense)]["grads"][i].numpy() for i in idx]
            assert _worst(got, grads) <= GRAD_TOL


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: f"{m[0][0]}x{m[0][1]}"
                         + ("-seq_tp" if m[1] else ""))
@pytest.mark.parametrize("name", NAMES)
def test_shards_round_trip_bit_for_bit(name, mesh, ranks):
    shape, seq = mesh
    assert all(res[(name, seq, "round_trip")] for res in ranks[shape])


@pytest.mark.parametrize("name", NAMES)
def test_train_step_equals_the_full_batch_step(name, ranks, port_side):
    """One AdamW step on (data 2, model 4) against the unsharded full-batch
    step (``dense_moe``: the sorted dispatch's groups are the caller's),
    as tests/test_torch_tensor_parallel.py holds the dense family."""
    want_grads, loss, gnorm, before = port_side[(name, "step")]
    first = ranks[(2, 4)][0][(name, "step")][0]
    tree = lambda leaves: opt.tree_unflatten(port_side[(name, "tree")],
                                             leaves)
    for res in ranks[(2, 4)]:
        got, got_loss, got_norm, grads = res[(name, "step")]
        assert abs(got_loss - loss) <= LOSS_TOL * abs(loss)
        assert abs(got_norm - gnorm) <= LOSS_TOL * abs(gnorm)
        assert _worst([g.numpy() for g in grads],
                      [w.numpy() for w in want_grads]) <= GRAD_TOL
        want, _, _ = opt.adamw_update(
            tree(grads), opt.init_opt_state(tree(before), TC.opt),
            tree(before), TC.opt)
        assert _worst([g.numpy() for g in got],
                      [w.numpy() for w in opt.tree_leaves(want)]
                      ) <= PARAM_TOL
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_adafactor_under_tp(name, ranks):
    """Two Adafactor steps on the shards of one gradient at (data 1,
    model 4) equal the unsharded update, within 1e-6 of each leaf's
    largest entry (expert leaves split by experts, MLA's by heads, grok's
    kv heads duplicated)."""
    for res in ranks[(1, 4)]:
        runs = res[(name, "adafactor")]
        assert _worst([x.numpy() for x in runs["tp"]],
                      [x.numpy() for x in runs["full"]]) <= PARAM_TOL


@pytest.mark.parametrize("name,model,want", [
    ("deepseek-v2-lite-16b", 4, 0), ("grok-1-314b", 4, 0),
    ("grok-1-314b-e6", 2, 0), ("grok-1-314b-e6", 4, 2)])
def test_expert_layout(name, model, want):
    """The routed experts split by whole experts where the model axis
    divides them, else by their FFN dim (the spec resolver's fall-through,
    ``sharding.py``'s grok-at-TP16 case); the router stays whole, the
    shared experts split by columns and rows, MLA's leaves by heads."""
    cfg = _port_config(name)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, model)),
                            sh.default_rules(False, fsdp=False))
    tp = tpl.layout(cfg, pol)
    group = "group1" if cfg.moe.first_dense_layers else "group0"
    moe = {k.rsplit("/", 1)[1]: v for k, v in tp.plan.items()
           if k.startswith(f"{group}/0/moe/")}
    assert tp.experts == (want == 0)
    assert moe["w1"] == moe["w3"] == ("model", want)
    assert moe["w2"] == ("model", 0 if want == 0 else 1)
    assert moe["router"] == ("rep", None)
    if "shared_w1" in moe:
        assert moe["shared_w1"] == moe["shared_w3"] == ("model", 1)
        assert moe["shared_w2"] == ("model", 0)
    attn = {k.rsplit("/", 1)[1]: v for k, v in tp.plan.items()
            if k.startswith(f"{group}/0/attn/")}
    if cfg.mla:
        assert attn["wq"] == attn["w_uk"] == attn["w_uv"] == ("model", 1)
        assert attn["wo"] == ("model", 0)
        assert attn["w_dkv"] == attn["kv_norm"] == ("rep", None)
    else:
        assert attn["wk"][0] == ("dup" if model > cfg.n_kv_heads
                                 else "model")


def test_init_shard_params_is_init_params_cut():
    """Each rank's leaves drawn one layer at a time equal the full draw's
    shards, bit for bit (the card draws DeepSeek-V2-Lite so)."""
    for name in NAMES:
        cfg = _port_config(name)
        pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                                sh.default_rules(False))
        full = lm.init_params(7, cfg, device="cpu")
        for r in range(4):
            want = tpl.shard_params(full, cfg, pol, model_rank=r)
            got = tpl.init_shard_params(7, cfg, pol, device="cpu",
                                        model_rank=r)
            assert all(torch.equal(a, b) for a, b in zip(
                opt.tree_leaves(got), opt.tree_leaves(want))), (name, r)


@pytest.mark.parametrize("model,G", [(2, 8), (4, 4)])
def test_flash_route_at_the_local_heads(model, G):
    """DeepSeek-V2-Lite at model 2 and 4 gives each rank 8 or 4 of its 16
    heads on the one hd-576 latent head: bf16 prefill takes the wide
    tensor-core route, a decode step split-kv, fp32 the TF32 mma route
    (chip_smoke.py phase 10 (f) launches them)."""
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = get_arch("deepseek-v2-lite-16b")
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, model)),
                            sh.default_rules(False))
    params = tpl.shard_params(lm.init_params(0, cfg, device="meta"), cfg,
                              pol, model_rank=0)
    m = cfg.mla
    H = params["group0"][0]["attn"]["wq"].shape[1] // (
        m.nope_head_dim + m.rope_head_dim)
    hd = m.kv_lora_rank + m.rope_head_dim
    assert (H, hd) == (G, 576)
    assert fa.route(torch.bfloat16, 1024, H, 1, hd, True) == \
        "tensor_core_wide"
    assert fa.route(torch.bfloat16, 1, H, 1, hd, True) == "split_kv"
    assert fa.route(torch.float32, 256, H, 1, hd, True) == "mma_tf32"
    assert fa.route(torch.float32, 1, H, 1, hd, True) == "split_kv"
