"""Tensor parallelism of the dense LM family on gloo ranks on the CPU,
held against the unsharded port and the JAX package.

Reduced qwen2-1.5b (4 query heads on 1 kv head: the kv head duplicated on
every rank), granite-3-2b (8 on 2, tied head), qwen2-72b (8 on 2, QKV
bias, untied head) and llava-next-34b (8 on 2, its dense trunk after 8
patch embeddings drawn with numpy: the vocab-parallel embedding, sequence
TP over prefix + tokens, the loss on the text positions of vocab-parallel
logits), the JAX package's weights carried over shard by shard
(``params_from_jax(..., policy=)``), on ('data', 'model') meshes (1, 2),
(1, 4) and (2, 4) under ``default_rules(fsdp=False)``, and on (1, 4) also
with ``with_sequence_tp``.  One world a mesh shape, the three spawned once
for the module and run side by side; every rank runs all its cases on the
whole batch (the lm functions take a rank's rows as they are given), and
the train step splits the batch over 'data' itself.

Tolerances (fp32; the sharded products and the rank-order sums add in
other orders than one matmul): logits within 2e-5 of the largest
|logit|; the loss within 1e-5 relative; each gathered gradient leaf
within 1e-5 of that leaf's largest entry; each updated parameter within
1e-6 of the leaf's largest (the sharded step's clipping norm sums in
another order, which moves p - lr * step by an ulp of p, about 1e-7 of
it).  Greedy tokens, the round trip
``gather_params(shard_params(p))`` and the agreement of the ranks of a
model axis are exact.  The rank function imports no JAX."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import MeshShape, make_process_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

pytestmark = pytest.mark.slow

ARCHS = ("qwen2-1.5b", "granite-3-2b", "qwen2-72b", "llava-next-34b")
SHAPES = ((1, 2), (1, 4), (2, 4))
CASES = [(a, s, False) for a in ARCHS for s in SHAPES] + \
        [(a, (1, 4), True) for a in ARCHS]
B, S, N_DEC = 4, 16, 4
LOGIT_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 2e-5, 1e-5, 1e-5, 1e-6
TC = tr.TrainConfig(n_microbatches=1, remat=True,
                    opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                            decay_steps=50))


def _tokens(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return toks.astype(np.int32)


def _prefix(cfg, seed=0):
    """A VLM's patch embeddings [B, n_front, D] (None for the others)."""
    if cfg.family != "vlm":
        return None
    return (0.02 * np.random.default_rng(seed + 100).normal(
        size=(B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def _batch(cfg, toks, pe):
    t = torch.from_numpy(toks).long()
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:],
             "loss_mask": torch.ones((B, S))}
    if pe is not None:
        batch["prefix_embeds"] = torch.from_numpy(pe)
    return batch


def _leaves(tree):
    return [x.detach().clone() for x in opt.tree_leaves(tree)]


def _run_model(params, cfg, toks, pe, dev):
    """forward logits, prefill + N_DEC greedy decode logits and tokens, the
    loss and its gradients (in ``tree_leaves`` order, as a tree)."""
    batch = _batch(cfg, toks, pe)
    pre = batch.get("prefix_embeds")
    n_front = 0 if pe is None else pe.shape[1]
    logits = lm.forward(params, cfg, batch["tokens"], prefix_embeds=pre)[0]
    cache = lm.init_cache(cfg, B, n_front + S + N_DEC, torch.float32,
                          device=dev)
    lg, cache = lm.prefill(params, cfg, batch["tokens"], cache,
                           prefix_embeds=pre)
    steps, tokens = [lg], [lg.argmax(-1)]
    for i in range(N_DEC):
        lg, cache = lm.decode_step(params, cfg, tokens[-1], cache,
                                   n_front + S + i)
        steps.append(lg)
        tokens.append(lg.argmax(-1))
    loss, grads = tr.value_and_grad(params, cfg, dataclasses.replace(
        TC, remat=False), batch)
    return {"logits": logits.detach(), "steps": torch.stack(steps),
            "tokens": torch.stack(tokens), "loss": float(loss),
            "grads": opt.tree_unflatten(params, grads)}


def _rank(dev, shape, data):
    """Every case of one mesh shape in this rank."""
    mesh = make_process_mesh(shape, ("data", "model"), device=dev)
    out = {}
    for arch in ARCHS:
        np_params, toks, pe = data[arch]
        cfg = get_arch(arch).reduced()
        full = params_from_jax(np_params, cfg, "cpu")
        for seq_tp in ((False, True) if shape == (1, 4) else (False,)):
            rules = sh.default_rules(False, fsdp=False)
            pol = sh.ShardingPolicy(mesh, sh.with_sequence_tp(rules)
                                    if seq_tp else rules)
            local = params_from_jax(np_params, cfg, "cpu", policy=pol)
            with sh.use_policy(pol):
                got = _run_model(local, cfg, toks, pe, dev)
                got["grads"] = _leaves(tpl.gather_params(got["grads"], cfg,
                                                         pol))
            back = tpl.gather_params(tpl.shard_params(full, cfg, pol), cfg,
                                     pol)
            got["round_trip"] = all(
                torch.equal(a, b) for a, b in zip(opt.tree_leaves(back),
                                                  opt.tree_leaves(full)))
            out[(arch, seq_tp)] = got
        if shape == (2, 4):
            pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
            local = params_from_jax(np_params, cfg, "cpu", policy=pol)
            state = {"params": local,
                     "opt": opt.init_opt_state(local, TC.opt),
                     "step": torch.zeros((), dtype=torch.int32)}
            with sh.use_policy(pol):
                new, m = tr.make_train_step(cfg, TC)(state,
                                                     _batch(cfg, toks, pe))
                params = tpl.gather_params(new["params"], cfg, pol)
                # the step's gradient, taken again the same way
                grads, _ = tr._policy_grads(local, cfg, TC,
                                            _batch(cfg, toks, pe), pol)
                grads = tpl.gather_params(grads, cfg, pol)
            out[(arch, "step")] = (_leaves(params), float(m["loss"]),
                                   float(m["grad_norm"]), _leaves(grads))
    if shape == (1, 4):
        # Adafactor under TP: two steps on qwen2-72b's shards of one
        # gradient (kv heads duplicated at model 4), and the unsharded
        # update
        np_params, toks, pe = data["qwen2-72b"]
        cfg = get_arch("qwen2-72b").reduced()
        pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
        full = params_from_jax(np_params, cfg, "cpu")
        g, _ = tr.accumulate_grads(full, cfg, TC, _batch(cfg, toks, pe))
        ocfg = opt.OptimizerConfig(kind="adafactor", lr=1e-3,
                                   warmup_steps=2, decay_steps=50)
        runs = {}
        for name, p, grads, lay in (
                ("tp", tpl.shard_params(full, cfg, pol),
                 tpl.shard_params(g, cfg, pol), tpl.layout(cfg, pol)),
                ("full", full, g, None)):
            st = opt.init_opt_state(p, ocfg)
            with sh.use_policy(pol):
                for _ in range(2):
                    p, st, _ = opt.adafactor_update(grads, st, p, ocfg, lay)
                if lay is not None:
                    p = tpl.gather_params(p, cfg, pol)
            runs[name] = _leaves(p)
        out["adafactor"] = runs
    if shape == (2, 4):
        # tests/multidevice/driver_trainer.py::test_sequence_tp_loss_
        # unchanged: granite-3-2b, batch 2 x 16, with_sequence_tp(
        # default_rules) on (data 2, model 4); each data rank its row
        np_params, toks = data["seq_tp_granite"]
        cfg = get_arch("granite-3-2b").reduced()
        pol = sh.ShardingPolicy(mesh, sh.with_sequence_tp(
            sh.default_rules(False)))
        local = params_from_jax(np_params, cfg, "cpu", policy=pol)
        batch = {k: torch.from_numpy(v.copy()) for k, v in toks.items()}
        with sh.use_policy(pol):
            loss, _ = lm.lm_loss(local, cfg, tpl.local_rows(pol, batch))
            out["seq_tp_granite"] = float(tpl.mean_over_batch(pol, loss, 2))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's weights and batches, and its references."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as J_ARCHS
    from repro.models import frontends as j_front
    from repro.models import lm as j_lm

    data, ref = {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg = J_ARCHS[arch].reduced()
        jp = j_lm.init_params(jax.random.PRNGKey(i), jcfg)
        np_params = jax.tree.map(np.asarray, jp)
        cfg = get_arch(arch).reduced()
        toks, pe = _tokens(cfg, i), _prefix(cfg, i)
        data[arch] = (np_params, toks, pe)
        tok, tgt = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
        pre = None if pe is None else jnp.asarray(pe)
        n_front = 0 if pe is None else pe.shape[1]
        logits = j_lm.forward(jp, jcfg, tok, prefix_embeds=pre)[0]
        cache = j_lm.init_cache(jcfg, B, n_front + S + N_DEC, jnp.float32)
        lg, cache = j_lm.prefill(jp, jcfg, tok, cache, prefix_embeds=pre)
        steps = [lg]
        for j in range(N_DEC):
            nxt = jnp.argmax(steps[-1], -1).astype(jnp.int32)
            lg, cache = j_lm.decode_step(
                jp, jcfg, nxt, cache, jnp.asarray(n_front + S + j, jnp.int32))
            steps.append(lg)
        jbatch = {"tokens": tok, "targets": tgt,
                  "loss_mask": jnp.ones((B, S), jnp.float32)}
        if pre is not None:
            jbatch["prefix_embeds"] = pre
        (loss, _), grads = jax.value_and_grad(
            lambda p: j_lm.lm_loss(p, jcfg, jbatch), has_aux=True)(jp)
        grads = params_from_jax(jax.tree.map(np.asarray, grads), cfg, "cpu")
        ref[arch] = {"logits": np.asarray(logits),
                     "steps": np.stack([np.asarray(s) for s in steps]),
                     "tokens": np.stack([np.argmax(np.asarray(s), -1)
                                         for s in steps]),
                     "loss": float(loss),
                     "grads": [g.numpy() for g in opt.tree_leaves(grads)]}
    gcfg = J_ARCHS["granite-3-2b"].reduced()
    gp = j_lm.init_params(jax.random.PRNGKey(0), gcfg)
    gb = j_front.make_train_batch(jax.random.PRNGKey(1), gcfg, batch=2,
                                  seq=16)
    data["seq_tp_granite"] = (jax.tree.map(np.asarray, gp),
                              {k: np.asarray(v) for k, v in gb.items()})
    ref["seq_tp_granite"] = float(j_lm.lm_loss(gp, gcfg, gb)[0])
    return data, ref


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The unsharded port on the same weights: the model's outputs, the
    granite sequence-TP case's loss, and one full-batch train step's loss,
    norm and gradient."""
    data, _ = jax_side
    out = {}
    for arch in ARCHS:
        np_params, toks, pe = data[arch]
        cfg = get_arch(arch).reduced()
        params = params_from_jax(np_params, cfg, "cpu")
        got = _run_model(params, cfg, toks, pe, "cpu")
        got["grads"] = _leaves(got["grads"])
        state = {"params": params, "opt": opt.init_opt_state(params, TC.opt),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, m = tr.make_train_step(cfg, TC)(state, _batch(cfg, toks, pe))
        grads, _ = tr.accumulate_grads(params, cfg, TC,
                                       _batch(cfg, toks, pe))
        out[arch] = got
        out[(arch, "step")] = (_leaves(grads), float(m["loss"]),
                               float(m["grad_norm"]), _leaves(params))
        out[(arch, "tree")] = params
    np_params, toks = data["seq_tp_granite"]
    cfg = get_arch("granite-3-2b").reduced()
    loss, _ = lm.lm_loss(params_from_jax(np_params, cfg, "cpu"), cfg,
                         {k: torch.from_numpy(v.copy())
                          for k, v in toks.items()})
    out["seq_tp_granite"] = float(loss)
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    data, _ = jax_side
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {shape: pool.submit(run_ranks, _rank, shape[0] * shape[1],
                                   backend="gloo", device="cpu",
                                   args=(shape, data), timeout_s=400)
                for shape in SHAPES}
        return {shape: f.result() for shape, f in futs.items()}


def _worst(got, want) -> float:
    """Largest |got - want| over the leaves, each against its own largest
    |want|."""
    return max(float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), 1e-30))
               for a, b in zip(got, want))


def _ids(case):
    arch, shape, seq = case
    return f"{arch}-{shape[0]}x{shape[1]}" + ("-seq_tp" if seq else "")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_logits(case, ranks, port_side, jax_side):
    arch, shape, seq = case
    for want in (port_side[arch]["logits"].numpy(),
                 jax_side[1][arch]["logits"]):
        for res in ranks[shape]:
            got = res[(arch, seq)]["logits"].numpy()
            assert got.shape == want.shape
            assert _worst([got], [want]) <= LOGIT_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode(case, ranks, port_side, jax_side):
    arch, shape, seq = case
    first = ranks[shape][0][(arch, seq)]
    for want in (port_side[arch], jax_side[1][arch]):
        steps = want["steps"]
        steps = steps.numpy() if isinstance(steps, torch.Tensor) else steps
        tokens = np.asarray(want["tokens"])
        for res in ranks[shape]:
            got = res[(arch, seq)]
            assert _worst([got["steps"].numpy()], [steps]) <= LOGIT_TOL
            assert np.array_equal(got["tokens"].numpy(), tokens)
            assert torch.equal(got["steps"], first["steps"])   # every rank


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_gradients(case, ranks, port_side, jax_side):
    arch, shape, seq = case
    for want in (port_side[arch], jax_side[1][arch]):
        grads = [np.asarray(g) for g in want["grads"]]
        for res in ranks[shape]:
            got = res[(arch, seq)]
            assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(
                want["loss"])
            assert _worst([g.numpy() for g in got["grads"]],
                          grads) <= GRAD_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_shards_round_trip_bit_for_bit(case, ranks):
    arch, shape, seq = case
    assert all(res[(arch, seq)]["round_trip"] for res in ranks[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_full_batch_step(arch, ranks, port_side):
    """One AdamW step on (data 2, model 4) against the unsharded full-batch
    step: its loss and clipping norm, its gradient, and its updated
    parameters against the unsharded AdamW fed that gradient (a first
    AdamW step is about lr * sign(g), so where g is near 0 it follows the
    gradient's last bits, which only the gradient check can hold)."""
    want_grads, loss, gnorm, before = port_side[(arch, "step")]
    first = ranks[(2, 4)][0][(arch, "step")][0]
    for res in ranks[(2, 4)]:
        got, got_loss, got_norm, grads = res[(arch, "step")]
        assert abs(got_loss - loss) <= LOSS_TOL * abs(loss)
        assert abs(got_norm - gnorm) <= LOSS_TOL * abs(gnorm)
        assert _worst([g.numpy() for g in grads],
                      [w.numpy() for w in want_grads]) <= GRAD_TOL
        tree = lambda leaves: opt.tree_unflatten(
            port_side[(arch, "tree")], leaves)
        want, _, _ = opt.adamw_update(
            tree(grads), opt.init_opt_state(tree(before), TC.opt),
            tree(before), TC.opt)
        assert _worst([g.numpy() for g in got],
                      [w.numpy() for w in opt.tree_leaves(want)]
                      ) <= PARAM_TOL
        assert all(torch.equal(a, b) for a, b in zip(got, first))


def test_sequence_tp_loss_unchanged(ranks, port_side, jax_side):
    """The counterpart of tests/multidevice/driver_trainer.py::
    test_sequence_tp_loss_unchanged (which allows 1e-4): granite-3-2b on
    (data 2, model 4) under with_sequence_tp(default_rules)."""
    want = port_side["seq_tp_granite"]
    assert abs(want - jax_side[1]["seq_tp_granite"]) <= LOSS_TOL * abs(want)
    for res in ranks[(2, 4)]:
        assert abs(res["seq_tp_granite"] - want) <= LOSS_TOL * abs(want)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_families_without_tp_raise(arch):
    cfg = get_arch(arch).reduced()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    params = lm.init_params(0, cfg, device="meta")
    with sh.use_policy(pol), pytest.raises(NotImplementedError,
                                           match="ROADMAP.md"):
        lm.forward(params, cfg, torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpl.shard_params(params, cfg, pol, model_rank=0)


def test_adafactor_under_tp_raises(ranks):
    """Adafactor under a model axis no longer raises: two steps on
    qwen2-72b's shards at (data 1, model 4) (kv heads duplicated) equal
    the unsharded update on the same gradient, within 1e-6 of each leaf's
    largest entry (its factored means and update RMS are the unsharded
    leaf's: ``TensorParallel.full_mean``)."""
    for res in ranks[(1, 4)]:
        runs = res["adafactor"]
        assert _worst([x.numpy() for x in runs["tp"]],
                      [x.numpy() for x in runs["full"]]) <= PARAM_TOL


def test_a_shape_only_mesh_does_not_run():
    cfg = get_arch("qwen2-72b").reduced()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    with sh.use_policy(pol), pytest.raises(ValueError, match="ProcessMesh"):
        lm.forward(lm.init_params(0, cfg, device="cpu"), cfg,
                   torch.zeros((1, 8), dtype=torch.long))


def test_init_shard_params_is_init_params_cut():
    """Each rank's leaves drawn one at a time equal the full draw's
    shards, bit for bit (the card draws qwen2-72b so)."""
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                                sh.default_rules(False))
        full = lm.init_params(7, cfg, device="cpu")
        for r in range(4):
            want = tpl.shard_params(full, cfg, pol, model_rank=r)
            got = tpl.init_shard_params(7, cfg, pol, device="cpu",
                                        model_rank=r)
            assert all(torch.equal(a, b) for a, b in zip(
                opt.tree_leaves(got), opt.tree_leaves(want))), (arch, r)


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_init_params_cuts_every_leaf_once(arch):
    """``init_params(cut=)`` hands every leaf to the cut once, under the
    path ``map_with_path`` gives it, and builds the tree of what the cut
    returns (a negating cut: the uncut draw negated, bit for bit)."""
    cfg = get_arch(arch).reduced()
    seen = []

    def cut(path, leaf):
        seen.append(path)
        return -leaf
    got = lm.init_params(3, cfg, device="cpu", cut=cut)
    want = lm.init_params(3, cfg, device="cpu")
    paths = []
    sh.map_with_path(lambda path, leaf, _: paths.append(path), want)
    assert sorted(seen) == sorted(paths) and len(set(seen)) == len(seen)
    assert all(torch.equal(a, -b) for a, b in zip(opt.tree_leaves(got),
                                                  opt.tree_leaves(want)))


def test_flash_route_at_the_local_heads():
    """qwen2-72b at model 4 gives each rank 16 query heads on 2 kv heads
    (G = 8, hd 128): bf16 prefill takes the tensor cores, a decode step
    split-kv, fp32 the TF32 mma route (the card side launches them in
    tests/test_torch_tp_cuda.py)."""
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = get_arch("qwen2-72b")
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    params = tpl.shard_params(lm.init_params(0, cfg, device="meta"), cfg,
                              pol, model_rank=0)
    attn = params["group0"][0]["attn"]
    H, KV = attn["wq"].shape[1] // 128, attn["wk"].shape[1] // 128
    assert (H, KV) == (16, 2)
    assert fa.route(torch.bfloat16, 1024, H, KV, 128, True) == "tensor_core"
    assert fa.route(torch.bfloat16, 1, H, KV, 128, True) == "split_kv"
    assert fa.route(torch.float32, 256, H, KV, 128, True) == "mma_tf32"
