"""ZeRO-3 (the FSDP overlay of ``default_rules``, executed) on gloo ranks
on the CPU, held against the JAX package's unsharded step.

At ``reduced()`` no leaf reaches the overlay's 2^16 elements, so ZeRO-3
would split nothing there: every arch runs at ``reduced()`` widened the
same way on both sides (``_wide``: vocabulary 2,048 and d_ff 512, MoE
experts of d_ff 128, and Whisper's d_ff 32,768, whose FFN biases
``[2, 32768]`` the overlay splits by whole layers).  The JAX
package's weights are carried over shard by shard (``params_from_jax(...,
policy=)``); the worlds run while this process computes the JAX
references.  One gloo world a mesh shape, (data, model) = (2, 1), (1, 2),
(2, 2) and (2, 4), spawned once for the module and run side by side:

* one AdamW step, one microbatch of the whole batch (each data rank its
  rows): every arch on (2, 1), the dense and VLM archs on (2, 2) and
  (2, 4), the MoE archs on (2, 2) (experts split over 'model', the
  overlay's 'data' on another dim); loss within 1e-5 relative of the JAX ``value_and_grad`` loss;
  each gathered gradient leaf within 1e-5 of that leaf's largest entry
  (a leaf below 1e-3 of the tree's largest gradient, zero up to rounding
  as Whisper's key biases are, against 1e-3 of the tree's largest;
  RWKV6's unsharded port reads 7.2e-6 of it on these weights, the WKV
  recurrence's fp32 order, and 1.1e-5 on some other draws); the
  gathered updated parameters within 1e-6 of each leaf's largest entry of
  the JAX ``adamw_update`` fed that gradient; every rank's state bytes
  (params, m, v) equal to ``tree_local_bytes`` of ``train_state_pspecs``;
* ``gather_params(shard_params(p)) == p`` bit for bit, the same meshes;
* Adafactor on the same gradients (the JAX ``value_and_grad``'s, cut for
  each rank), two steps, against the JAX ``adafactor_update``: qwen2-72b
  on (1, 2), (2, 1) and (2, 2) and Whisper (stacks split by layers) on
  (2, 1), within 1e-6 of each leaf's largest entry; and against the
  unsharded port's Adafactor on the same gradients, the same tolerance.
  A leaf whose gradient is zero up to rounding (below 1e-3 of the tree's
  largest: Whisper's key biases, ~1e-10 of it) is held to the unsharded
  port only: Adafactor divides such a gradient by its own RMS, and the
  XLA CPU reference flushes the subnormal squares that torch keeps, so
  the unsharded port already differs from it there by O(1) of the
  leaf;
* a ZeRO-3 run checkpointed per rank and resumed is bit-identical to the
  run without a break (Whisper on (2, 1): its empty layer blocks too);
* ``forward``, ``prefill`` and ``decode_step`` under ZeRO-3 on (2, 1)
  (Qwen2-1.5B, Whisper) within 2e-5 of the largest |logit| of the
  unsharded port;
* the launcher's ``--mesh 2,2`` on reduced qwen2-1.5b: each rank's state
  bytes equal the specs', and a preempted run resumed from its per-rank
  checkpoints gives the uninterrupted run's losses bit for bit.

The rank function imports no JAX; the JAX references are computed in the
test process."""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.launch import RankError, run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

ARCHS = tuple(sorted(ALL_ARCHS))
DENSE = tuple(a for a in ARCHS if ALL_ARCHS[a].family in ("dense", "vlm"))
SHAPES = ((2, 1), (1, 2), (2, 2), (2, 4))
MOE = tuple(a for a in ARCHS if ALL_ARCHS[a].family == "moe")
STEP_CASES = ([(a, (2, 1)) for a in ARCHS]
              + [(a, s) for s in ((2, 2), (2, 4)) for a in DENSE]
              + [(a, (2, 2)) for a in MOE])
SERVE_ARCHS = ("qwen2-1.5b", "whisper-large-v3")
ADAFACTOR_CASES = [("qwen2-72b", s) for s in ((1, 2), (2, 1), (2, 2))] + \
    [("whisper-large-v3", (2, 1))]
B, S = 4, 16
LOSS_TOL, GRAD_TOL, PARAM_TOL, FLOOR = 1e-5, 1e-5, 1e-6, 1e-3
OCFG = dict(lr=1e-3, warmup_steps=2, decay_steps=50)
TC = tr.TrainConfig(n_microbatches=1, remat=True, dense_moe=True,
                    opt=opt.OptimizerConfig(**OCFG))
AF = opt.OptimizerConfig(kind="adafactor", **OCFG)


def _wide(cfg):
    """``cfg.reduced()`` widened so that the overlay splits leaves (the
    same for a JAX or a port config)."""
    cfg = cfg.reduced()
    kw = dict(vocab_size=2048, d_ff=512)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff_expert=128)
    if cfg.family == "encdec":
        kw["d_ff"] = 32768
    return dataclasses.replace(cfg, **kw)


def _np_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "loss_mask": np.ones((B, S), np.float32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = (0.02 * rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _batch(np_batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in np_batch.items()}


def _leaves(tree):
    return [x.detach().clone() for x in opt.tree_leaves(tree)]


def _state(params, ocfg):
    return {"params": params, "opt": opt.init_opt_state(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32)}


def _state_bytes(state, cfg, pol):
    """(this rank's bytes of params, m and v, the bytes the specs of
    ``train_state_pspecs`` give it), both without the duplicated kv heads
    (the documented exception, held in tests/test_torch_zero3_specs.py)."""
    meta = tr.init_train_state(0, cfg, TC, device="meta")
    specs = tr.train_state_pspecs(meta, pol)["state"]
    kinds = tpl.layout(cfg, pol).kinds
    got = want = 0
    for name in ("params", "m", "v"):
        tree = state[name] if name == "params" else state["opt"][name]
        mtree = meta[name] if name == "params" else meta["opt"][name]
        spec = specs[name] if name == "params" else specs["opt"][name]
        for x, mx, s, kind in zip(opt.tree_leaves(tree),
                                  opt.tree_leaves(mtree),
                                  sh.spec_leaves(spec), kinds):
            if kind != "dup":
                got += x.numel() * x.element_size()
                want += (int(np.prod(sh.local_shape(mx.shape, s, pol.mesh)))
                         * mx.element_size())
    return got, want


def _restart(cfg, pol, local, batch, where):
    """Three steps straight, and one step, a per-rank checkpoint, a
    restore into fresh state and two steps: the final states' leaves."""
    step = tr.make_train_step(cfg, TC)
    fresh = lambda: _state(opt.tree_map(lambda x: x.clone(), local), TC.opt)
    with sh.use_policy(pol):
        state = fresh()
        for _ in range(3):
            state, _ = step(state, batch)
        straight = _leaves(state)
        state, _ = step(fresh(), batch)
        ckpt.save_checkpoint(state, where, 0)
        state, _ = ckpt.restore_checkpoint(fresh(), where)
        for _ in range(2):
            state, _ = step(state, batch)
    return all(torch.equal(a, b) for a, b in zip(straight, _leaves(state)))


def _rank(dev, shape, data, tmp):
    """Every case of one mesh shape in this rank."""
    mesh = make_process_mesh(shape, ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
    out = {}
    for arch, at in STEP_CASES:
        if at != shape:
            continue
        np_params, np_batch, _ = data[arch]
        cfg = _wide(get_arch(arch))
        full = params_from_jax(np_params, cfg, "cpu")
        local = params_from_jax(np_params, cfg, "cpu", policy=pol)
        batch = _batch(np_batch)
        state = _state(local, TC.opt)
        with sh.use_policy(pol):
            new, m = tr.make_train_step(cfg, TC)(state, batch)
            grads, _ = tr._policy_grads(local, cfg, TC, batch, pol)
            grads = tpl.gather_params(grads, cfg, pol)
            params = tpl.gather_params(new["params"], cfg, pol)
        back = tpl.gather_params(tpl.shard_params(full, cfg, pol), cfg, pol)
        out[("step", arch)] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": _leaves(grads), "params": _leaves(params),
            "bytes": _state_bytes(state, cfg, pol),
            "kinds": sorted(set(tpl.layout(cfg, pol).zkinds)),
            "round_trip": all(torch.equal(a, b) for a, b in zip(
                opt.tree_leaves(back), opt.tree_leaves(full)))}
    for arch, at in ADAFACTOR_CASES:
        if at != shape:
            continue
        np_params, _, np_grads = data[arch]
        cfg = _wide(get_arch(arch))
        p = params_from_jax(np_params, cfg, "cpu", policy=pol)
        g = params_from_jax(np_grads, cfg, "cpu", policy=pol)
        st = opt.init_opt_state(p, AF)
        with sh.use_policy(pol):
            lay = tpl.for_update(cfg)
            for _ in range(2):
                p, st, _ = opt.adafactor_update(g, st, p, AF, lay)
            out[("adafactor", arch)] = _leaves(tpl.gather_params(p, cfg,
                                                                 pol))
    if shape == (2, 1):
        np_params, np_batch, _ = data["whisper-large-v3"]
        cfg = _wide(get_arch("whisper-large-v3"))
        local = params_from_jax(np_params, cfg, "cpu", policy=pol)
        out["restart"] = _restart(cfg, pol, local, _batch(np_batch),
                                  f"{tmp}/rank{mesh.rank}")
        for arch in SERVE_ARCHS:
            np_params, np_batch, _ = data[arch]
            cfg = _wide(get_arch(arch))
            full = params_from_jax(np_params, cfg, "cpu")
            local = params_from_jax(np_params, cfg, "cpu", policy=pol)
            batch = _batch(np_batch)
            want = _serve(full, cfg, batch)
            with sh.use_policy(pol):
                got = _serve(local, cfg, batch)
            out[("serve", arch)] = (got, want)
    return out


def _serve(params, cfg, batch):
    """``forward``'s logits, and ``prefill`` then two greedy
    ``decode_step``s' logits, under whatever policy is active."""
    extra = {k: batch[k] for k in ("prefix_embeds", "enc_frames")
             if k in batch}
    logits = lm.forward(params, cfg, batch["tokens"], **extra)[0]
    n_front = (batch["prefix_embeds"].shape[1] if "prefix_embeds" in batch
               else 0)
    L = n_front + S
    cache = lm.init_cache(cfg, B, L + 2, torch.float32, device="cpu")
    lg, cache = lm.prefill(params, cfg, batch["tokens"], cache, **extra)
    steps = [lg]
    for i in range(2):
        lg, cache = lm.decode_step(params, cfg, steps[-1].argmax(-1), cache,
                                   L + i)
        steps.append(lg)
    return [logits.detach()] + [x.detach() for x in steps]


def _jax_tree(port_tree):
    """A port-layout tree of numpy arrays as the JAX package's tree (each
    layer stack stacked on a leading [L] axis)."""
    def stack(*xs):
        return np.stack(xs)
    return {k: (opt.tree_map(stack, *v) if isinstance(v, list) else v)
            for k, v in port_tree.items()}


def _draw(arch, seed):
    """The JAX package's weights (as numpy) and the batch."""
    import jax
    from repro.configs import ARCHS as J_ARCHS
    from repro.models import lm as j_lm
    jp = j_lm.init_params(jax.random.PRNGKey(seed), _wide(J_ARCHS[arch]))
    return (jax.tree.map(np.asarray, jp),
            _np_batch(_wide(get_arch(arch)), seed))


def _jax_refs(arch, np_params, np_batch):
    """The JAX package's loss and gradient (and, for the Adafactor archs,
    two ``adafactor_update`` steps) on these weights and batch, and the
    unsharded port's Adafactor on that gradient."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as J_ARCHS
    from repro.models import lm as j_lm
    from repro.train import optimizer as j_opt
    jcfg, cfg = _wide(J_ARCHS[arch]), _wide(get_arch(arch))
    jp = jax.tree.map(jnp.asarray, np_params)
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm.lm_loss(p, jcfg, b, dense_moe=True),
        has_aux=True))(jp, jbatch)
    np_grads = jax.tree.map(np.asarray, grads)
    ref = {"loss": float(loss), "np_grads": np_grads,
           "grads": [g.numpy() for g in opt.tree_leaves(
               params_from_jax(np_grads, cfg, "cpu"))]}
    if arch in {a for a, _ in ADAFACTOR_CASES}:
        jocfg = j_opt.OptimizerConfig(kind="adafactor", **OCFG)
        p, st = jp, j_opt.init_opt_state(jp, jocfg)
        for _ in range(2):
            p, st, _ = j_opt.adafactor_update(grads, st, p, jocfg)
        ref["adafactor"] = [x.numpy() for x in opt.tree_leaves(
            params_from_jax(jax.tree.map(np.asarray, p), cfg, "cpu"))]
        pp = params_from_jax(np_params, cfg, "cpu")
        gg = params_from_jax(np_grads, cfg, "cpu")
        st = opt.init_opt_state(pp, AF)
        for _ in range(2):
            pp, st, _ = opt.adafactor_update(gg, st, pp, AF)
        ref["adafactor_port"] = [x.numpy() for x in opt.tree_leaves(pp)]
    return ref


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(every world's results, the JAX references): the Adafactor archs'
    JAX gradients first (the ranks take them), then the worlds run side by
    side while this process computes the other references."""
    tmp = str(tmp_path_factory.mktemp("zero3_ckpt"))
    drawn = {arch: _draw(arch, i) for i, arch in enumerate(ARCHS)}
    first = [a for a in ARCHS if a in {a for a, _ in ADAFACTOR_CASES}]
    ref = {a: _jax_refs(a, *drawn[a]) for a in first}
    data = {a: drawn[a] + (ref[a]["np_grads"] if a in ref else None,)
            for a in ARCHS}
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futs = {shape: pool.submit(run_ranks, _rank, shape[0] * shape[1],
                                   backend="gloo", device="cpu",
                                   args=(shape, data, tmp), timeout_s=400)
                for shape in SHAPES}
        for a in ARCHS:
            if a not in ref:
                ref[a] = _jax_refs(a, *drawn[a])
        ranks = {shape: f.result() for shape, f in futs.items()}
    for a in ARCHS:
        ref[a]["np_params"] = drawn[a][0]
    return ranks, ref


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_side(both):
    return both


@functools.lru_cache(maxsize=None)
def _jax_adamw():
    import jax
    from repro.train import optimizer as j_opt
    jocfg = j_opt.OptimizerConfig(**OCFG)
    return jax.jit(lambda g, p: j_opt.adamw_update(
        g, j_opt.init_opt_state(p, jocfg), p, jocfg)[0])


def _worst(got, want, floor=0.0) -> float:
    """Largest |got - want| over the leaves, each against its own largest
    |want| (or ``floor`` times the tree's largest, where that is more)."""
    top = max(float(np.abs(b).max()) for b in want)
    return max(float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), floor * top, 1e-30))
               for a, b in zip(got, want))


def _ids(case):
    arch, shape = case
    return f"{arch}-{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", STEP_CASES, ids=_ids)
def test_adamw_step_equals_the_jax_step(case, ranks, jax_side):
    import jax
    arch, shape = case
    want = jax_side[1][arch]
    first = ranks[shape][0][("step", arch)]
    cfg = _wide(get_arch(arch))
    like = params_from_jax(want["np_params"], cfg, "cpu")
    grads = _jax_tree(opt.tree_unflatten(like, [g.numpy()
                                                for g in first["grads"]]))
    upd = _jax_adamw()(grads, want["np_params"])
    upd = [x.numpy() for x in opt.tree_leaves(params_from_jax(
        jax.tree.map(np.asarray, upd), cfg, "cpu"))]
    assert "rep" in first["kinds"] and len(first["kinds"]) > 1
    for res in ranks[shape]:
        got = res[("step", arch)]
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(
            want["loss"])
        assert _worst([g.numpy() for g in got["grads"]], want["grads"],
                      FLOOR) <= GRAD_TOL
        assert _worst([p.numpy() for p in got["params"]], upd) <= PARAM_TOL
        assert got["bytes"][0] == got["bytes"][1]
        assert all(torch.equal(a, b) for a, b in zip(got["params"],
                                                     first["params"]))


@pytest.mark.parametrize("case", STEP_CASES, ids=_ids)
def test_shards_round_trip_bit_for_bit(case, ranks):
    arch, shape = case
    assert all(res[("step", arch)]["round_trip"] for res in ranks[shape])


@pytest.mark.parametrize("case", ADAFACTOR_CASES, ids=_ids)
def test_adafactor_equals_the_jax_update(case, ranks, jax_side):
    arch, shape = case
    ref = jax_side[1][arch]
    top = max(float(np.abs(g).max()) for g in ref["grads"])
    rounding = [float(np.abs(g).max()) < FLOOR * top for g in ref["grads"]]
    for res in ranks[shape]:
        got = [p.numpy() for p in res[("adafactor", arch)]]
        assert _worst(got, ref["adafactor_port"]) <= PARAM_TOL
        assert _worst([a for a, r in zip(got, rounding) if not r],
                      [b for b, r in zip(ref["adafactor"], rounding)
                       if not r]) <= PARAM_TOL


def test_whisper_split_by_layers():
    """Whisper's widened FFN biases are split by whole layers on (2, 1),
    the case the stacked gather runs."""
    from repro_torch.distributed.meshes import MeshShape
    cfg = _wide(get_arch("whisper-large-v3"))
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (2, 1)),
                            sh.default_rules(False))
    z = tpl.layout(cfg, pol).zero3
    assert set(z.stacked) == {"group0", "encoder"}
    assert all(set(v) == {"mlp/b1"} for v in z.stacked.values())


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_under_zero3(arch, ranks):
    """``forward``, ``prefill`` and ``decode_step`` under ZeRO-3 on (2, 1)
    (each split leaf gathered at its use; Whisper's cross keys from its
    decoder stack, its FFN biases split by layers) give the unsharded
    port's logits within 2e-5 of the largest |logit|."""
    for res in ranks[(2, 1)]:
        got, want = res[("serve", arch)]
        assert _worst([g.numpy() for g in got],
                      [w.numpy() for w in want]) <= 2e-5


def test_restart_is_bit_identical(ranks):
    assert all(res["restart"] for res in ranks[(2, 1)])


def _launcher_args(**kw):
    args = launch_train._parser().parse_args(
        ["--mesh", "2,2", "--device", "cpu", "--steps", "6", "--batch", "8",
         "--seq", "16", "--ckpt-every", "2"])
    return {**vars(args), **kw}


def test_launcher_mesh_state_bytes_and_resume(tmp_path):
    """``--mesh 2,2`` on reduced qwen2-1.5b: state bytes a rank equal the
    specs'; preempted at step 4 and resumed, the losses of the run without
    a break, bit for bit."""
    run = lambda args: run_ranks(launch_train._mesh_rank, 4, backend="gloo",
                                 device="cpu", args=(args, (2, 2)),
                                 timeout_s=300)
    straight = run(_launcher_args())
    for res in straight:
        got = res["state_bytes"]
        assert got["held"] == got["specs"] and got["duplicated"] > 0
    d = str(tmp_path / "ck")
    with pytest.raises(RankError, match="preempt"):
        run(_launcher_args(ckpt_dir=d, preempt_at=4))
    resumed = run(_launcher_args(ckpt_dir=d))
    for a, b in zip(straight, resumed):
        assert b["losses"] == a["losses"][4:]
