"""The gloo worlds and references of tests/test_torch_tensor_parallel_rwkv.py
and tests/test_torch_tensor_parallel_encdec.py: one family under a model
axis, held against the unsharded port and the JAX package.

A family's config is ``reduced()`` (``dataclasses.replace`` the same on
both sides where a test file widens it); the JAX package's weights are
carried over shard by shard (``params_from_jax(..., policy=)``).  Three
worlds, spawned once a module and run side by side while the test process
computes the JAX references:

* (data 1, model 2) under ``default_rules(fsdp=False)`` and under
  ``with_sequence_tp`` of it, and (1, 4) under the plain rules: forward
  logits, ``prefill`` and greedy ``decode_step`` logits and tokens,
  ``ServeEngine.generate``'s tokens, the decode cache's shapes a rank, the
  loss and every gradient leaf (gathered), a rank's weight bytes against
  ``sharding.tree_local_bytes`` of the specs, and the shards' round trip;
* (data 2, model 2) under ``default_rules`` (ZeRO-3 over 'data' composed
  with TP) on the config widened so that the FSDP overlay splits leaves
  (d_ff 1,024): one AdamW step on the whole batch (each data rank its
  rows), and two Adafactor steps on the shards of the JAX package's
  gradient.

The rank function imports no JAX."""
import contextlib
import dataclasses
from unittest import mock

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.models import linrec, lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as serve
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

B, S, N_DEC = 4, 16, 4
# fp32; the sharded products and the rank-order sums add in other orders
# than one matmul: logits against the largest |logit|, the loss relative,
# each gradient leaf against its own largest entry, each updated parameter
# against the leaf's largest
LOGIT_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 2e-5, 1e-5, 1e-5, 1e-6
# the most the unsharded port's gradient may part from the JAX package's on
# one leaf, as grads_close measures it: twice the largest reading (2.5e-5)
PORT_GRAD_CEIL = 5e-5
# a gradient leaf below FLOOR of its tree's largest entry is zero up to
# rounding (the key biases: a softmax does not see a shift of its keys)
# and is held against FLOOR of the tree's largest, as
# tests/test_torch_zero3.py holds it
FLOOR = 1e-3
MESHES = (((1, 2), False), ((1, 2), True), ((1, 4), False))
Z3_SHAPE = (2, 2)
SHAPES = ((1, 2), (1, 4), Z3_SHAPE)
TC = tr.TrainConfig(n_microbatches=1, remat=True,
                    opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                            decay_steps=50))
AF = opt.OptimizerConfig(kind="adafactor", lr=1e-3, warmup_steps=2,
                         decay_steps=50)


def z3_config(cfg):
    """``cfg`` widened so that the FSDP overlay (2^16 elements) splits the
    FFN leaves."""
    return dataclasses.replace(cfg, d_ff=1024)


def np_batch(cfg, seed: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "loss_mask": np.ones((B, S), np.float32)}
    if cfg.family == "encdec":
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _front(batch):
    """The frontend inputs of a batch (an enc-dec model's frames, a VLM's
    patch prefix), and the prefix's positions."""
    front = {k: batch[k] for k in ("enc_frames", "prefix_embeds")
             if k in batch}
    n_front = (front["prefix_embeds"].shape[1] if "prefix_embeds" in front
               else 0)
    return front, n_front


def torch_batch(nb):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in nb.items()}


def leaves(tree):
    return [x.detach().clone() for x in opt.tree_leaves(tree)]


def _cache_shapes(cache):
    return sh.map_with_path(lambda path, x, _: tuple(x.shape), cache)


def run_model(params, cfg, nb, dev):
    """forward logits, prefill + N_DEC greedy decode logits and tokens,
    the cache's shapes, ``generate``'s tokens, the loss and its gradients
    (as a tree), under whatever policy is active."""
    batch = torch_batch(nb)
    front, n_front = _front(batch)
    logits = lm.forward(params, cfg, batch["tokens"], **front)[0]
    cache = lm.init_cache(cfg, B, n_front + S + N_DEC, torch.float32,
                          device=dev)
    lg, cache = lm.prefill(params, cfg, batch["tokens"], cache, **front)
    steps, tokens = [lg], [lg.argmax(-1)]
    for i in range(N_DEC):
        lg, cache = lm.decode_step(params, cfg, tokens[-1], cache,
                                   n_front + S + i)
        steps.append(lg)
        tokens.append(lg.argmax(-1))
    gen = serve.ServeEngine(cfg, params, B, n_front + S + N_DEC,
                            torch.float32, device=dev).generate(
        nb["tokens"], N_DEC + 1, enc_frames=nb.get("enc_frames"),
        prefix_embeds=nb.get("prefix_embeds"))
    loss, grads = tr.value_and_grad(params, cfg, dataclasses.replace(
        TC, remat=False), batch)
    return {"logits": logits.detach(), "steps": torch.stack(steps),
            "tokens": torch.stack(tokens), "generate": gen,
            "cache": _cache_shapes(cache), "loss": float(loss),
            "grads": opt.tree_unflatten(params, grads)}


def rank(dev, shape, data, config):
    """Every case of one mesh shape in this rank.  ``data``: (the JAX
    weights as numpy, the batch, the widened config's weights, batch and
    JAX gradient); ``config(z3)``: the port's config."""
    mesh = make_process_mesh(shape, ("data", "model"), device=dev)
    np_params, nb, z_params, z_batch, z_grads = data
    out = {}
    cfg = config(False)
    for at, seq in MESHES:
        if at != shape:
            continue
        rules = sh.default_rules(False, fsdp=False)
        pol = sh.ShardingPolicy(mesh, sh.with_sequence_tp(rules)
                                if seq else rules)
        full = params_from_jax(np_params, cfg, "cpu")
        local = params_from_jax(np_params, cfg, "cpu", policy=pol)
        with sh.use_policy(pol):
            got = run_model(local, cfg, nb, dev)
            got["grads"] = leaves(tpl.gather_params(got["grads"], cfg, pol))
        meta = lm.init_params(0, cfg, device="meta")
        got["bytes"] = (tpl.local_bytes(local), sh.tree_local_bytes(
            meta, sh.param_pspecs(meta, pol), mesh))
        back = tpl.gather_params(tpl.shard_params(full, cfg, pol), cfg, pol)
        got["round_trip"] = all(torch.equal(a, b) for a, b in zip(
            opt.tree_leaves(back), opt.tree_leaves(full)))
        out[seq] = got
    if shape == Z3_SHAPE:
        cfg = config(True)
        pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
        local = params_from_jax(z_params, cfg, "cpu", policy=pol)
        batch = torch_batch(z_batch)
        state = {"params": local, "opt": opt.init_opt_state(local, TC.opt),
                 "step": torch.zeros((), dtype=torch.int32)}
        with sh.use_policy(pol):
            new, m = tr.make_train_step(cfg, TC)(state, batch)
            grads, _ = tr._policy_grads(local, cfg, TC, batch, pol)
            held = tr.state_local_bytes(state, cfg, pol)
            out["step"] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": leaves(tpl.gather_params(grads, cfg, pol)),
                "params": leaves(tpl.gather_params(new["params"], cfg,
                                                   pol)),
                "bytes": held,
                "zkinds": sorted(set(tpl.layout(cfg, pol).zkinds))}
            p = params_from_jax(z_params, cfg, "cpu", policy=pol)
            g = params_from_jax(z_grads, cfg, "cpu", policy=pol)
            st = opt.init_opt_state(p, AF)
            lay = tpl.for_update(cfg)
            for _ in range(2):
                p, st, _ = opt.adafactor_update(g, st, p, AF, lay)
            out["adafactor"] = leaves(tpl.gather_params(p, cfg, pol))
    return out


def port_side(cfg, z_cfg, data):
    """The unsharded port on the same weights: the model's outputs, and on
    the widened config one full-batch AdamW step's gradient, loss and
    norm, the parameters before it, and two Adafactor steps on the JAX
    gradient."""
    np_params, nb, z_params, z_batch, z_grads = data
    params = params_from_jax(np_params, cfg, "cpu")
    out = run_model(params, cfg, nb, "cpu")
    out["grads"] = leaves(out["grads"])
    params = params_from_jax(z_params, z_cfg, "cpu")
    state = {"params": opt.tree_map(lambda x: x.clone(), params), "opt": opt.init_opt_state(params, TC.opt),
             "step": torch.zeros((), dtype=torch.int32)}
    grads, _ = tr.accumulate_grads(params, z_cfg, TC, torch_batch(z_batch))
    new, m = tr.make_train_step(z_cfg, TC)(state, torch_batch(z_batch))
    out["step"] = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "grads": leaves(grads), "before": params}
    p = params_from_jax(z_params, z_cfg, "cpu")
    g = params_from_jax(z_grads, z_cfg, "cpu")
    st = opt.init_opt_state(p, AF)
    for _ in range(2):
        p, st, _ = opt.adafactor_update(g, st, p, AF)
    out["adafactor"] = leaves(p)
    return out


def jax_draw(jcfg, z_jcfg, cfg, z_cfg, seed: int):
    """The JAX package's weights of both configs (as numpy), the batches,
    and the widened config's JAX gradient: the ranks' ``data``."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as j_lm
    jp = j_lm.init_params(jax.random.PRNGKey(seed), jcfg)
    zp = j_lm.init_params(jax.random.PRNGKey(seed + 1), z_jcfg)
    z_batch = np_batch(z_cfg, seed + 1)
    (_, _), zg = jax.value_and_grad(
        lambda p: j_lm.lm_loss(p, z_jcfg, {k: jnp.asarray(v)
                                            for k, v in z_batch.items()}),
        has_aux=True)(zp)
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return jp, (as_np(jp), np_batch(cfg, seed), as_np(zp), z_batch,
                as_np(zg))


def jax_model_refs(jp, jcfg, cfg, nb):
    """The JAX package's forward logits, prefill and greedy decode logits
    and tokens, the loss and its gradients (as the port's leaves)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as j_lm
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    front, n_front = _front(jb)
    logits = j_lm.forward(jp, jcfg, jb["tokens"], **front)[0]
    cache = j_lm.init_cache(jcfg, B, n_front + S + N_DEC, jnp.float32)
    lg, cache = j_lm.prefill(jp, jcfg, jb["tokens"], cache, **front)
    steps = [lg]
    for j in range(N_DEC):
        nxt = jnp.argmax(steps[-1], -1).astype(jnp.int32)
        lg, cache = j_lm.decode_step(jp, jcfg, nxt, cache,
                                     jnp.asarray(n_front + S + j,
                                                 jnp.int32))
        steps.append(lg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: j_lm.lm_loss(p, jcfg, jb), has_aux=True)(jp)
    return {"logits": np.asarray(logits),
            "steps": np.stack([np.asarray(s) for s in steps]),
            "tokens": np.stack([np.argmax(np.asarray(s), -1)
                                for s in steps]),
            "loss": float(loss),
            "grads": [x.numpy() for x in opt.tree_leaves(params_from_jax(
                jax.tree.map(np.asarray, grads), cfg, "cpu"))]}


def jax_refs(jp, jcfg, z_jcfg, cfg, z_cfg, data):
    """The JAX package's outputs: forward logits, prefill and greedy decode
    logits and tokens, the loss and gradients; on the widened config the
    loss, the gradient and two Adafactor steps on it."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as j_lm
    from repro.train import optimizer as j_opt
    np_params, nb, z_params, z_batch, z_grads = data
    ref = jax_model_refs(jp, jcfg, cfg, nb)
    to_port = lambda t, c: [x.numpy() for x in opt.tree_leaves(
        params_from_jax(jax.tree.map(np.asarray, t), c, "cpu"))]
    zp = jax.tree.map(jnp.asarray, z_params)
    zg = jax.tree.map(jnp.asarray, z_grads)
    zb = {k: jnp.asarray(v) for k, v in z_batch.items()}
    (z_loss, _), _ = jax.value_and_grad(
        lambda p: j_lm.lm_loss(p, z_jcfg, zb), has_aux=True)(zp)
    acfg = j_opt.OptimizerConfig(kind="adafactor", lr=1e-3, warmup_steps=2,
                                 decay_steps=50)
    p, st = zp, j_opt.init_opt_state(zp, acfg)
    for _ in range(2):
        p, st, _ = j_opt.adafactor_update(zg, st, p, acfg)
    ref["step"] = {"loss": float(z_loss), "grads": to_port(zg, z_cfg),
                   "adafactor": to_port(p, z_cfg)}
    return ref


class _Float64Torch:
    """``torch`` as :mod:`repro_torch.models.linrec` sees it inside
    :func:`float64_throughout`: its ``float32`` is ``float64``."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


@contextlib.contextmanager
def float64_throughout():
    """Every cast the model makes to fp32 kept at float64 for float64
    tensors: ``Tensor.float()`` (norms, attention, the DDLerp and decay,
    the logits) and the linear recurrence's fp32 state and chunks."""
    to_f32 = torch.Tensor.float
    keep = lambda t, *a, **k: (t if t.dtype == torch.float64
                               else to_f32(t, *a, **k))
    with mock.patch.object(torch.Tensor, "float", keep), \
            mock.patch.object(linrec, "torch", _Float64Torch()):
        yield


def grads64(params, cfg, nb):
    """The gradient of ``params`` on ``nb``'s batch, both widened to
    float64 and run :func:`float64_throughout` (no remat), as a tree like
    ``params``, under whatever policy is active."""
    wide = lambda t: t.double() if t.is_floating_point() else t
    params = opt.tree_map(wide, params)
    with float64_throughout():
        _, grads = tr.value_and_grad(
            params, cfg, dataclasses.replace(TC, remat=False),
            {k: wide(v) for k, v in torch_batch(nb).items()})
    return opt.tree_unflatten(params, grads)


def leaf_errs(got, want, floor: float = 0.0):
    """|got - want|'s largest entry, leaf by leaf, each against its own
    largest |want| (or ``floor`` times the tree's largest, where that is
    more)."""
    want = [np.asarray(b, np.float64) for b in want]
    top = max(float(np.abs(b).max()) for b in want)
    return [float(np.abs(np.asarray(a, np.float64) - b).max()
                  / max(np.abs(b).max(), floor * top, 1e-30))
            for a, b in zip(got, want)]


def worst(got, want, floor: float = 0.0) -> float:
    return max(leaf_errs(got, want, floor))


def grads_close(got, port, ref) -> bool:
    """A gathered gradient within GRAD_TOL of the unsharded port's, leaf by
    leaf (what the sharding adds), and as close to the JAX package's as
    the unsharded port's is, within GRAD_TOL: the two packages' fp32
    orders already part by more than GRAD_TOL on some RWKV6 leaves (1.26e-5
    of ``cmix/wk``'s largest on the reduced config; the widened one's
    ``embed`` 2.5e-5 of the tree's largest), where the chunked recurrence
    rounds each chunk's decays.  That margin is bounded: the unsharded
    port stays within PORT_GRAD_CEIL of the JAX package on every leaf."""
    base = leaf_errs(port, ref, FLOOR)
    return (max(base) <= PORT_GRAD_CEIL
            and worst(got, port, FLOOR) <= GRAD_TOL
            and all(e <= b + GRAD_TOL
                    for e, b in zip(leaf_errs(got, ref, FLOOR), base)))


def mesh_id(mesh) -> str:
    shape, seq = mesh
    return f"{shape[0]}x{shape[1]}" + ("-seq_tp" if seq else "")
