"""The port's checkpoints and restart loop on the CPU: save and restore
bit for bit (fp32, bf16 as its uint16 bits, int32), retention and
``latest_step``, a save that fails midway leaving the previous step whole,
shape-mismatch and missing-leaf errors, a preempted run resumed through
``run_with_restarts`` equal bit for bit to the uninterrupted one,
``ElasticPlan``, and ``straggler_dropout_schedule`` equal to the JAX
package's."""
import json
import os

import numpy as np
import pytest
import torch

from repro.train import fault as j_fault
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.resilience.backoff import RestartBudget
from repro_torch.train import checkpoint as ck
from repro_torch.train.fault import (ElasticPlan, PreemptionSimulator,
                                     run_with_restarts,
                                     straggler_dropout_schedule)
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       make_train_step)

CFG = get_arch("qwen2-1.5b").reduced()


def _tc():
    return TrainConfig(n_microbatches=1, remat=False, dense_moe=True,
                       opt=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                           decay_steps=50))


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "layers": [{"b": torch.randn(5, generator=g).to(
                           torch.bfloat16)} for _ in range(2)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_save_restore_bitwise_with_bf16(tmp_path):
    state = _state()
    path = ck.save_checkpoint(state, str(tmp_path), 3)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["leaves"]["params/layers/1/b"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["params/w"]["dtype"] == "float32"
    assert manifest["shards"] == ["shard_00000.npz"]
    like = {"params": {"w": torch.zeros(3, 4),
                       "layers": [{"b": torch.zeros(5, dtype=torch.bfloat16)}
                                  for _ in range(2)]},
            "step": torch.zeros((), dtype=torch.int32)}
    got, step = ck.restore_checkpoint(like, str(tmp_path))
    assert step == 3 and _equal(got, state)


def test_retention_and_latest(tmp_path):
    state = {"x": torch.arange(10), "step": torch.zeros(())}
    for s in (1, 2, 3, 4, 5):
        ck.save_checkpoint(state, str(tmp_path), s, keep_last=3)
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.list_steps(str(tmp_path)) == [3, 4, 5]
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(state, str(tmp_path / "none"))


def test_failed_save_leaves_the_previous_step_whole(tmp_path, monkeypatch):
    state = _state()
    ck.save_checkpoint(state, str(tmp_path), 1)
    before = sorted(os.listdir(tmp_path / "step_00000001"))

    def boom(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(ck.np, "savez", boom)
    with pytest.raises(OSError):
        ck.save_checkpoint(state, str(tmp_path), 2)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    assert sorted(os.listdir(tmp_path / "step_00000001")) == before
    got, step = ck.restore_checkpoint(_state(), str(tmp_path))
    assert step == 1 and _equal(got, state)


def test_shape_mismatch_and_missing_leaf(tmp_path):
    ck.save_checkpoint(_state(), str(tmp_path), 1)
    bad = _state()
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="params/w"):
        ck.restore_checkpoint(bad, str(tmp_path))
    more = _state()
    more["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        ck.restore_checkpoint(more, str(tmp_path))


def _run(state0, ckpt_dir, n_steps, preempt_at=None):
    """A checkpointing loop (checkpoint after every step) under
    run_with_restarts; returns the final state and the steps it ran."""
    tc = _tc()
    pipe = SyntheticPipeline(CFG, global_batch=4, seq_len=16, device="cpu")
    step = make_train_step(CFG, tc)
    sim = PreemptionSimulator(preempt_at)
    final, ran = {}, []

    def loop(start):
        s = state0 if start == 0 else ck.restore_checkpoint(
            state0, ckpt_dir)[0]
        for i in range(start, n_steps):
            if start == 0:
                sim.check(i)
            s, m = step(s, pipe.batch_at(i))
            ck.save_checkpoint(s, ckpt_dir, i)
            final["state"] = s
            ran.append(i)
            yield i, m

    budget = RestartBudget(max_restarts=2)
    done = [i for i, _ in run_with_restarts(loop, ckpt_dir, budget=budget)]
    assert done[-1] == n_steps - 1
    return final["state"], ran, budget


def test_preempted_run_resumes_bitwise(tmp_path):
    state0 = init_train_state(0, CFG, _tc(), device="cpu")
    straight, ran, _ = _run(state0, str(tmp_path / "a"), 6)
    assert ran == list(range(6))
    resumed, ran, budget = _run(state0, str(tmp_path / "b"), 6,
                                preempt_at=4)
    assert ran == list(range(6)) and len(budget.delays) == 1
    assert _equal(straight, resumed)
    assert ck.latest_step(str(tmp_path / "b")) == 5


def test_restart_budget_spent_reraises(tmp_path):
    def loop(start):
        raise InterruptedError("always preempted")
        yield
    with pytest.raises(InterruptedError, match="always"):
        list(run_with_restarts(loop, str(tmp_path), max_restarts=2))


def test_elastic_plan():
    p = ElasticPlan(4)
    assert p.n_chunks == 6 and p.batch_divisor() == 6
    assert p.shrink().n_pods == 3 and p.grow().n_pods == 5
    with pytest.raises(ValueError):
        ElasticPlan(2).shrink()
    assert (ElasticPlan(5).n_chunks
            == j_fault.ElasticPlan(5).n_chunks == 10)


@pytest.mark.parametrize("n_steps,n_pods,rate,seed",
                         [(50, 4, 0.2, 0), (200, 8, 0.05, 3), (1, 2, 1.0, 9)])
def test_straggler_schedule_matches_jax(n_steps, n_pods, rate, seed):
    got = straggler_dropout_schedule(n_steps, n_pods, rate, seed)
    want = j_fault.straggler_dropout_schedule(n_steps, n_pods, rate, seed)
    np.testing.assert_array_equal(got, want)
