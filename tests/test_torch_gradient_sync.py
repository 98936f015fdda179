"""The port's coded gradient collectives and hierarchical collectives over a
``ProcessMesh`` (8 ranks, gloo, on the CPU), held bit for bit against the
JAX functions themselves on 8 host devices, on the same seeded,
integer-valued float32 inputs: ``coded_reduce_scatter_r2`` (torch /
kernel against xla / pallas, no failure and rack 3 failed),
``uncoded_reduce_scatter``, ``hierarchical_allreduce``,
``hierarchical_psum``, ``hierarchical_psum_scatter``,
``hierarchical_all_to_all`` and ``flat_all_to_all`` (which must also
equal each other) and
``coded_cross_pod_allreduce``; survivors of a failed rack still hold the
NumPy total.  The NumPy helpers (``chunk_index_table``,
``batch_chunk_for_rack``, ``grad_sync_cost``) equal the JAX package's.

The JAX side runs in a subprocess — this file run as a script, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the Pallas encode
in interpret mode) — so the test process keeps its one-device view; the
ranks are spawned once for the file.  Both are bounded by a time limit.
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import gradient_sync as tgs
from repro_torch.distributed import collectives as tcol
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.kernels.coded_combine import ops

pytestmark = pytest.mark.slow

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TIMEOUT_S = 600
RANKS_TIMEOUT_S = 300
P_, KR, G = 4, 2, 128                 # ('rack', 'server') = (4, 2)
FAILED = (None, 3)
IMPLS = {"torch": "xla", "kernel": "pallas"}        # port name -> JAX name
SCATTER_DIMS = (0, 1)
A2A_AXES = [(0, 0), (1, 1), (0, 1)]                 # (split, concat)


def _tag(failed):
    return "none" if failed is None else str(failed)


def _inputs():
    """Per-device inputs, stacked over the 8 devices / ranks (device
    (i, j) = row i * Kr + j), integer-valued so every sum is exact."""
    rng = np.random.default_rng(19)
    chunks = rng.integers(-1000, 1000, size=(6, G)).astype(np.float32)
    idx = tgs.chunk_index_table(P_)                          # [P, P-1]
    per_rack = np.repeat(chunks[idx][:, None], KR, axis=1)   # [P,Kr,P-1,G]
    return {
        "chunks": chunks,
        "chunk_grads": per_rack.reshape(P_ * KR, P_ - 1, G),
        "grad": rng.integers(-1000, 1000, size=(8, G)).astype(np.float32),
        "x": rng.integers(-1000, 1000, size=(8, 16, 4)).astype(np.float32),
        # ('pod', 'data') = (2, 4): one slice per global destination
        "a2a": {(s, c): np.arange(8 * 8 * 6, dtype=np.float32).reshape(
            (8, 8, 6) if s == 0 else (8, 6, 8)) for s, c in A2A_AXES},
    }


# ---------------------------------------------------------------------------
# The port, in 8 ranks (module level: the ranks import it by name)
# ---------------------------------------------------------------------------

def _rank_collectives(dev):
    ops.reset_launch_counts()
    inp = _inputs()
    rack = make_process_mesh((P_, KR), ("rack", "server"), device=dev)
    pod = make_process_mesh((2, 4), ("pod", "data"), device=dev)
    s = rack.rank
    out = {}
    for impl, failed in itertools.product(IMPLS, FAILED):
        cg = torch.as_tensor(inp["chunk_grads"][s])
        out[f"crs_{IMPLS[impl]}_{_tag(failed)}"] = \
            tgs.coded_reduce_scatter_r2(cg, rack, "rack", P_, failed=failed,
                                        combine_impl=impl)
    for failed in FAILED:
        out[f"cross_pod_{_tag(failed)}"] = tcol.coded_cross_pod_allreduce(
            torch.as_tensor(inp["chunk_grads"][s]), rack, "rack", P_,
            failed=failed)
    out["uncoded_rs"] = tgs.uncoded_reduce_scatter(
        torch.as_tensor(inp["grad"][s]), rack, "rack", P_)
    x = torch.as_tensor(inp["x"][s])
    for dim in SCATTER_DIMS:
        out[f"allreduce_{dim}"] = tgs.hierarchical_allreduce(
            x, rack, "server", "rack", dim)
        out[f"psum_{dim}"] = tcol.hierarchical_psum(x, rack, "server",
                                                    "rack", dim)
        out[f"psum_scatter_{dim}"] = tcol.hierarchical_psum_scatter(
            x, rack, "server", "rack", dim)
    for (split, concat), a in inp["a2a"].items():
        kw = dict(split_axis=split, concat_axis=concat)
        xa = torch.as_tensor(a[s])
        out[f"hier_a2a_{split}_{concat}"] = tcol.hierarchical_all_to_all(
            xa, pod, "data", "pod", **kw)
        out[f"flat_a2a_{split}_{concat}"] = tcol.flat_all_to_all(
            xa, pod, "data", "pod", **kw)
    return {k: v.numpy() for k, v in out.items()}, dict(ops.LAUNCHES)


# ---------------------------------------------------------------------------
# The JAX functions on 8 host devices (this file run as a script)
# ---------------------------------------------------------------------------

def _jax_collectives(path: str) -> None:
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.gradient_sync import (coded_reduce_scatter_r2,
                                          hierarchical_allreduce,
                                          uncoded_reduce_scatter)
    from repro.distributed.collectives import (coded_cross_pod_allreduce,
                                               flat_all_to_all,
                                               hierarchical_all_to_all,
                                               hierarchical_psum,
                                               hierarchical_psum_scatter)
    from repro.distributed.meshes import make_mesh, shard_map

    inp = _inputs()
    meshes = {"rack": make_mesh((P_, KR), ("rack", "server")),
              "pod": make_mesh((2, 4), ("pod", "data"))}

    def run(fn, x, mesh="rack", check=True):
        names = meshes[mesh].axis_names
        f = shard_map(lambda a: fn(a[0])[None], mesh=meshes[mesh],
                      in_specs=(P(names),), out_specs=P(names), check=check)
        return np.asarray(f(jnp.asarray(x)))

    out = {}
    for impl, failed in itertools.product(IMPLS.values(), FAILED):
        out[f"crs_{impl}_{_tag(failed)}"] = run(
            lambda a: coded_reduce_scatter_r2(a, "rack", P_, failed=failed,
                                              combine_impl=impl),
            inp["chunk_grads"], check=impl != "pallas")
    for failed in FAILED:
        out[f"cross_pod_{_tag(failed)}"] = run(
            lambda a: coded_cross_pod_allreduce(a, "rack", P_, failed=failed),
            inp["chunk_grads"])
    out["uncoded_rs"] = run(
        lambda a: uncoded_reduce_scatter(a, "rack", P_), inp["grad"])
    for dim in SCATTER_DIMS:
        out[f"allreduce_{dim}"] = run(
            lambda a: hierarchical_allreduce(a, "server", "rack", dim),
            inp["x"])
        out[f"psum_{dim}"] = run(
            lambda a: hierarchical_psum(a, "server", "rack", dim), inp["x"])
        out[f"psum_scatter_{dim}"] = run(
            lambda a: hierarchical_psum_scatter(a, "server", "rack", dim),
            inp["x"])
    for (split, concat), a in inp["a2a"].items():
        kw = dict(split_axis=split, concat_axis=concat)
        out[f"hier_a2a_{split}_{concat}"] = run(
            lambda v: hierarchical_all_to_all(v, "data", "pod", **kw), a,
            "pod")
        out[f"flat_a2a_{split}_{concat}"] = run(
            lambda v: flat_all_to_all(v, "data", "pod", **kw), a, "pod")
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "collectives.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               + os.environ.get("XLA_FLAGS", ""))
    proc = subprocess.run([sys.executable, __file__, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_out():
    per_rank = run_ranks(_rank_collectives, P_ * KR, backend="gloo",
                         device="cpu", timeout_s=RANKS_TIMEOUT_S)
    outs = {k: np.stack([r[0][k] for r in per_rank]) for k in per_rank[0][0]}
    return outs, [r[1] for r in per_rank]


def _total_shards():
    return _inputs()["chunks"].sum(axis=0).reshape(P_, G // P_)


# ---------------------------------------------------------------------------
# Against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("failed", FAILED)
def test_coded_reduce_scatter_r2_bit_exact_vs_jax(jax_out, port_out, impl,
                                                  failed):
    key = f"crs_{IMPLS[impl]}_{_tag(failed)}"
    got = port_out[0][key]
    np.testing.assert_array_equal(got, jax_out[key])
    # every survivor holds its rack's shard of the full-batch sum, exactly
    total = _total_shards()
    for s in range(P_ * KR):
        if s // KR != failed:
            np.testing.assert_array_equal(got[s], total[s // KR])


@pytest.mark.parametrize("failed", FAILED)
def test_coded_cross_pod_allreduce_bit_exact_vs_jax(jax_out, port_out,
                                                    failed):
    key = f"cross_pod_{_tag(failed)}"
    np.testing.assert_array_equal(port_out[0][key], jax_out[key])
    if failed is None:
        for s in range(P_ * KR):
            np.testing.assert_array_equal(port_out[0][key][s],
                                          _total_shards().reshape(-1))


@pytest.mark.parametrize("name", ["allreduce", "psum", "psum_scatter"])
@pytest.mark.parametrize("dim", SCATTER_DIMS)
def test_hierarchical_reductions_bit_exact_vs_jax(jax_out, port_out, name,
                                                  dim):
    key = f"{name}_{dim}"
    np.testing.assert_array_equal(port_out[0][key], jax_out[key])
    if name != "psum_scatter":
        # an all-reduce over both axes: every rank holds the total
        total = _inputs()["x"].sum(axis=0)
        for got in port_out[0][key]:
            np.testing.assert_array_equal(got, total)


def test_uncoded_reduce_scatter_bit_exact_vs_jax(jax_out, port_out):
    np.testing.assert_array_equal(port_out[0]["uncoded_rs"],
                                  jax_out["uncoded_rs"])


@pytest.mark.parametrize("split,concat", A2A_AXES)
def test_hierarchical_all_to_all_equals_flat_and_jax(jax_out, port_out,
                                                     split, concat):
    hier = port_out[0][f"hier_a2a_{split}_{concat}"]
    flat = port_out[0][f"flat_a2a_{split}_{concat}"]
    np.testing.assert_array_equal(hier, flat)
    np.testing.assert_array_equal(hier, jax_out[f"hier_a2a_{split}_{concat}"])
    np.testing.assert_array_equal(flat, jax_out[f"flat_a2a_{split}_{concat}"])


def test_the_ranks_launch_nothing_on_the_cpu(port_out):
    for launches in port_out[1]:
        assert launches == dict.fromkeys(ops.LAUNCHES, 0)


# ---------------------------------------------------------------------------
# The NumPy helpers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 3, 4, 5, 6])
def test_chunk_tables_equal_jax(P):
    from repro.core import gradient_sync as jgs
    np.testing.assert_array_equal(tgs.chunk_index_table(P),
                                  jgs.chunk_index_table(P))
    np.testing.assert_array_equal(tgs._partners_matrix(P),
                                  jgs._partners_matrix(P))
    batch = np.arange(37 * 3).reshape(37, 3)
    for rack in range(P):
        want = jgs.batch_chunk_for_rack(batch, P, rack)
        for got in (tgs.batch_chunk_for_rack(batch, P, rack),
                    tgs.batch_chunk_for_rack(torch.as_tensor(batch), P,
                                             rack)):
            assert len(got) == len(want) == P - 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("mode", ["uncoded", "coded_r", "full_replication"])
def test_grad_sync_cost_equals_jax(mode):
    from repro.core import gradient_sync as jgs
    for P, r in ((4, 2), (6, 3), (8, 2)):
        assert tgs.grad_sync_cost(1e9, P, r, mode) == \
            jgs.grad_sync_cost(1e9, P, r, mode)
    with pytest.raises(ValueError):
        tgs.grad_sync_cost(1e9, 4, 2, "bogus")


if __name__ == "__main__":
    _jax_collectives(sys.argv[1])
