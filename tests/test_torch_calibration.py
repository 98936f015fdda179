"""The port's calibration (``repro_torch.sim.calibration``) and drift
monitoring (``repro_torch.obs.drift``) against the JAX package's on the
same inputs: the per-phase fit and its residuals, the JCT-level
conformance fit and report, the cost-model artifact (round trip, schema
refusal, the committed default), live measurement rows, the drift
monitor's state and gauges, and ``chip_smoke.py``'s copy of
``benchmarks/calibration_bench.py``'s drift and determinism sections.

Tolerances: fitted coefficients and residuals within 1e-12 relative (one
``lstsq`` each side, on the same inputs: equal bit for bit here, the bound
leaves room for a LAPACK that orders a sum differently); everything else
exact, the metrics snapshots byte for byte."""
import ast
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro import sim as jsim
from repro.core.params import SchemeParams as JParams
from repro.obs import drift as jdrift
from repro.obs import metrics as jmetrics
from repro.sim import calibration as jcal
from repro_torch import sim as tsim
from repro_torch.core.params import SchemeParams
from repro_torch.obs import drift as tdrift
from repro_torch.obs import metrics as tmetrics
from repro_torch.sim import calibration as tcal

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-12

T = (tsim, tcal, tdrift, tmetrics, SchemeParams)
J = (jsim, jcal, jdrift, jmetrics, JParams)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Empty registries, declarations too: a metric's help string is the
    one it was first declared with, and the snapshot digests hash it."""
    for mod in (tmetrics, jmetrics):
        mod.registry().clear()
    yield


def _close(a, b):
    """Nested structures equal, floats within RTOL relative."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return abs(a - b) <= RTOL * max(abs(a), abs(b))
    return a == b


def _rows(Params, noisy):
    """Calibration rows in the host-fit format, affine plus seeded noise."""
    rng = np.random.default_rng(3)
    rows = []
    for N, d in ((48, 256), (48, 1024), (96, 512), (96, 2048), (192, 1024)):
        p = Params(K=8, P=4, Q=16, N=N, r=2)
        work = {"map": float(N) * 16 * d, "pack": 8.0 * 12 * 16 * d,
                "reduce": float(N) * 16 * d, "plan_compile": float(N)}
        secs = {"map": 1e-3 + 4e-8 * work["map"],
                "pack": 2e-4 + 1e-8 * work["pack"],
                "reduce": 1e-4 + 5e-9 * work["reduce"],
                "plan_compile": 8e-4 + 3e-6 * N}
        if noisy:
            secs = {k: v * (1 + 0.2 * rng.standard_normal())
                    for k, v in secs.items()}
        rows.append({"work": work, "seconds": secs,
                     "meta": {"N": p.N, "d": d}})
    return rows


# ---------------------------------------------------------------------------
# Per-phase fit, residuals and the artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noisy", [False, True])
def test_calibrate_with_residuals_equal_jax(noisy):
    (tm, tres), (jm, jres) = [m[1].calibrate_with_residuals(_rows(m[4],
                                                                 noisy))
                              for m in (T, J)]
    assert _close(dataclasses.asdict(tm), dataclasses.asdict(jm))
    assert _close(tres, jres)
    assert set(tres) == {"map", "pack", "reduce", "plan_compile"}
    wrong = [m[0].CostModel(map=m[0].PhaseCoeffs(0.0, 1e-6)) for m in (T, J)]
    assert _close(tcal.fit_residuals(wrong[0], _rows(SchemeParams, noisy)),
                  jcal.fit_residuals(wrong[1], _rows(JParams, noisy)))


def test_cost_model_artifact_round_trip_equal_jax(tmp_path):
    docs = []
    for name, m in (("t", T), ("j", J)):
        model, res = m[1].calibrate_with_residuals(_rows(m[4], True))
        path = tmp_path / f"{name}.json"
        doc = m[1].save_cost_model(model, str(path), residuals=res,
                                   provenance={"bench": "unit-test"})
        loaded, doc2 = m[1].load_cost_model(str(path))
        assert loaded == model and doc2 == json.loads(path.read_text())
        docs.append((doc, path.read_text()))
    assert docs[0][1] == docs[1][1]                    # byte for byte
    assert tcal.COST_MODEL_SCHEMA_VERSION == jcal.COST_MODEL_SCHEMA_VERSION
    assert tcal.cost_model_to_dict(tsim.CostModel()) == \
        jcal.cost_model_to_dict(jsim.CostModel())


@pytest.mark.parametrize("version", [999, None, 0])
def test_cost_model_loader_refuses_unknown_schema(tmp_path, version):
    path = tmp_path / "cm.json"
    path.write_text(json.dumps({"schema_version": version,
                                "cost_model": {}}))
    for m in (tcal, jcal):
        with pytest.raises(ValueError, match=f"schema_version={version!r}"):
            m.load_cost_model(str(path))


def test_load_default_cost_model_equal_jax():
    (tm, tdoc), (jm, jdoc) = (tcal.load_default_cost_model(),
                              jcal.load_default_cost_model())
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tdoc == jdoc
    assert tdoc["provenance"]["backend"] == "cpu"
    assert tcal.DEFAULT_COST_MODEL_PATH == jcal.DEFAULT_COST_MODEL_PATH


# ---------------------------------------------------------------------------
# Live rows and the conformance fit
# ---------------------------------------------------------------------------

def _job_stats(m, slowdown):
    topo = m[0].RackTopology(P=4, cross_bw=2e5, intra_bw=2e6)
    cm = m[0].CostModel(map=m[0].PhaseCoeffs(1e-3, 5e-7),
                        pack=m[0].PhaseCoeffs(0.0, 2e-7),
                        reduce=m[0].PhaseCoeffs(1e-3, 5e-7),
                        plan_compile=m[0].PhaseCoeffs(1e-3, 1e-6))
    sim = m[0].ClusterSim(topo, 8, cm,
                          m[0].DeterministicSlowdown((slowdown,) * 8), 0)
    sim.submit(m[0].JobSpec("j", 96, 16, 64), "hybrid", 2, time=0.0,
               compile_s=2e-3)
    (stats,) = sim.run()
    return stats


@pytest.mark.parametrize("slowdown", [1.0, 3.0])
def test_measurement_row_from_stats_equal_jax(slowdown):
    rows = [m[1].measurement_row_from_stats(
        _job_stats(m, slowdown), m[4](K=8, P=4, Q=16, N=96, r=2), "hybrid",
        64) for m in (T, J)]
    assert rows[0] == rows[1]
    assert "plan_compile" in rows[0]["seconds"]
    assert dataclasses.asdict(tsim.calibrate([rows[0]] * 2)) == \
        dataclasses.asdict(jsim.calibrate([rows[1]] * 2))


def _cells(m, seed):
    rng = np.random.default_rng(seed)
    cells = []
    for n, q, d in ((96, 16, 2048), (96, 16, 512), (192, 16, 1024)):
        for r in (1, 2, 3):
            p = m[4](K=8, P=4, Q=q, N=n, r=r)
            cells.append({"p": p, "scheme": "hybrid", "d": d,
                          "measured_s": float(rng.uniform(5e-4, 3e-2))})
    return cells


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_conformance_and_report_equal_jax(seed):
    (tc, jc) = (_cells(T, seed), _cells(J, seed))
    tmod, jmod = tcal.fit_conformance(tc), jcal.fit_conformance(jc)
    assert _close(tmod.theta, jmod.theta)
    assert tmod.to_dict()["features"] == list(jcal.CONFORMANCE_FEATURES)
    for c, k in zip(tc, jc):
        assert np.array_equal(
            tcal.conformance_features(c["p"], "hybrid", c["d"]),
            jcal.conformance_features(k["p"], "hybrid", k["d"]))
    assert _close(tcal.conformance_report(tmod, tc, via_sim=False),
                  jcal.conformance_report(jmod, jc, via_sim=False))
    if all(t > 0 for t in tmod.theta[3:]):
        # both network tiers fitted: the simulators agree with each other
        assert _close(tcal.conformance_report(tmod, tc),
                      jcal.conformance_report(jmod, jc))
    for c in tc:                         # the bench's honesty check
        lin = tmod.predict(c["p"], "hybrid", c["d"])
        simj = tmod.sim_stats(c["p"], "hybrid", c["d"]).jct
        assert abs(simj - lin) <= 1e-9 * max(lin, 1e-12)


@pytest.mark.parametrize("theta", [
    (7e-4, 1e-11, 0.0, 0.0, 0.0), (7e-4, 1e-11, 1e-12, 0.0, 3e-12),
    (7e-4, 0.0, 0.0, 1e-20, 0.0)], ids=["no_network", "no_cross", "tiny"])
def test_sim_reproduces_the_predictor_with_unfitted_network_tiers(theta):
    """Sub-millisecond walls with a network coefficient clipped to zero
    (or tiny): the simulator still reproduces the linear predictor within
    the bench's 1e-9 relative bound (the JAX model's 1e18 capacity leaks
    units / 1e18 seconds here)."""
    model = tcal.ConformanceModel(theta)
    for n, r, d in ((96, 1, 2048), (96, 2, 512), (192, 3, 1024)):
        p = SchemeParams(K=8, P=4, Q=16, N=n, r=r)
        lin = model.predict(p, "hybrid", d)
        assert abs(model.sim_stats(p, "hybrid", d).jct - lin) <= 1e-9 * lin
    jm = jcal.ConformanceModel(theta)
    assert jm.predict(JParams(K=8, P=4, Q=16, N=96, r=1), "hybrid", 2048) \
        == model.predict(SchemeParams(K=8, P=4, Q=16, N=96, r=1),
                         "hybrid", 2048)


def test_fit_conformance_rejects_empty_cells():
    for m in (tcal, jcal):
        with pytest.raises(ValueError, match="at least one cell"):
            m.fit_conformance([])


# ---------------------------------------------------------------------------
# Drift monitoring
# ---------------------------------------------------------------------------

PAIRS = [(2.0, 1.0), (1.1, 1.0), (3.0, 1.0), (0.5, 1.0), (1.0, 1.0),
         (4.0, 1.2), (1.3, 1.0), (9.0, 2.0), (1.0, 0.0)]


def test_drift_monitor_state_and_gauges_equal_jax():
    out = []
    for m in (T, J):
        reg = m[3].MetricsRegistry()
        mon = m[2].DriftMonitor(m[2].DriftConfig(
            ewma_alpha=0.4, threshold=0.3, min_observations=2), reg=reg)
        fired = []
        for i, (pred, act) in enumerate(PAIRS):
            fired.append(mon.observe(pred, act, scheme=f"s{i % 2}"))
            if i == 4:
                mon.refitted()
        rel = m[2].record_prediction(1.5, 1.0, layer="engine", reg=reg,
                                     scheme="hybrid")
        m[2].record_blame({"map": 0.5, "map_straggle": -0.1}, reg=reg,
                          scheme="hybrid")
        m[2].record_component_errors({"map": 1.0, "fetch": 0.2},
                                     {"map": 0.8, "fetch": 0.0}, reg=reg,
                                     scheme="hybrid")
        out.append((fired, mon.state(), rel, reg.snapshot_json(),
                    reg.to_prometheus_text()))
    assert out[0] == out[1]
    assert any(out[0][0]) and out[0][1]["refits"] == 1


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_chip_smoke_drift_section_equal_jax(smoke):
    """``chip_smoke.py``'s copy of the bench's drift section over the port
    and over the JAX package; at full size, the committed
    ``BENCH_calibration.json``'s numbers."""
    cs = _chip_smoke()
    t = cs.drift_section(np, tsim, tmetrics, tdrift, smoke=smoke)
    j = cs.drift_section(np, jsim, jmetrics, jdrift, smoke=smoke)
    assert t == j
    if not smoke:
        want = json.loads((ROOT / "BENCH_calibration.json").read_text())
        assert cs.bench_diff(t, want["drift"]) == []
        assert t["refits"] == 6 and t["drift_fired"]


def test_chip_smoke_determinism_equal_jax_at_smoke():
    cs = _chip_smoke()
    t = cs.determinism_section(tsim, tmetrics, tdrift, smoke=True)
    j = cs.determinism_section(jsim, jmetrics, jdrift, smoke=True)
    assert t == j and t["identical"]


def test_chip_smoke_calibration_constants_are_the_bench_s():
    tree = ast.parse((ROOT / "benchmarks" /
                      "calibration_bench.py").read_text())
    bench = {t.id: ast.literal_eval(node.value)
             for node in tree.body if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name)
             and isinstance(node.value, (ast.List, ast.Tuple,
                                         ast.Constant))}
    cs = _chip_smoke()
    for name, value in (("GRID_POINTS", cs.CAL_GRID_POINTS),
                        ("CONFORMANCE_SIZES", cs.CONFORMANCE_SIZES),
                        ("CONFORMANCE_RS", cs.CONFORMANCE_RS),
                        ("TOL_REL", cs.CONFORMANCE_TOL),
                        ("SHIFT_FACTOR", cs.CAL_SHIFT_FACTOR),
                        ("SUBFILE_TOKENS", cs.CONFORMANCE_TOKENS)):
        assert bench[name] == value, name
    assert cs.cal_stale_cost(jsim) == jsim.CostModel(
        map=jsim.PhaseCoeffs(1e-3, 5e-7), pack=jsim.PhaseCoeffs(5e-4, 2e-7),
        reduce=jsim.PhaseCoeffs(1e-3, 5e-7))


def test_determinism_digest_is_the_jax_bench_s():
    """``chip_smoke.CAL_DETERMINISM_SHA256`` is what the JAX package's
    calibration bench gives today (conformance's engine-layer records, then
    the drift and determinism sections, in a process of its own), and what
    the port gives in chip_smoke.py's order."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmarks import calibration_bench as cb\n"
        "from repro.obs import metrics\n"
        "from repro.obs.drift import record_prediction\n"
        "metrics.reset()\n"
        "for i in range(9):\n"
        "    record_prediction(0.01, 0.012, layer='engine', "
        "scheme='hybrid')\n"
        "cb.drift(False, 0)\n"
        "print(cb.determinism(False, 0)['sha256'])\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    cs = _chip_smoke()
    assert out.stdout.split()[-1] == cs.CAL_DETERMINISM_SHA256
    cs.drift_section(np, tsim, tmetrics, tdrift)
    assert cs.determinism_section(tsim, tmetrics, tdrift)["sha256"] == \
        cs.CAL_DETERMINISM_SHA256
