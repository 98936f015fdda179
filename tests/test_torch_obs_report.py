"""The port's completed metrics registry (``repro_torch.obs.metrics``) and
observatory report (``repro_torch.obs.report``) against the JAX package's
on the same inputs: the Prometheus text and ``snapshot_json`` of a
populated registry, ``reset`` / ``clear`` / ``names``, the cache
collector, and the report built from the seeded scheduler demo rendered
to markdown and HTML, byte for byte; the empty-registry and
missing-families cases; the ``python -m repro_torch.obs.report`` CLI.

Both packages' plan and degraded-plan caches are cleared and both
registries emptied first: the report mirrors the cache counters, and a
snapshot holds every metric declared in the process.
Tolerance: exact equality (strings byte for byte)."""
import os
import pathlib
import subprocess
import sys

import pytest

from repro.core import coded_collectives as jcc
from repro.core import degraded as jdeg
from repro.core.params import SchemeParams as JParams
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro_torch.core import coded_collectives as tcc
from repro_torch.core import degraded as tdeg
from repro_torch.core.params import SchemeParams
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import report as treport

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_state():
    for mod in (tcc, jcc):
        mod.plan_cache_clear()
    for mod in (tdeg, jdeg):
        mod.degraded_cache_clear()
    for mod in (tmetrics, jmetrics):
        mod.registry().clear()
    yield
    for mod in (tmetrics, jmetrics):
        mod.registry().clear()


def _populate(m):
    reg = m.MetricsRegistry()
    c = reg.counter("decisions_total", "admission decisions")
    c.inc(2, scheme="hybrid", r=2)
    c.inc(3.5, scheme="coded", r=3)
    g = reg.gauge("queue_depth", "jobs waiting")
    g.set(7.0, policy="fifo")
    g.add(-2.5, policy="fifo")
    g.add(1.0, policy="srpt")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0, float("inf")):
        h.observe(v, layer="sim")
    reg.histogram("empty_hist", "never observed")
    w = reg.gauge("9weird.name-x", 'multi\nline "help" \\slash')
    w.set(float("nan"), **{"bad-label": 'va"l\\ue\nz'})
    w.set(float("-inf"), other="x")
    return reg


def test_prometheus_text_and_snapshot_json_equal_jax():
    t, j = _populate(tmetrics), _populate(jmetrics)
    assert t.to_prometheus_text() == j.to_prometheus_text()
    assert t.snapshot_json() == j.snapshot_json()
    assert t.snapshot_json(indent=2) == j.snapshot_json(indent=2)
    assert t.names() == j.names()
    assert 'le="+Inf"' in t.to_prometheus_text()
    assert tmetrics.MetricsRegistry().to_prometheus_text() == \
        jmetrics.MetricsRegistry().to_prometheus_text() == ""


def test_reset_keeps_declarations_and_clear_drops_them_equal_jax():
    t, j = _populate(tmetrics), _populate(jmetrics)
    for reg in (t, j):
        reg.reset()
    assert t.snapshot_json() == j.snapshot_json()
    assert t.names() == j.names() and len(t.names()) == 5
    assert t.histogram("lat_seconds").buckets == (0.1, 1.0, 10.0,
                                                  float("inf"))
    for reg in (t, j):
        reg.clear()
    assert t.names() == j.names() == []
    for m in (tmetrics, jmetrics):
        reg = m.MetricsRegistry()
        reg.counter("c").inc(1.0, a=1)
        reg.counter("c").reset()
        assert reg.counter("c").value(a=1) == 0.0


def test_module_level_helpers_equal_jax():
    for m in (tmetrics, jmetrics):
        m.counter("x_total", "an x").inc(3, k="v")
        m.gauge("y", "a y").set(2.0)
    assert tmetrics.snapshot() == jmetrics.snapshot()
    assert tmetrics.to_prometheus_text() == jmetrics.to_prometheus_text()
    for m in (tmetrics, jmetrics):
        m.reset()
    assert tmetrics.snapshot() == jmetrics.snapshot()
    assert tmetrics.snapshot()["x_total"]["samples"] == {}


def test_collect_cache_metrics_equal_jax():
    for cc, Params in ((tcc, SchemeParams), (jcc, JParams)):
        for n in (48, 96, 48):
            cc.compile_hybrid_plan(Params(K=8, P=4, Q=16, N=n, r=2))
        cc.compile_hybrid_plan(Params(K=8, P=8, Q=16, N=64, r=2),
                               family="resolvable")
    t = tmetrics.collect_cache_metrics(tmetrics.MetricsRegistry())
    j = jmetrics.collect_cache_metrics(jmetrics.MetricsRegistry())
    assert t == j
    assert t["plan_cache"]["samples"]['{"event": "hit", "family": "all"}'] \
        == 1.0


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def _demo(report, metrics, seed):
    events, telemetry, stats = report._demo_populate(seed)
    rep = report.build_report(events=events, telemetry=telemetry,
                              stats=stats)
    return rep, report.render_markdown(rep), report.render_html(rep)


@pytest.mark.parametrize("seed", [0, 3])
def test_demo_report_equal_jax_byte_for_byte(seed):
    t_rep, t_md, t_html = _demo(treport, tmetrics, seed)
    j_rep, j_md, j_html = _demo(jreport, jmetrics, seed)
    assert t_md == j_md
    assert t_html == j_html
    assert t_rep["blame"]["jobs"] and t_rep["link_utilization"]
    assert t_rep["prediction_hists"] and t_rep["trace"]["n_events"] > 0


def test_empty_registry_report_equal_jax():
    t = treport.build_report(snapshot={})
    j = jreport.build_report(snapshot={})
    assert t == j
    assert treport.render_markdown(t) == jreport.render_markdown(j)
    assert treport.render_html(t) == jreport.render_html(j)
    assert "_registry is empty_" in treport.render_markdown(t)


def test_missing_families_report_equal_jax():
    snap = {"lonely_total": {"type": "counter", "help": "",
                             "samples": {"{}": 3.0}}}
    t, j = treport.build_report(snapshot=snap), jreport.build_report(
        snapshot=snap)
    assert t == j and t["rack_matrices"] == {} and t["wasted"] == []
    assert treport.render_markdown(t) == jreport.render_markdown(j)
    assert treport.render_html(t) == jreport.render_html(j)


def test_write_report_picks_format_by_extension_equal_jax(tmp_path):
    texts = []
    for name, report in (("t", treport), ("j", jreport)):
        rep = report.build_report(snapshot={}, title="x")
        md = report.write_report(str(tmp_path / f"{name}.md"), rep)
        html = report.write_report(str(tmp_path / f"{name}.html"), rep)
        texts.append((pathlib.Path(md).read_text(),
                      pathlib.Path(html).read_text()))
    assert texts[0] == texts[1]
    assert texts[0][1].startswith("<!doctype html>")


def test_report_cli_writes_the_jax_cli_s_files(tmp_path):
    """``python -m repro_torch.obs.report`` (a process of its own) writes
    the same two files as the JAX package's CLI run in this process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          "--out-dir", str(tmp_path / "t"), "--seed", "3"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["wrote", str(tmp_path / "t" /
                                               "obs_report.md"),
                                  "wrote", str(tmp_path / "t" /
                                               "obs_report.html")]
    jcc.plan_cache_clear()
    jreport.main(["--out-dir", str(tmp_path / "j"), "--seed", "3"])
    for name in ("obs_report.md", "obs_report.html"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
