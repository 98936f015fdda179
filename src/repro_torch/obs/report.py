"""Standalone observatory report: one page that answers "what did the
system just do, and does its model of the machine still hold?".

:func:`build_report` folds a metrics snapshot + trace events into a plain
structured dict; :func:`render_markdown` / :func:`render_html` turn that
into a committed-artifact-friendly page with four sections:

  * **metrics snapshot** — every counter/gauge series, histograms
    summarized as count/sum/mean;
  * **prediction-error distributions** — the ``jct_prediction_*``
    histograms (absolute seconds and relative error) per layer, rendered
    as cumulative bucket tables, plus the drift gauges
    (``jct_drift_ewma``, ``jct_model_regret_seconds``);
  * **per-rack byte matrices** — ``rack_pair_bytes_total`` re-assembled
    into the [P, P] cross-rack matrix per layer (the paper's central
    quantity, as actually moved);
  * **link utilization** — per-resource (root / ToR uplinks) busy time,
    utilization fraction, mean active flows and a binned activity
    timeline, from :class:`repro_torch.sim.NetworkTelemetry`;
  * **JCT blame** — per-job blame decomposition table
    (:mod:`repro_torch.obs.blame`, components sum to measured JCT) plus the
    fleet-level p99 rollup — what is making the tail slow;
  * **wasted work** — ``flow_cancelled_bytes_total`` by (stage, reason):
    partially-drained value-units of cancelled flows (speculation
    losers, crash-voided stages);
  * **trace summary** — event counts by kind and total span seconds per
    (kind, phase) lane.

``python -m repro_torch.obs.report`` runs a small seeded scheduled-sim demo
to populate the registry and writes ``bench_out/obs_report.md`` +
``.html``; pass ``--no-demo`` to render
whatever the process registry already holds (e.g. from a bench that
imports this module at exit).  Zero dependencies beyond the stdlib.
"""
from __future__ import annotations

import html as _html
import json
from typing import Dict, List, Optional, Sequence

from . import metrics as _metrics


# ---------------------------------------------------------------------------
# Fold snapshot + events into one structured report dict
# ---------------------------------------------------------------------------

def _series(snap: Dict, name: str) -> Dict[str, object]:
    return snap.get(name, {}).get("samples", {})


def _resource_order(key: str):
    # "root" first, then ToR uplinks in rack order
    if key == "root":
        return (0, 0)
    if key.startswith("tor:"):
        return (1, int(key.split(":", 1)[1]))
    return (2, 0)


_SPARK = " ▁▂▃▄▅▆▇█"


def _activity_timeline(series: Sequence[Sequence[float]], horizon: float,
                       bins: int = 32) -> str:
    """Binned sparkline of time-weighted mean active flows over the run —
    the compact "when was this link busy" view of a sample series."""
    if not series or horizon <= series[0][0]:
        return ""
    t0 = series[0][0]
    width = (horizon - t0) / bins
    weighted = [0.0] * bins
    for i, row in enumerate(series):
        t, active = float(row[0]), float(row[1])
        t_next = float(series[i + 1][0]) if i + 1 < len(series) else horizon
        lo, hi = max(t, t0), min(t_next, horizon)
        if hi <= lo or active <= 0:
            continue
        b0 = min(int((lo - t0) / width), bins - 1)
        b1 = min(int((hi - t0) / width - 1e-12), bins - 1)
        for b in range(b0, b1 + 1):
            seg = min(hi, t0 + (b + 1) * width) - max(lo, t0 + b * width)
            weighted[b] += active * max(seg, 0.0)
    peak = max(weighted)
    if peak <= 0:
        return _SPARK[0] * bins
    return "".join(
        _SPARK[min(int(w / peak * (len(_SPARK) - 1) + 0.5),
                   len(_SPARK) - 1)] for w in weighted)


def _utilization_section(telemetry) -> List[Dict[str, object]]:
    """Per-resource rollup rows from a
    :class:`repro_torch.sim.NetworkTelemetry`
    (or any object with the same ``utilization()``/``samples`` shape)."""
    if telemetry is None:
        return []
    util = telemetry.utilization()
    samples = getattr(telemetry, "samples", {})
    horizon = max((s[-1][0] for s in samples.values() if s), default=0.0)
    rows = []
    for key in sorted(util, key=_resource_order):
        u = util[key]
        rows.append({"resource": key, **u,
                     "timeline": _activity_timeline(samples.get(key, ()),
                                                    horizon)})
    return rows


def _blame_section(stats: Optional[Sequence]) -> Dict[str, object]:
    """Per-job blame table + fleet rollup from completed-job stats (any
    objects accepted by :func:`repro_torch.obs.blame.blame_report`, or
    ready-made :class:`BlameReport` instances).  Jobs without a blame
    decomposition (e.g. crashed before finishing) are skipped."""
    from . import blame as _blame
    reports = []
    for s in stats or ():
        if isinstance(s, _blame.BlameReport):
            reports.append(s)
        elif getattr(s, "blame", None) is not None:
            reports.append(_blame.blame_report(s))
    if not reports:
        return {}
    # only show components that matter somewhere in the fleet
    active = [c for c in _blame.COMPONENTS
              if any(abs(r.components.get(c, 0.0)) > 0 for r in reports)]
    jobs = [{"job_id": r.job_id, "name": r.name, "scheme": r.scheme,
             "r": r.r, "jct": r.jct, "dominant": r.dominant(),
             "residual": r.residual,
             "components": {c: r.components.get(c, 0.0) for c in active}}
            for r in sorted(reports, key=lambda r: r.job_id)]
    return {"components": active, "jobs": jobs,
            "fleet": _blame.fleet_blame(reports)}


def _wasted_section(snap: Dict) -> List[Dict[str, object]]:
    rows = []
    for labels_json, v in sorted(
            _series(snap, "flow_cancelled_bytes_total").items()):
        lb = json.loads(labels_json)
        rows.append({"stage": lb.get("stage", ""),
                     "reason": lb.get("reason", ""), "units": float(v)})
    return rows


def build_report(snapshot: Optional[Dict] = None,
                 events: Optional[Sequence] = None,
                 title: str = "Observatory report",
                 telemetry=None,
                 stats: Optional[Sequence] = None) -> Dict[str, object]:
    """Structured report from a registry ``snapshot`` (default registry's
    if None) and optional :class:`repro_torch.obs.TraceEvent` sequence.

    ``telemetry`` (a :class:`repro_torch.sim.NetworkTelemetry`) adds the
    link-utilization section; ``stats`` (completed-job stats or
    :class:`BlameReport` instances) adds the per-job blame table and the
    fleet p99 rollup.  Both default to empty sections when absent, so the
    report renders from a bare registry too."""
    snap = snapshot if snapshot is not None else _metrics.snapshot()
    scalars: List[Dict[str, object]] = []
    hist_summary: List[Dict[str, object]] = []
    pred_hists: List[Dict[str, object]] = []
    for name in sorted(snap):
        meta = snap[name]
        for labels_json, val in meta.get("samples", {}).items():
            if meta.get("type") == "histogram":
                row = {"name": name, "labels": labels_json,
                       "count": val["count"], "sum": val["sum"],
                       "mean": (val["sum"] / val["count"]
                                if val["count"] else 0.0)}
                hist_summary.append(row)
                if name.startswith("jct_prediction"):
                    pred_hists.append({**row, "buckets": val["buckets"],
                                       "counts": val["counts"]})
            else:
                scalars.append({"name": name, "kind": meta.get("type"),
                                "labels": labels_json, "value": val})
    drift_gauges = [s for s in scalars
                    if s["name"] in ("jct_drift_ewma",
                                     "jct_model_regret_seconds")]

    # rack matrices: {"src": i, "dst": j, "layer": l} -> [P, P] per layer
    matrices: Dict[str, Dict] = {}
    for labels_json, v in _series(snap, "rack_pair_bytes_total").items():
        lb = json.loads(labels_json)
        layer = lb.get("layer", "")
        m = matrices.setdefault(layer, {})
        m[(int(lb["src"]), int(lb["dst"]))] = float(v)
    rack_matrices = {}
    for layer, cells in sorted(matrices.items()):
        P = 1 + max(max(s, t) for s, t in cells)
        mat = [[cells.get((s, t), 0.0) for t in range(P)] for s in range(P)]
        rack_matrices[layer] = mat

    trace: Dict[str, object] = {}
    if events:
        by_kind: Dict[str, int] = {}
        span_s: Dict[str, float] = {}
        for ev in events:
            by_kind[ev.kind] = by_kind.get(ev.kind, 0) + 1
            if ev.dur is not None:
                lane = f"{ev.kind}:{ev.phase}" if ev.phase else ev.kind
                span_s[lane] = span_s.get(lane, 0.0) + float(ev.dur)
        trace = {"n_events": len(events),
                 "by_kind": dict(sorted(by_kind.items())),
                 "span_seconds": {k: span_s[k] for k in sorted(span_s)}}

    return {"title": title, "scalars": scalars,
            "histograms": hist_summary, "prediction_hists": pred_hists,
            "drift_gauges": drift_gauges, "rack_matrices": rack_matrices,
            "link_utilization": _utilization_section(telemetry),
            "blame": _blame_section(stats),
            "wasted": _wasted_section(snap),
            "trace": trace}


# ---------------------------------------------------------------------------
# Renderers (markdown + standalone HTML from the same structure)
# ---------------------------------------------------------------------------

def _md_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def _fmt(v: object) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_markdown(report: Dict[str, object]) -> str:
    lines = [f"# {report['title']}", ""]
    lines += ["## Metrics snapshot", ""]
    if report["scalars"]:
        lines.append(_md_table(
            ("metric", "kind", "labels", "value"),
            [(s["name"], s["kind"], f"`{s['labels']}`", _fmt(s["value"]))
             for s in report["scalars"]]))
    else:
        lines.append("_registry is empty_")
    if report["histograms"]:
        lines += ["", _md_table(
            ("histogram", "labels", "count", "sum", "mean"),
            [(h["name"], f"`{h['labels']}`", h["count"], _fmt(h["sum"]),
              _fmt(h["mean"])) for h in report["histograms"]])]

    lines += ["", "## Prediction-error distributions", ""]
    if report["prediction_hists"]:
        for h in report["prediction_hists"]:
            lines += [f"### `{h['name']}` {h['labels']}", "",
                      f"n={h['count']}  sum={_fmt(h['sum'])}  "
                      f"mean={_fmt(h['mean'])}", "",
                      _md_table(("bucket &le;", "cumulative count"),
                                list(zip(map(str, h["buckets"]),
                                         h["counts"]))), ""]
        if report["drift_gauges"]:
            lines += [_md_table(
                ("drift gauge", "labels", "value"),
                [(g["name"], f"`{g['labels']}`", _fmt(g["value"]))
                 for g in report["drift_gauges"]]), ""]
    else:
        lines += ["_no predictions recorded_", ""]

    lines += ["## Per-rack byte matrices (cross-rack value-units)", ""]
    if report["rack_matrices"]:
        for layer, mat in report["rack_matrices"].items():
            P = len(mat)
            lines += [f"### layer `{layer or '(none)'}`", "",
                      _md_table(["src\\dst"] + [str(j) for j in range(P)],
                                [[str(i)] + [_fmt(v) for v in row]
                                 for i, row in enumerate(mat)]), ""]
    else:
        lines += ["_no rack-level bytes recorded_", ""]

    lines += ["## Link utilization", ""]
    util_rows = report.get("link_utilization") or []
    if util_rows:
        lines += [_md_table(
            ("resource", "busy s", "util", "mean active", "peak backlog",
             "done", "cancelled", "activity timeline"),
            [(u["resource"], _fmt(u["busy_s"]), _fmt(u["util"]),
              _fmt(u["mean_active_flows"]), _fmt(u["peak_backlog"]),
              u["flows_done"], u["flows_cancelled"],
              f"`{u['timeline']}`" if u["timeline"] else "")
             for u in util_rows]), ""]
    else:
        lines += ["_no network telemetry provided_", ""]

    lines += ["## JCT blame decomposition", ""]
    bl = report.get("blame") or {}
    if bl:
        comps = bl["components"]
        lines += [_md_table(
            ["job", "name", "scheme", "r", "JCT", "dominant"] + comps,
            [[j["job_id"], j["name"], j["scheme"], j["r"], _fmt(j["jct"]),
              j["dominant"]] + [_fmt(j["components"][c]) for c in comps]
             for j in bl["jobs"]]), ""]
        fl = bl["fleet"]
        lines += [f"fleet rollup over n={fl['n']} jobs "
                  f"(q={fl['q']:g}): mean JCT {_fmt(fl['jct_mean'])} s, "
                  f"p{int(fl['q'] * 100)} JCT {_fmt(fl['jct_q'])} s, "
                  f"max |residual| {_fmt(fl['max_abs_residual'])} s", "",
                  _md_table(
                      ("component", "fleet mean s", f"p{int(fl['q'] * 100)} s",
                       "tail mean s", "tail share"),
                      [(c, _fmt(fl["mean"][c]), _fmt(fl["quantile"][c]),
                        _fmt(fl["tail_mean"][c]), _fmt(fl["tail_share"][c]))
                       for c in comps if c in fl["mean"]]), ""]
    else:
        lines += ["_no completed-job blame provided_", ""]

    lines += ["## Wasted work (cancelled flows)", ""]
    wasted = report.get("wasted") or []
    if wasted:
        lines += [_md_table(
            ("stage", "reason", "drained value-units"),
            [(w["stage"], w["reason"], _fmt(w["units"]))
             for w in wasted]), ""]
    else:
        lines += ["_no cancelled-flow bytes recorded_", ""]

    lines += ["## Trace summary", ""]
    tr = report["trace"]
    if tr:
        lines.append(f"{tr['n_events']} events")
        lines += ["", _md_table(("event kind", "count"),
                                sorted(tr["by_kind"].items()))]
        if tr["span_seconds"]:
            lines += ["", _md_table(
                ("span lane", "total seconds"),
                [(k, _fmt(v)) for k, v in tr["span_seconds"].items()])]
    else:
        lines.append("_no trace events provided_")
    return "\n".join(lines) + "\n"


_HTML_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2rem; color: #222; }
table { border-collapse: collapse; margin: 0.5rem 0 1.25rem; }
th, td { border: 1px solid #ccc; padding: 0.25rem 0.6rem;
         font-size: 0.85rem; text-align: right; }
th { background: #f0f0f3; }
td:first-child, th:first-child { text-align: left; }
code { background: #f5f5f7; padding: 0 0.2rem; }
h2 { border-bottom: 2px solid #e0e0e6; padding-bottom: 0.2rem; }
"""


def _html_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    head = "".join(f"<th>{_html.escape(str(h))}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_html.escape(str(c))}</td>" for c in r)
        + "</tr>" for r in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def render_html(report: Dict[str, object]) -> str:
    h: List[str] = ["<!doctype html><html><head><meta charset='utf-8'>",
                    f"<title>{_html.escape(str(report['title']))}</title>",
                    f"<style>{_HTML_STYLE}</style></head><body>",
                    f"<h1>{_html.escape(str(report['title']))}</h1>"]
    h.append("<h2>Metrics snapshot</h2>")
    if report["scalars"]:
        h.append(_html_table(
            ("metric", "kind", "labels", "value"),
            [(s["name"], s["kind"], s["labels"], _fmt(s["value"]))
             for s in report["scalars"]]))
    if report["histograms"]:
        h.append(_html_table(
            ("histogram", "labels", "count", "sum", "mean"),
            [(x["name"], x["labels"], x["count"], _fmt(x["sum"]),
              _fmt(x["mean"])) for x in report["histograms"]]))

    h.append("<h2>Prediction-error distributions</h2>")
    if report["prediction_hists"]:
        for x in report["prediction_hists"]:
            h.append(f"<h3><code>{_html.escape(x['name'])}</code> "
                     f"{_html.escape(x['labels'])}</h3>")
            h.append(f"<p>n={x['count']} sum={_fmt(x['sum'])} "
                     f"mean={_fmt(x['mean'])}</p>")
            h.append(_html_table(("bucket ≤", "cumulative count"),
                                 list(zip(map(str, x["buckets"]),
                                          x["counts"]))))
        if report["drift_gauges"]:
            h.append(_html_table(
                ("drift gauge", "labels", "value"),
                [(g["name"], g["labels"], _fmt(g["value"]))
                 for g in report["drift_gauges"]]))
    else:
        h.append("<p><em>no predictions recorded</em></p>")

    h.append("<h2>Per-rack byte matrices</h2>")
    for layer, mat in report["rack_matrices"].items():
        P = len(mat)
        h.append(f"<h3>layer <code>{_html.escape(layer or '(none)')}"
                 f"</code></h3>")
        h.append(_html_table(
            ["src\\dst"] + [str(j) for j in range(P)],
            [[str(i)] + [_fmt(v) for v in row]
             for i, row in enumerate(mat)]))

    h.append("<h2>Link utilization</h2>")
    util_rows = report.get("link_utilization") or []
    if util_rows:
        h.append(_html_table(
            ("resource", "busy s", "util", "mean active", "peak backlog",
             "done", "cancelled", "activity timeline"),
            [(u["resource"], _fmt(u["busy_s"]), _fmt(u["util"]),
              _fmt(u["mean_active_flows"]), _fmt(u["peak_backlog"]),
              u["flows_done"], u["flows_cancelled"], u["timeline"])
             for u in util_rows]))
    else:
        h.append("<p><em>no network telemetry provided</em></p>")

    h.append("<h2>JCT blame decomposition</h2>")
    bl = report.get("blame") or {}
    if bl:
        comps = bl["components"]
        h.append(_html_table(
            ["job", "name", "scheme", "r", "JCT", "dominant"] + comps,
            [[j["job_id"], j["name"], j["scheme"], j["r"], _fmt(j["jct"]),
              j["dominant"]] + [_fmt(j["components"][c]) for c in comps]
             for j in bl["jobs"]]))
        fl = bl["fleet"]
        h.append(f"<p>fleet rollup over n={fl['n']} jobs "
                 f"(q={fl['q']:g}): mean JCT {_fmt(fl['jct_mean'])} s, "
                 f"p{int(fl['q'] * 100)} JCT {_fmt(fl['jct_q'])} s, "
                 f"max |residual| {_fmt(fl['max_abs_residual'])} s</p>")
        h.append(_html_table(
            ("component", "fleet mean s", f"p{int(fl['q'] * 100)} s",
             "tail mean s", "tail share"),
            [(c, _fmt(fl["mean"][c]), _fmt(fl["quantile"][c]),
              _fmt(fl["tail_mean"][c]), _fmt(fl["tail_share"][c]))
             for c in comps if c in fl["mean"]]))
    else:
        h.append("<p><em>no completed-job blame provided</em></p>")

    h.append("<h2>Wasted work (cancelled flows)</h2>")
    wasted = report.get("wasted") or []
    if wasted:
        h.append(_html_table(
            ("stage", "reason", "drained value-units"),
            [(w["stage"], w["reason"], _fmt(w["units"])) for w in wasted]))
    else:
        h.append("<p><em>no cancelled-flow bytes recorded</em></p>")

    h.append("<h2>Trace summary</h2>")
    tr = report["trace"]
    if tr:
        h.append(f"<p>{tr['n_events']} events</p>")
        h.append(_html_table(("event kind", "count"),
                             sorted(tr["by_kind"].items())))
        if tr["span_seconds"]:
            h.append(_html_table(
                ("span lane", "total seconds"),
                [(k, _fmt(v)) for k, v in tr["span_seconds"].items()]))
    else:
        h.append("<p><em>no trace events provided</em></p>")
    h.append("</body></html>")
    return "".join(h)


def write_report(path: str, report: Optional[Dict] = None,
                 events: Optional[Sequence] = None,
                 title: str = "Observatory report",
                 telemetry=None, stats: Optional[Sequence] = None) -> str:
    """Render ``report`` (built from the default registry when None) to
    ``path``; the extension picks the format (.html -> HTML, else
    markdown).  Returns the path."""
    rep = report if report is not None else build_report(
        events=events, title=title, telemetry=telemetry, stats=stats)
    text = (render_html(rep) if path.endswith((".html", ".htm"))
            else render_markdown(rep))
    with open(path, "w") as f:
        f.write(text)
    return path


# ---------------------------------------------------------------------------
# Demo CLI: populate the registry with a seeded scheduled-sim run, render
# ---------------------------------------------------------------------------

def _demo_populate(seed: int = 0):
    """Seeded scheduled workload through the simulator so every section of
    the report has real content; returns (trace events, network telemetry,
    per-job stats)."""
    from ..sim import (ClusterSim, MultiJobScheduler, PoissonWorkload,
                      RackTopology, SchemeChooser, default_catalog)
    from ..sim.cluster import CostModel, PhaseCoeffs
    _metrics.reset()
    topo = RackTopology(P=4, cross_bw=2e4, intra_bw=2e5)
    cluster = ClusterSim(topo, K=8, seed=seed, telemetry=True)
    cm = CostModel(map=PhaseCoeffs(1e-3, 2e-7),
                   pack=PhaseCoeffs(5e-4, 1e-7),
                   reduce=PhaseCoeffs(1e-3, 2e-7))
    chooser = SchemeChooser(8, cost_model=cm, compile_real_plans=False)
    wl = PoissonWorkload(default_catalog(8, 4), n_jobs=24, rate=2.0)
    sched = MultiJobScheduler(chooser, policy="srpt", max_concurrent=4)
    stats = sched.run(wl.generate(seed), cluster)
    _metrics.refresh_cache_metrics()
    return list(cluster.tracer.events), cluster.telemetry, stats


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import os
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="bench_out",
                    help="directory for obs_report.md / obs_report.html")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-demo", action="store_true",
                    help="render the current process registry instead of "
                         "running the seeded demo workload")
    args = ap.parse_args(argv)
    events: Optional[List] = None
    telemetry = stats = None
    if not args.no_demo:
        events, telemetry, stats = _demo_populate(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    rep = build_report(events=events, telemetry=telemetry, stats=stats)
    for name in ("obs_report.md", "obs_report.html"):
        path = write_report(os.path.join(args.out_dir, name), rep)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()


__all__ = ["build_report", "render_markdown", "render_html",
           "write_report", "main"]
