"""Per-phase breakdown report CLI over span/metrics JSONL.

A copy of the JAX package's ``repro.obs.report`` (numpy only), on the
port's ``read_jsonl``.

Reads the JSONL streams the entry points emit (``launch.train
--metrics-out``, ``launch.serve --metrics-out``, benchmark
``--metrics-out`` files, or span dumps from ``obs.spans.to_records``) and
prints, per record family:

* the **per-phase breakdown table** — every ``phase_*_ms`` column (or span
  path) with count, total/mean ms, p50/p95, and share of the step total;
* the **coverage line** — what fraction of ``step_time_ms`` the phases
  account for (the serving scheduler's four phases tile the round, so
  this sits at ~100%);
* the **top-N slowest steps** with their phase split.

``--trace out.json`` additionally exports a Chrome trace-event file
(loadable in Perfetto / ``chrome://tracing``): each step becomes a
complete event on a per-family track, its phases laid out as children.

    PYTHONPATH=src python -m repro_torch.obs.report serve.jsonl train.jsonl \
        --top 5 --trace out.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import read_jsonl

PHASE_PREFIX = "phase_"
PHASE_SUFFIX = "_ms"
STEP_TIME_KEY = "step_time_ms"
STEP_KEY = "step"

Row = Mapping[str, Any]


def is_phase_key(key: str) -> bool:
    return key.startswith(PHASE_PREFIX) and key.endswith(PHASE_SUFFIX)


def phase_label(key: str) -> str:
    return key[len(PHASE_PREFIX):-len(PHASE_SUFFIX)]


def group_rows(rows: Iterable[Row]) -> Dict[str, List[Row]]:
    """Split a mixed stream into record families: by ``name`` when present
    (serve.step / serve.request / span), else by the golden-dialect
    ``exp``/``variant``/``method`` keys (benchmark JSONL), else one
    ``"steps"`` family (the trainer sink)."""
    out: Dict[str, List[Row]] = {}
    for r in rows:
        if "name" in r:
            label = str(r["name"])
        else:
            parts = [str(r[k]) for k in ("exp", "variant", "method")
                     if k in r]
            label = "/".join(parts) if parts else "steps"
        out.setdefault(label, []).append(r)
    return out


# ----------------------------------------------------------- phase columns

def phase_breakdown(rows: Sequence[Row]) -> Optional[Dict[str, Any]]:
    """Aggregate the ``phase_*_ms`` columns of one record family.

    Returns None when the family carries no phase columns.  ``coverage``
    is sum(phases)/sum(step_time_ms); ``min_step_coverage`` is the worst
    single step (the acceptance bar: every step >= 90%).
    """
    keys = sorted({k for r in rows for k in r if is_phase_key(k)})
    if not keys:
        return None
    steps = [r for r in rows if any(k in r for k in keys)]
    phases = {}
    for k in keys:
        vals = np.asarray([float(r.get(k, 0.0)) for r in steps], np.float64)
        phases[k] = {
            "count": int(np.sum([k in r for r in steps])),
            "total_ms": float(vals.sum()),
            "mean_ms": float(vals.mean()) if vals.size else 0.0,
            "p50_ms": float(np.percentile(vals, 50)) if vals.size else 0.0,
            "p95_ms": float(np.percentile(vals, 95)) if vals.size else 0.0,
        }
    total = np.asarray([float(r.get(STEP_TIME_KEY, 0.0)) for r in steps])
    phase_sum = np.asarray([sum(float(r.get(k, 0.0)) for k in keys)
                            for r in steps])
    total_sum = float(total.sum())
    for k in keys:
        phases[k]["pct_of_step"] = (phases[k]["total_ms"] / total_sum
                                    if total_sum > 0 else 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_step_cov = np.where(total > 0, phase_sum / total, 1.0)
    return {
        "n_steps": len(steps),
        "phases": phases,
        "step_time_total_ms": total_sum,
        "coverage": (float(phase_sum.sum()) / total_sum
                     if total_sum > 0 else 1.0),
        "min_step_coverage": (float(per_step_cov.min())
                              if len(steps) else 1.0),
    }


def slowest_steps(rows: Sequence[Row], n: int) -> List[Row]:
    timed = [r for r in rows if STEP_TIME_KEY in r]
    return sorted(timed, key=lambda r: -float(r[STEP_TIME_KEY]))[:n]


# -------------------------------------------------------------- span rows

def span_breakdown(rows: Sequence[Row]) -> Optional[Dict[str, Any]]:
    """Aggregate ``name="span"`` rows (obs.spans.to_records dialect) by
    their slash-joined path."""
    spans = [r for r in rows if "path" in r and "dur_ms" in r]
    if not spans:
        return None
    durs: Dict[str, List[float]] = {}
    child: Dict[str, float] = {}
    for r in spans:
        path = str(r["path"])
        d = float(r["dur_ms"])
        durs.setdefault(path, []).append(d)
        if "/" in path:
            parent = path.rsplit("/", 1)[0]
            child[parent] = child.get(parent, 0.0) + d
    total = {p: sum(v) for p, v in durs.items()}
    out = {}
    for path, ds in sorted(durs.items()):
        arr = np.asarray(ds, np.float64)
        parent = path.rsplit("/", 1)[0] if "/" in path else ""
        root = path.split("/", 1)[0]
        ptotal = total.get(parent, total[path]) if parent else total[path]
        out[path] = {
            "count": len(ds), "total_ms": total[path],
            "self_ms": total[path] - child.get(path, 0.0),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "pct_of_parent": total[path] / ptotal if ptotal > 0 else 0.0,
            "pct_of_root": (total[path] / total[root]
                            if total.get(root, 0) > 0 else 0.0),
        }
    return {"paths": out, "n_spans": len(spans)}


# ------------------------------------------------------------ trace export

def rows_to_chrome_trace(groups: Mapping[str, Sequence[Row]]
                         ) -> Dict[str, Any]:
    """Synthesize a Perfetto-loadable Chrome trace from phase columns:
    steps of each family stack end-to-end on their own track, with the
    phase columns laid out sequentially inside each step."""
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": "repro_torch.obs.report"}}]
    tid = 0
    for name, rows in sorted(groups.items()):
        if name == "span":
            for r in rows:
                if "dur_ms" not in r:
                    continue
                events.append({
                    "name": str(r.get("span", r.get("path", "span"))),
                    "cat": "span", "ph": "X",
                    "ts": float(r.get("start_ms", 0.0)) * 1e3,
                    "dur": float(r["dur_ms"]) * 1e3,
                    "pid": 0, "tid": tid})
            tid += 1
            continue
        keys = sorted({k for r in rows for k in r if is_phase_key(k)})
        timed = [r for r in rows if STEP_TIME_KEY in r]
        if not timed:
            continue
        events.append({"ph": "M", "pid": 0, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
        cursor_us = 0.0
        for r in timed:
            dur_us = float(r[STEP_TIME_KEY]) * 1e3
            ev: Dict[str, Any] = {"name": name, "cat": "step", "ph": "X",
                                  "ts": cursor_us, "dur": dur_us,
                                  "pid": 0, "tid": tid}
            if STEP_KEY in r:
                ev["args"] = {"step": r[STEP_KEY]}
            events.append(ev)
            off = cursor_us
            for k in keys:
                d = float(r.get(k, 0.0)) * 1e3
                if d <= 0.0:
                    continue
                events.append({"name": phase_label(k), "cat": "phase",
                               "ph": "X", "ts": off, "dur": d,
                               "pid": 0, "tid": tid})
                off += d
            cursor_us += max(dur_us, off - cursor_us)
        tid += 1
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------- printing

def _fmt_table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    def line(cells):
        return "  ".join(c.rjust(w) if i else c.ljust(w)
                         for i, (c, w) in enumerate(zip(cells, widths)))
    return "\n".join([line(header)] + [line(r) for r in rows])


def format_phase_report(name: str, summary: Dict[str, Any],
                        slow: Sequence[Row]) -> str:
    lines = [f"== {name} ({summary['n_steps']} steps, "
             f"{summary['step_time_total_ms']:.3f} ms total) =="]
    table = []
    phases = summary["phases"]
    order = sorted(phases, key=lambda k: -phases[k]["total_ms"])
    for k in order:
        p = phases[k]
        table.append([phase_label(k), str(p["count"]),
                      f"{p['total_ms']:.3f}", f"{p['mean_ms']:.3f}",
                      f"{p['p50_ms']:.3f}", f"{p['p95_ms']:.3f}",
                      f"{p['pct_of_step']:.1%}"])
    lines.append(_fmt_table(
        ["phase", "count", "total_ms", "mean_ms", "p50_ms", "p95_ms",
         "% of step"], table))
    lines.append(f"-- phase coverage: {summary['coverage']:.1%} of "
                 f"step_time_ms (worst step "
                 f"{summary['min_step_coverage']:.1%})")
    if slow:
        keys = sorted({k for r in slow for k in r if is_phase_key(k)})
        lines.append(f"top {len(slow)} slowest steps:")
        table = [[str(r.get(STEP_KEY, "?")), f"{float(r[STEP_TIME_KEY]):.3f}"]
                 + [f"{float(r.get(k, 0.0)):.3f}" for k in keys]
                 for r in slow]
        lines.append(_fmt_table(
            ["step", STEP_TIME_KEY] + [phase_label(k) for k in keys], table))
    return "\n".join(lines)


def format_span_report(summary: Dict[str, Any]) -> str:
    lines = [f"== spans ({summary['n_spans']} recorded) =="]
    table = []
    for path, p in summary["paths"].items():
        indent = "  " * path.count("/")
        table.append([indent + path.rsplit("/", 1)[-1], str(p["count"]),
                      f"{p['total_ms']:.3f}", f"{p['self_ms']:.3f}",
                      f"{p['p50_ms']:.3f}", f"{p['p95_ms']:.3f}",
                      f"{p['pct_of_parent']:.1%}", f"{p['pct_of_root']:.1%}"])
    lines.append(_fmt_table(
        ["span", "count", "total_ms", "self_ms", "p50_ms", "p95_ms",
         "% parent", "% root"], table))
    return "\n".join(lines)


# --------------------------------------------------------------------- CLI

def report(paths: Sequence[str], top: int = 5,
           trace_out: Optional[str] = None,
           json_out: Optional[str] = None) -> Dict[str, Any]:
    """Programmatic entry point; returns the summary document and prints
    the human-readable report to stdout."""
    rows: List[Row] = []
    for p in paths:
        rows.extend(read_jsonl(p))
    groups = group_rows(rows)
    doc: Dict[str, Any] = {"files": list(paths), "groups": {}}
    chunks: List[str] = []
    for name in sorted(groups):
        grp = groups[name]
        if name == "span":
            summary = span_breakdown(grp)
            if summary:
                doc["groups"]["span"] = summary
                chunks.append(format_span_report(summary))
            continue
        summary = phase_breakdown(grp)
        if summary is None:
            continue
        slow = slowest_steps(grp, top)
        doc["groups"][name] = dict(summary, slowest=[dict(r) for r in slow])
        chunks.append(format_phase_report(name, summary, slow))
    if not chunks:
        chunks.append("no phase columns (phase_*_ms) or span records found "
                      f"in {', '.join(paths)}")
    if trace_out:
        os.makedirs(os.path.dirname(trace_out) or ".", exist_ok=True)
        with open(trace_out, "w") as f:
            json.dump(rows_to_chrome_trace(groups), f)
        chunks.append(f"chrome trace -> {trace_out} "
                      "(open in https://ui.perfetto.dev)")
    if json_out:
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(doc, f, indent=1)
        chunks.append(f"summary json -> {json_out}")
    print("\n\n".join(chunks))
    return doc


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+", help="metrics/span JSONL file(s)")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest steps to list per record family")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto/chrome://tracing trace file")
    ap.add_argument("--json", default=None, metavar="OUT.json",
                    dest="json_out", help="write the summary as JSON")
    args = ap.parse_args(argv)
    for p in args.paths:
        if not os.path.exists(p):
            print(f"error: no such file {p}", file=sys.stderr)
            return 2
    report(args.paths, top=args.top, trace_out=args.trace,
           json_out=args.json_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
