"""Trajectory regression: golden-run baselines for per-step JSONL telemetry.

The benchmarks (exp1/exp2, the trainer, ``benchmarks/run.py``) emit one JSON
record per step through ``obs.JsonlSink``.  This module turns those streams
into *golden baselines* and diffs later runs against them, so a PR that
silently slows a step or flattens a convergence curve fails CI instead of
landing.

Two kinds of series, compared differently:

* **Trajectories** (``consensus_error``, ``memory_norm``, ``grad_norm``,
  ``loss``, ...) — deterministic given a seed, so the baseline stores the
  full series and the check is a pointwise noise-tolerant comparison:
  a point drifts when ``|cur - base| > atol + rtol * max(|cur|, |base|)``,
  and the series fails when more than ``max_violation_frac`` of aligned
  points drift.  The ``atol`` floor matters for monotone-decay metrics
  (consensus error decays below float noise; relative error alone would
  flag garbage bits).

* **Timing** (``step_time_ms`` and every per-phase ``phase_*_ms`` column
  the span profiler adds) — wall-clock, never byte-stable, so the
  baseline stores percentiles only and the check is a one-sided band:
  the current median may not exceed ``timing_ratio`` x the baseline median.
  Each phase gets its own band, so a regression confined to (say) prefill
  trips the gate even when the whole-step total hides it.  Phases whose
  baseline median sits under ``timing_floor_ms`` are skipped — a 20 μs
  bookkeeping phase doubling is scheduler noise, not a regression.  The
  default ratio is generous (shared CI runners are noisy); perf PRs
  that want a tight gate re-record on the target hardware and lower it.

Baselines are plain JSON (``make_baseline`` / ``write_baseline`` /
``load_baseline``); ``compare_to_baseline`` returns a flat list of
``MetricDiff`` rows and ``format_report`` renders them.

This is a copy of the JAX package's ``repro.obs.regress`` (plain numpy) on
the port's ``read_jsonl``, so the port's runs are held against the committed
baselines in ``benchmarks/baselines/`` (read as JSON files) without JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.obs.metrics import read_jsonl

BASELINE_SCHEMA = 1

#: keys that identify a series rather than measure it
DEFAULT_GROUP_KEYS = ("exp", "name", "variant", "method", "seed")
DEFAULT_STEP_KEY = "step"
DEFAULT_TIMING_KEY = "step_time_ms"


def is_timing_metric(name: str,
                     timing_key: str = DEFAULT_TIMING_KEY) -> bool:
    """Wall-clock columns: the whole-step total plus the per-phase
    ``phase_*_ms`` columns the span profiler adds to step records."""
    return name == timing_key or (
        name.startswith("phase_") and name.endswith("_ms"))


Rows = Union[str, Sequence[Mapping[str, Any]]]


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Knobs for the noise-tolerant comparison (see module docstring)."""
    rtol: float = 0.05
    atol: float = 1e-6
    max_violation_frac: float = 0.02
    timing_ratio: float = 10.0
    timing_floor_ms: float = 0.05

    def __post_init__(self):
        if self.rtol < 0 or self.atol < 0:
            raise ValueError("tolerances must be >= 0")
        if not (0.0 <= self.max_violation_frac <= 1.0):
            raise ValueError("max_violation_frac must be in [0, 1]")
        if self.timing_ratio <= 0:
            raise ValueError("timing_ratio must be > 0")
        if self.timing_floor_ms < 0:
            raise ValueError("timing_floor_ms must be >= 0")


@dataclasses.dataclass
class MetricDiff:
    """Outcome of comparing one metric of one series against its baseline."""
    group: str
    metric: str
    passed: bool
    kind: str                 # "trajectory" | "timing" | "structure"
    detail: str = ""
    max_abs_err: float = 0.0
    max_rel_err: float = 0.0
    violation_frac: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ----------------------------------------------------------------- loading

def _rows(rows: Rows) -> List[Mapping[str, Any]]:
    if isinstance(rows, (str, os.PathLike)):
        return read_jsonl(str(rows))
    return list(rows)


def group_label(row: Mapping[str, Any],
                group_keys: Sequence[str] = DEFAULT_GROUP_KEYS) -> str:
    """Stable series identity, e.g. ``exp=exp1_quadratic/variant=fractional``."""
    parts = [f"{k}={row[k]}" for k in group_keys if k in row]
    return "/".join(parts) if parts else "<ungrouped>"


def load_trajectories(rows: Rows,
                      group_keys: Sequence[str] = DEFAULT_GROUP_KEYS,
                      step_key: str = DEFAULT_STEP_KEY,
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """Group per-step JSONL records into ``{series: {metric: values[T]}}``.

    Records are sorted by ``step_key`` within each series; every numeric
    field that is neither a group key nor the step index becomes a metric.
    Metrics missing from some steps are aligned by presence order (series
    emitted every step — the benchmark contract — are dense).
    """
    grouped: Dict[str, List[Mapping[str, Any]]] = {}
    for row in _rows(rows):
        grouped.setdefault(group_label(row, group_keys), []).append(row)

    out: Dict[str, Dict[str, np.ndarray]] = {}
    skip = set(group_keys) | {step_key}
    for label, recs in grouped.items():
        if all(step_key in r for r in recs):
            recs = sorted(recs, key=lambda r: r[step_key])
        series: Dict[str, List[float]] = {}
        for r in recs:
            for k, v in r.items():
                if k in skip or isinstance(v, bool):
                    continue
                if isinstance(v, (int, float)):
                    series.setdefault(k, []).append(float(v))
        out[label] = {k: np.asarray(v, np.float64) for k, v in series.items()}
    return out


def align(base: np.ndarray, cur: np.ndarray,
          max_length_frac: float = 0.0) -> Tuple[np.ndarray, np.ndarray, str]:
    """Truncate two series to their common prefix.

    Returns ``(base', cur', err)`` where ``err`` is non-empty when the
    length mismatch exceeds ``max_length_frac`` of the baseline length
    (0.0 = lengths must match exactly, the default: baselines are recorded
    at the same reduced scale the check runs at).
    """
    nb, nc = len(base), len(cur)
    m = min(nb, nc)
    err = ""
    if nb != nc:
        frac = abs(nb - nc) / max(nb, 1)
        if frac > max_length_frac:
            err = f"length mismatch: baseline {nb} vs current {nc}"
    return base[:m], cur[:m], err


# ----------------------------------------------------------------- compare

def compare_trajectory(group: str, metric: str, base: np.ndarray,
                       cur: np.ndarray, tol: Tolerance) -> MetricDiff:
    """Pointwise noise-tolerant diff of one deterministic trajectory."""
    base, cur, err = align(np.asarray(base, np.float64),
                           np.asarray(cur, np.float64))
    if err:
        return MetricDiff(group, metric, False, "trajectory", err)
    if len(base) == 0:
        return MetricDiff(group, metric, False, "trajectory", "empty series")
    abs_err = np.abs(cur - base)
    scale = np.maximum(np.abs(cur), np.abs(base))
    thresh = tol.atol + tol.rtol * scale
    viol = abs_err > thresh
    frac = float(np.mean(viol))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(scale > 0, abs_err / scale, 0.0)
    passed = frac <= tol.max_violation_frac
    detail = "" if passed else (
        f"{int(viol.sum())}/{len(base)} points drift "
        f"(>{tol.max_violation_frac:.0%} allowed); worst at step "
        f"{int(np.argmax(abs_err - thresh))}")
    return MetricDiff(group, metric, passed, "trajectory", detail,
                      max_abs_err=float(abs_err.max()),
                      max_rel_err=float(rel.max()),
                      violation_frac=frac)


def timing_percentiles(values: np.ndarray) -> Dict[str, float]:
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return {"p50": 0.0, "p95": 0.0, "n": 0}
    return {"p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)), "n": int(v.size)}


def compare_timing(group: str, metric: str, base_pcts: Mapping[str, float],
                   cur: np.ndarray, tol: Tolerance) -> MetricDiff:
    """One-sided percentile band: current median vs baseline median."""
    cur_p = timing_percentiles(cur)
    base_p50 = float(base_pcts.get("p50", 0.0))
    if base_p50 <= 0.0 or cur_p["n"] == 0:
        return MetricDiff(group, metric, True, "timing",
                          "no timing data; skipped")
    if base_p50 < tol.timing_floor_ms:
        return MetricDiff(
            group, metric, True, "timing",
            f"baseline p50 {base_p50:.4g}ms under "
            f"{tol.timing_floor_ms:g}ms floor; skipped")
    ratio = cur_p["p50"] / base_p50
    passed = ratio <= tol.timing_ratio
    detail = (f"p50 {cur_p['p50']:.4g}ms vs baseline {base_p50:.4g}ms "
              f"({ratio:.2f}x, limit {tol.timing_ratio:.1f}x)")
    return MetricDiff(group, metric, passed, "timing", detail,
                      max_rel_err=ratio)


# ---------------------------------------------------------------- baseline

def make_baseline(rows: Rows, *, meta: Optional[Mapping[str, Any]] = None,
                  group_keys: Sequence[str] = DEFAULT_GROUP_KEYS,
                  timing_key: str = DEFAULT_TIMING_KEY) -> Dict[str, Any]:
    """Golden baseline document: full series for trajectories, percentiles
    only for the (never byte-stable) timing metrics — ``timing_key`` plus
    every per-phase ``phase_*_ms`` column."""
    trajs = load_trajectories(rows, group_keys)
    series: Dict[str, Any] = {}
    for label in sorted(trajs):
        metrics = trajs[label]
        entry: Dict[str, Any] = {"metrics": {}, "timing": {}}
        for name in sorted(metrics):
            if is_timing_metric(name, timing_key):
                entry["timing"][name] = timing_percentiles(metrics[name])
            else:
                entry["metrics"][name] = [float(x) for x in metrics[name]]
        series[label] = entry
    return {"schema": BASELINE_SCHEMA, "meta": dict(meta or {}),
            "series": series}


def write_baseline(path: str, baseline: Mapping[str, Any]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(baseline, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    schema = doc.get("schema")
    if schema != BASELINE_SCHEMA:
        raise ValueError(f"unsupported baseline schema {schema!r} in {path} "
                         f"(expected {BASELINE_SCHEMA}); re-record")
    return doc


def compare_to_baseline(baseline: Mapping[str, Any], rows: Rows,
                        tol: Tolerance = Tolerance(), *,
                        include_timing: bool = True,
                        group_keys: Sequence[str] = DEFAULT_GROUP_KEYS,
                        timing_key: str = DEFAULT_TIMING_KEY,
                        ) -> List[MetricDiff]:
    """Diff a current run against a baseline document.

    Series/metrics present in the baseline but absent from the current run
    fail (a vanished curve is drift); metrics the current run added are
    reported as passing ``structure`` rows (new telemetry should not break
    the gate — re-record to start tracking it).
    """
    cur = load_trajectories(rows, group_keys)
    diffs: List[MetricDiff] = []
    base_series = baseline.get("series", {})

    for label in sorted(base_series):
        entry = base_series[label]
        if label not in cur:
            diffs.append(MetricDiff(label, "*", False, "structure",
                                    "series missing from current run"))
            continue
        cur_metrics = cur[label]
        for name in sorted(entry.get("metrics", {})):
            if name not in cur_metrics:
                diffs.append(MetricDiff(label, name, False, "structure",
                                        "metric missing from current run"))
                continue
            diffs.append(compare_trajectory(
                label, name, np.asarray(entry["metrics"][name]),
                cur_metrics[name], tol))
        if include_timing:
            for name, pcts in sorted(entry.get("timing", {}).items()):
                if name not in cur_metrics:
                    diffs.append(MetricDiff(label, name, False, "structure",
                                            "timing metric missing"))
                    continue
                diffs.append(compare_timing(label, name, pcts,
                                            cur_metrics[name], tol))
        known = set(entry.get("metrics", {})) | set(entry.get("timing", {}))
        for name in sorted(set(cur_metrics) - known):
            diffs.append(MetricDiff(label, name, True, "structure",
                                    "not in baseline (re-record to track)"))
    for label in sorted(set(cur) - set(base_series)):
        diffs.append(MetricDiff(label, "*", True, "structure",
                                "series not in baseline (re-record to track)"))
    return diffs


# ------------------------------------------------------------------ report

def format_report(diffs: Iterable[MetricDiff]) -> str:
    """Human-readable per-metric report (what CI prints on drift)."""
    diffs = list(diffs)
    lines = []
    n_fail = sum(not d.passed for d in diffs)
    for d in diffs:
        status = "ok " if d.passed else "DRIFT"
        stats = ""
        if d.kind == "trajectory" and not (d.detail and not d.passed
                                           and "mismatch" in d.detail):
            stats = (f" max_abs={d.max_abs_err:.3g}"
                     f" max_rel={d.max_rel_err:.3g}"
                     f" viol={d.violation_frac:.1%}")
        extra = f" [{d.detail}]" if d.detail else ""
        lines.append(f"{status} {d.group} :: {d.metric} ({d.kind}){stats}"
                     f"{extra}")
    lines.append(f"-- {len(diffs)} checks, {n_fail} drifted")
    return "\n".join(lines)


def report_json(diffs: Iterable[MetricDiff]) -> Dict[str, Any]:
    diffs = list(diffs)
    return {"passed": all(d.passed for d in diffs),
            "n_checks": len(diffs),
            "n_drifted": sum(not d.passed for d in diffs),
            "diffs": [d.to_json() for d in diffs]}
