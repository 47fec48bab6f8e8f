"""repro_torch.obs.regress against repro.obs.regress: the same baseline
document and the same verdicts, row for row, on the same JSONL (both plain
numpy; every value equal)."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.obs import regress as JR  # noqa: E402
from repro_torch.obs import regress as TR  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(seed, scale=1.0, drop_metric=None, extra_series=False):
    rng = np.random.default_rng(seed)
    rows = []
    for variant in ("fractional", "no_memory"):
        for s in range(40):
            r = {"exp": "exp1_quadratic", "variant": variant, "step": s,
                 "error": float(scale * 0.9 ** s),
                 "grad_norm": float(1 + rng.normal() * 0.01),
                 "converged": s > 30,
                 "step_time_ms": float(0.2 + 0.01 * rng.random()),
                 "phase_mix_ms": float(0.01 * rng.random())}
            if drop_metric:
                r.pop(drop_metric)
            rows.append(r)
    if extra_series:
        rows.append({"exp": "exp1_quadratic", "variant": "new", "step": 0,
                     "error": 1.0})
    return rows


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write('{"torn": \n')                   # a run killed mid-write
    return str(path)


def test_baselines_are_equal(tmp_path):
    path = _write(tmp_path / "a.jsonl", _rows(0))
    meta = {"exp": "exp1", "seed": 0}
    jb, tb = JR.make_baseline(path, meta=meta), TR.make_baseline(path,
                                                                 meta=meta)
    assert jb == tb
    assert json.dumps(jb, sort_keys=True) == json.dumps(tb, sort_keys=True)
    p = TR.write_baseline(str(tmp_path / "b" / "base.json"), tb)
    assert TR.load_baseline(p) == JR.load_baseline(p) == jb
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99}))
    with pytest.raises(ValueError, match="schema"):
        TR.load_baseline(str(bad))


@pytest.mark.parametrize("current", [
    dict(seed=0), dict(seed=1, scale=1.03), dict(seed=2, scale=1.5),
    dict(seed=0, drop_metric="grad_norm"), dict(seed=0, extra_series=True)])
@pytest.mark.parametrize("include_timing", [False, True])
def test_verdicts_are_equal(tmp_path, current, include_timing):
    base = JR.make_baseline(_write(tmp_path / "base.jsonl", _rows(0)))
    rows = _rows(**current)
    for tol in (dict(), dict(rtol=0.01, timing_ratio=0.5)):
        jd = JR.compare_to_baseline(base, rows, JR.Tolerance(**tol),
                                    include_timing=include_timing)
        td = TR.compare_to_baseline(base, rows, TR.Tolerance(**tol),
                                    include_timing=include_timing)
        assert [d.to_json() for d in td] == [d.to_json() for d in jd]
        assert TR.format_report(td) == JR.format_report(jd)
        assert TR.report_json(td) == JR.report_json(jd)


def test_committed_baselines_load_alike():
    for name in ("exp1", "exp3"):
        path = os.path.join(ROOT, "benchmarks", "baselines", f"{name}.json")
        assert TR.load_baseline(path) == JR.load_baseline(path)


def test_tolerance_validation_matches():
    for kw in (dict(rtol=-1), dict(max_violation_frac=2),
               dict(timing_ratio=0), dict(timing_floor_ms=-1)):
        with pytest.raises(ValueError):
            TR.Tolerance(**kw)
        with pytest.raises(ValueError):
            JR.Tolerance(**kw)
    assert TR.is_timing_metric("phase_x_ms") and TR.is_timing_metric(
        "step_time_ms") and not TR.is_timing_metric("error")
