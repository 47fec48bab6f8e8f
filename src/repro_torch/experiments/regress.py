"""Golden-run trajectory regression CLI (library: ``repro_torch.obs.
regress``): the port of the JAX package's ``benchmarks/regress.py``.

Records seeded, reduced-scale runs of the paper experiments, the trainer
and the serving trace as baselines, then diffs later runs against them:

    PYTHONPATH=src python -m repro_torch.experiments.regress --check \\
        --exp exp1 --device cpu
    PYTHONPATH=src python -m repro_torch.experiments.regress --record \\
        --exp exp2 --baseline-dir experiments/baselines_torch --device cuda

``--check`` replays each experiment with the seed/steps stored in the
baseline's ``meta`` block (CLI flags override) and compares against the
committed ``benchmarks/baselines/`` by default.  Convergence trajectories
are compared pointwise with relative+absolute tolerances; ``step_time_ms``
and the ``phase_*_ms`` columns get a one-sided percentile band
(``--timing-ratio``; ``--no-timing`` skips it: the committed bands are the
JAX package's times on a CPU, which say nothing about the port).

The runners are the port's experiment modules
(``experiments.exp1_quadratic``, ``exp2_federated``, ``exp3_faults``,
``launch.train``, ``experiments.serve_bench``); each takes ``device`` and
an optional ``init_fn(seed)`` of initial weights.  The committed exp2,
exp3 (its ``federated-*`` series), train and serve baselines were
recorded from the JAX package's initial weights (its non-partitionable
threefry draw), which the port's own draw cannot reproduce: they pass
with those weights passed in (the tests do, under ``-m regression``), and
a run on the port's own weights is held against a baseline it recorded
itself.  ``--record``
therefore needs a ``--baseline-dir`` of its own: the committed baselines
belong to the JAX package and are only read here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.device import resolve_device
from repro_torch.obs import regress as R
from repro_torch.obs.metrics import read_jsonl

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_BASELINE_DIR = os.path.join(ROOT, "benchmarks", "baselines")

# reduced-scale defaults: small enough for CI, long enough that the
# convergence dynamics (memory ramp-up over T steps, consensus decay) show
DEFAULT_STEPS = {"exp1": 150, "exp2": 40, "exp3": 400, "train": 12,
                 "serve": 8}

#: trainer sink counters that are pure wall-clock (monotone / machine
#: dependent), dropped from the train baseline; step_time_ms and the
#: per-phase phase_*_ms columns stay and are compared as percentile bands
TRAIN_VOLATILE_KEYS = ("wall_s", "throughput_items_per_s",
                       "throughput_items_per_s_instant")

InitFn = Optional[Callable[[int], Any]]


def run_exp1(jsonl_path: str, seed: int, steps: int, device=None,
             init_fn: InitFn = None) -> None:
    from repro_torch.experiments.exp1_quadratic import write_metrics_jsonl
    del seed, init_fn  # exp1 telemetry is a fixed representative point
    write_metrics_jsonl(jsonl_path, steps=steps, device=device)


def run_exp2(jsonl_path: str, seed: int, steps: int, device=None,
             init_fn: InitFn = None) -> dict:
    from repro_torch.experiments.exp2_federated import run_experiment
    return run_experiment(steps=steps, n_seeds=1, out=None,
                          metrics_out=jsonl_path, seed=seed, device=device,
                          init_fn=init_fn)


def run_exp3(jsonl_path: str, seed: int, steps: int, device=None,
             init_fn: InitFn = None) -> dict:
    """Fault-injection sweep at reduced scale: ``steps`` drives the
    quadratic arm; the federated arm and the recorded trajectory window
    scale down with it."""
    from repro_torch.experiments.exp3_faults import run_experiment
    return run_experiment(seed=seed, quad_steps=steps,
                          fed_steps=max(steps // 8, 10), out=None,
                          metrics_out=jsonl_path,
                          metrics_steps=min(steps, 60), device=device,
                          init_fn=init_fn)


def run_train(jsonl_path: str, seed: int, steps: int, device=None,
              init_fn: InitFn = None) -> None:
    """Smoke-scale ``launch.train --metrics-out`` golden run, the stream
    rewritten: volatile counters out, series identity in."""
    from repro_torch.launch.train import run_training
    raw = jsonl_path + ".raw"
    with tempfile.TemporaryDirectory() as ckpt:
        run_training(arch="h2o-danube-1.8b", smoke=True, steps=steps,
                     agents=2, metrics_out=raw, collect_metrics=True,
                     seed=seed, device=device, ckpt_dir=ckpt,
                     init_fn=init_fn)
    with open(raw) as src, open(jsonl_path, "w") as dst:
        for line in src:
            rec = json.loads(line)
            for k in TRAIN_VOLATILE_KEYS:
                rec.pop(k, None)
            rec.update(exp="launch_train", name="h2o-danube-1.8b-smoke",
                       seed=seed)
            dst.write(json.dumps(rec) + "\n")
    os.remove(raw)


def run_serve(jsonl_path: str, seed: int, steps: int, device=None,
              init_fn: InitFn = None) -> dict:
    """Seeded Poisson-arrival serving trace (``experiments.serve_bench``):
    ``steps`` is the number of synthetic requests."""
    from repro_torch.experiments.serve_bench import run_bench
    return run_bench(jsonl_path, seed=seed, n_requests=steps, device=device,
                     init_fn=init_fn)


RUNNERS = {"exp1": run_exp1, "exp2": run_exp2, "exp3": run_exp3,
           "train": run_train, "serve": run_serve}


class Diffs(List[R.MetricDiff]):
    """``check``'s result: the per-metric diffs, with the replayed run's
    summary (its runner's return value) in ``summary``."""

    summary: Any = None


def baseline_path(baseline_dir: str, exp: str) -> str:
    return os.path.join(baseline_dir, f"{exp}.json")


def record(exp: str, baseline_dir: str, seed: int, steps: int,
           device=None, init_fn: InitFn = None) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, f"{exp}.jsonl")
        RUNNERS[exp](jsonl, seed=seed, steps=steps, device=device,
                     init_fn=init_fn)
        base = R.make_baseline(jsonl, meta={"exp": exp, "seed": seed,
                                            "steps": steps})
    return R.write_baseline(baseline_path(baseline_dir, exp), base)


def check(exp: str, baseline_dir: str, tol: R.Tolerance,
          seed: Optional[int], steps: Optional[int], include_timing: bool,
          keep: Optional[Callable[[str], bool]] = None, device=None,
          init_fn: InitFn = None) -> Diffs:
    """Replay ``exp`` and diff it against its baseline; with ``keep``,
    only the series whose label ``keep`` accepts, in both."""
    path = baseline_path(baseline_dir, exp)
    if not os.path.exists(path):
        return Diffs([R.MetricDiff(f"exp={exp}", "*", False, "structure",
                                   f"no baseline at {path}; run --record "
                                   "first")])
    base = R.load_baseline(path)
    meta = base.get("meta", {})
    seed = meta.get("seed", 0) if seed is None else seed
    steps = meta.get("steps", DEFAULT_STEPS[exp]) if steps is None else steps
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, f"{exp}.jsonl")
        summary = RUNNERS[exp](jsonl, seed=seed, steps=steps, device=device,
                               init_fn=init_fn)
        rows = read_jsonl(jsonl)
    if keep is not None:
        base["series"] = {k: v for k, v in base["series"].items() if keep(k)}
        rows = [r for r in rows if keep(R.group_label(r))]
    diffs = Diffs(R.compare_to_baseline(base, rows, tol,
                                        include_timing=include_timing))
    diffs.summary = summary
    return diffs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--record", action="store_true",
                      help="write fresh baselines into --baseline-dir")
    mode.add_argument("--check", action="store_true",
                      help="diff against baselines; exit 1 on drift")
    ap.add_argument("--exp", nargs="+", choices=sorted(RUNNERS),
                    default=sorted(RUNNERS), help="experiments to cover")
    ap.add_argument("--baseline-dir", default=DEFAULT_BASELINE_DIR)
    ap.add_argument("--seed", type=int, default=None,
                    help="base seed (default: 0 on record, baseline meta "
                         "on check)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per experiment (default: reduced-scale "
                         "presets on record, baseline meta on check)")
    ap.add_argument("--rtol", type=float, default=0.05,
                    help="pointwise relative tolerance on trajectories")
    ap.add_argument("--atol", type=float, default=1e-6,
                    help="absolute floor for decayed-to-noise metrics")
    ap.add_argument("--max-violation-frac", type=float, default=0.02,
                    help="fraction of points allowed outside tolerance")
    ap.add_argument("--timing-ratio", type=float, default=10.0,
                    help="fail when a timing metric's p50 (step_time_ms "
                         "or any phase_*_ms) exceeds baseline p50 by this "
                         "factor")
    ap.add_argument("--no-timing", action="store_true",
                    help="skip the step_time_ms band (trajectories only)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="also write the per-metric report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.record:
        if os.path.realpath(args.baseline_dir) == os.path.realpath(
                DEFAULT_BASELINE_DIR):
            ap.error("--record needs a --baseline-dir of its own: the "
                     "committed benchmarks/baselines/ are the JAX "
                     "package's")
        seed = 0 if args.seed is None else args.seed
        for exp in args.exp:
            steps = args.steps or DEFAULT_STEPS[exp]
            path = record(exp, args.baseline_dir, seed, steps, device=dev)
            print(f"recorded {exp} baseline (seed={seed}, steps={steps}) "
                  f"-> {path}")
        return 0

    tol = R.Tolerance(rtol=args.rtol, atol=args.atol,
                      max_violation_frac=args.max_violation_frac,
                      timing_ratio=args.timing_ratio)
    diffs: List[R.MetricDiff] = []
    for exp in args.exp:
        diffs += check(exp, args.baseline_dir, tol, args.seed, args.steps,
                       include_timing=not args.no_timing, device=dev)
    print(R.format_report(diffs))
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(R.report_json(diffs), f, indent=1)
        print(f"report -> {args.report}")
    return 0 if all(d.passed for d in diffs) else 1


if __name__ == "__main__":
    sys.exit(main())
