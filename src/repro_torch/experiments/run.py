"""Benchmark harness, one entry per paper table/figure plus framework
extras: the port of the JAX package's ``benchmarks/run.py``.  Prints
``name,us_per_call,derived`` CSV rows, with the JAX harness's row names:

  exp1      -> paper Fig. 1 (left): ill-conditioned quadratic, 3 variants
  exp2      -> paper Fig. 1 (right): federated ANN, 5 optimizers
  kernels   -> the FrODO update kernels (``experiments.kernel_bench``)
  consensus -> per-step consensus cost for the mixing strategies
  ablations -> the exp-sum K arm of ``experiments.ablations``
  roofline  -> summarizes the port's dry-run records into roofline rows

    PYTHONPATH=src python -m repro_torch.experiments.run consensus \\
        --device cuda --metrics-out experiments/torch_bench.jsonl

``us_per_call`` is device time on the card (CUDA events for consensus,
``kernel_bench``'s device time for kernels) and the host clock on the CPU
or for a whole experiment run; each row's ``derived`` says which
(``clock=device|host``).  Full-protocol runs: the experiment modules
themselves (``repro_torch.experiments.exp1_quadratic`` and
``exp2_federated``); this harness uses the JAX harness's reduced sizes.
``--metrics-out PATH`` mirrors every row into PATH through
``obs.JsonlSink``; ``--seed N`` goes into every sub-benchmark.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device, set_full_precision


class Harness:
    """Where the rows go: stdout as CSV and, with a sink, one record each."""

    def __init__(self, sink: Optional[obs.MetricsSink] = None) -> None:
        self.sink = sink
        self.rows: list = []

    def row(self, name: str, us: float, derived: str) -> None:
        print(f"{name},{us:.1f},{derived}", flush=True)
        self.rows.append((name, us, derived))
        if self.sink is not None:
            self.sink.write({"name": name, "value": us, "derived": derived})


def bench_exp1(h: Harness, a) -> None:
    from repro_torch.experiments.exp1_quadratic import run_experiment
    t0 = time.perf_counter()
    s = run_experiment(n_sets=25, n_circle=25, seed=a.seed, out=None,
                       device=a.device)
    us = (time.perf_counter() - t0) * 1e6
    frac = s["fractional"]["circle_mean"]
    hb = s["heavy_ball"]["circle_mean"]
    nm = s["no_memory"]["circle_mean"]
    h.row("exp1_fractional_iters", us / 3, f"mean={frac:.0f},clock=host")
    h.row("exp1_heavy_ball_iters", us / 3, f"mean={hb:.0f},clock=host")
    h.row("exp1_no_memory_iters", us / 3, f"mean={nm:.0f},clock=host")
    h.row("exp1_speedup_vs_heavy_ball", 0.0, f"{hb / max(frac, 1):.2f}x")
    h.row("exp1_speedup_vs_no_memory", 0.0, f"{nm / max(frac, 1):.2f}x")
    p = s["ks_tests"]["one_sided_fractional<no_memory"]["p"]
    h.row("exp1_ks_frac_beats_no_memory", 0.0, f"p={p:.2e}")


def bench_exp2(h: Harness, a) -> None:
    from repro_torch.experiments.exp2_federated import run_experiment
    t0 = time.perf_counter()
    s = run_experiment(steps=200, n_seeds=2, out=None, seed=a.seed,
                       device=a.device)
    us = (time.perf_counter() - t0) * 1e6
    for m in ("frodo", "gd", "nesterov", "heavy_ball", "adam"):
        steps = s[m]["steps_to_gd_final"][0]
        h.row(f"exp2_{m}_steps_to_target", us / 5,
              f"steps={steps:.0f},final_acc={s[m]['final_acc_mean']:.3f},"
              "clock=host")
    h.row("exp2_speedup_vs_gd", 0.0, f"{s['speedup_vs_gd']:.2f}x")
    h.row("exp2_speedup_vs_heavy_ball", 0.0,
          f"{s['speedup_vs_heavy_ball']:.2f}x")


def bench_kernels(h: Harness, a) -> None:
    from repro_torch.experiments.kernel_bench import rows
    for r in rows(a.device, seed=a.seed):
        on_card = r["us_device"] is not None
        us = r["us_device"] if on_card else r["us_plain_host"]
        h.row(r["name"], us,
              f"bytes={r['kernel_bytes']},"
              f"{'kernel' if on_card else 'plain'},"
              f"clock={'device' if on_card else 'host'}")


def consensus_us(fn, dev, reps: int = 10) -> float:
    """Microseconds a call of ``fn`` after a warm-up: CUDA events around
    ``reps`` calls on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps * 1e3


def bench_consensus(h: Harness, a) -> None:
    from repro_torch.core import consensus as C
    from repro_torch.core import graph as G
    rng = np.random.default_rng(a.seed)
    clock = "device" if a.device.type == "cuda" else "host"
    for A in (8, 32):
        x = {"p": torch.as_tensor(rng.normal(size=(A, 1 << 16)),
                                  dtype=torch.float32, device=a.device)}
        for name, W in (
                ("uniform_complete", np.full((A, A), 1.0 / A)),
                ("xiao_boyd_ring", G.xiao_boyd_weights(
                    G.ring(A, directed=False)))):
            us = consensus_us(lambda W=W: C.mix_stacked(x, W), a.device)
            # per-device comm model: pmean O(n) vs gather O(A n)
            n_bytes = x["p"].numel() * 4
            comm = n_bytes * (2 if name.startswith("uniform") else 4)
            h.row(f"consensus_{name}_A{A}", us,
                  f"model_bytes={comm},clock={clock}")


def bench_ablations(h: Harness, a) -> None:
    # deterministic sweep: the seed is accepted for uniform dispatch
    from repro_torch.experiments.ablations import expsum_K
    rows = expsum_K(a.ablation_rounds, a.device)
    exact = rows.pop("exact_T90")
    h.row("ablation_exact_T90_iters", 0.0, f"iters={exact}")
    for k, v in rows.items():
        h.row(f"ablation_expsum_{k}", 0.0,
              f"iters={v['iters']},fit={v['fit_rel_l2']:.1e}")


def bench_roofline(h: Harness, a) -> None:
    # replays recorded records: the seed is accepted for uniform dispatch
    if not os.path.isdir(a.dryrun_dir):
        h.row("roofline", 0.0, "no dryrun records; run "
              "repro_torch.launch.dryrun")
        return
    from repro_torch.experiments.roofline import (load_records,
                                                  roofline_terms)
    ok = 0
    for r in load_records(a.dryrun_dir):
        t = roofline_terms(r)
        if not t:
            continue
        ok += 1
        h.row(f"roofline_{t['arch']}_{t['shape']}_{t['mesh']}",
              t["step_time_bound_s"] * 1e6,
              f"dom={t['dominant']},mfu_bound={t['mfu_bound']:.2f}")
    h.row("roofline_pairs_analyzed", 0.0, f"count={ok}")


BENCHES = {"exp1": bench_exp1, "exp2": bench_exp2,
           "kernels": bench_kernels, "consensus": bench_consensus,
           "roofline": bench_roofline, "ablations": bench_ablations}


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("which", nargs="*", choices=[[], *BENCHES],
                    help="benchmarks to run (default: all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed threaded into every sub-benchmark")
    ap.add_argument("--metrics-out", "--jsonl", dest="metrics_out",
                    default=None, metavar="PATH",
                    help="mirror rows into PATH via obs.JsonlSink")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ablation-rounds", type=int, default=4000,
                    help="rounds of the ablations row's runs")
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch",
                    help="the dry-run records the roofline rows read")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    set_full_precision()
    which = args.which or ["kernels", "consensus", "exp1", "exp2",
                           "ablations", "roofline"]
    sink = obs.JsonlSink(args.metrics_out) if args.metrics_out else None
    h = Harness(sink)
    print("name,us_per_call,derived")
    try:
        for w in which:
            BENCHES[w](h, args)
    finally:
        if sink is not None:
            sink.close()
    return h.rows


if __name__ == "__main__":
    main()
