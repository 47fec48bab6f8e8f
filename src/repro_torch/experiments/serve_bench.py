"""Serving golden-run benchmark: seeded traffic trace for regression: the
port of the JAX package's ``benchmarks/serve_bench.py``.

Runs the Poisson-arrival synthetic workload (``repro_torch.launch.serve``)
on the smoke model and rewrites its ``serve.step`` / ``serve.request``
telemetry into the golden-run JSONL dialect (``exp``/``variant``/``seed``
group keys, wall-clock counters stripped), as the JAX bench does:

    PYTHONPATH=src python -m repro_torch.experiments.serve_bench \\
        --device cpu --seed 0 --metrics-out experiments/torch_serve.jsonl

Everything left in the stream is deterministic for a given seed and
initial weights: queue depths, occupancy, admission counts, per-request
TTFT in scheduler steps, and the token-id checksums
(``token_sum``/``token_last``) that pin the greedy outputs.
``step_time_ms`` and the per-phase ``phase_*_ms`` columns stay and are
compared as one-sided percentile bands.  ``repro_torch.experiments.regress
--record/--check --exp serve`` drives it.  Runs on the CUDA card unless
asked for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional, Sequence

#: per-request counters that are pure wall clock, dropped from the golden
#: stream (TTFT survives as the deterministic ``ttft_steps``)
SERVE_VOLATILE_KEYS = ("ttft_ms", "e2e_ms", "decode_tokens_per_s")

DEFAULT_ARCH = "mamba2-780m"


def run_bench(metrics_out: str, seed: int = 0, n_requests: int = 8,
              arch: str = DEFAULT_ARCH, quiet: bool = True, device=None,
              init_fn: Optional[Callable[[int], dict]] = None) -> dict:
    """Run the seeded workload and write golden-dialect JSONL; returns the
    workload summary.  ``init_fn(seed)`` gives the initial weights (for
    example the JAX package's, as numpy); by default the port draws its
    own."""
    from repro_torch.launch.serve import run_traffic

    raw = metrics_out + ".raw"
    summary = run_traffic(arch=arch, smoke=True, n_requests=n_requests,
                          seed=seed, metrics_out=raw, quiet=quiet,
                          device=device, init_fn=init_fn)
    with open(raw) as src, open(metrics_out, "w") as dst:
        for line in src:
            rec = json.loads(line)
            if rec.get("name") == "serve.request":
                for k in SERVE_VOLATILE_KEYS:
                    rec.pop(k, None)
            rec.update(exp="serve", variant=f"{arch}-smoke", seed=seed)
            dst.write(json.dumps(rec) + "\n")
    os.remove(raw)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arch", default=DEFAULT_ARCH)
    ap.add_argument("--metrics-out", required=True,
                    help="golden-dialect JSONL output path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
    summary = run_bench(args.metrics_out, seed=args.seed,
                        n_requests=args.requests, arch=args.arch,
                        quiet=False, device=args.device)
    print(f"metrics -> {args.metrics_out}")
    return 0 if summary["n_requests"] == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
