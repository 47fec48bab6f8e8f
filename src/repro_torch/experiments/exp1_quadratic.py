"""Experiment 1 — objective with an ill-conditioned Hessian (paper §3.1,
Fig. 1 left), on the port.

Four agents with the paper's objectives f_i = 0.5 (x1 - a_i)^2 +
0.005 (x2 - b_i)^2 (Hessian ~ diag(2, 0.04) summed, condition number ~100),
complete graph with Xiao-Boyd weights.  Protocol (paper): 100
hyperparameter sets with alpha ~ U[0.6, 1], beta ~ U[alpha/2.5, alpha/1.5],
lambda ~ U[0.1, 0.2], T ~ U{80..100}; starts (1,0), (0.86,0.5), (0.5,0.86),
(0,1); variants Fractional / HeavyBall (T=1) / NoMemory (beta=0); plus
uniformly sampled unit-circle starts, with two-sided and one-sided
Kolmogorov-Smirnov tests.

This mirrors the JAX script ``benchmarks/exp1_quadratic.py``: the same
hyperparameter draws, starts, iteration counts, summary keys, KS tests and
telemetry records.  The JAX script's ``vmap`` over hyperparameter sets is a
leading batch dimension B here: per-set weights ``w[b, n] = n^(lambda_b-1)``
zeroed for n > T_b over ``T_PAD`` slots, one slot-weight rotation shared by
the batch.  The memory term, the mixing ``W @ xs`` and the norms are f32
products summed in a fixed order of elementwise adds (``_fsum``), so the
card and the CPU give the same bits and the same iteration counts.  The
whole sweep, every start and variant, is one batch.  It stays plain
PyTorch, as the JAX script keeps it out of Pallas: each set has its own
alpha, beta and weights, which the fused exact kernel (one mu, scalar alpha
and beta) does not take.

    python -m repro_torch.experiments.exp1_quadratic --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from scipy import stats

from repro_torch.core import graph as G
from repro_torch.device import Device, resolve_device, set_full_precision
from repro_torch.obs import metrics as obs

T_PAD = 100
K_MAX = 5000
TOL = 1e-6
N_AGENTS = 4
#: agent i's minimum (a_i, b_i); its gradient is (x1 - a_i, 0.01 (x2 - b_i))
CENTERS = ((2.0, 0.0), (-2.0, 0.0), (0.0, 2.0), (0.0, -2.0))
VARIANTS = ("fractional", "heavy_ball", "no_memory")
NAMED_STARTS = {"steepest(1,0)": (1.0, 0.0), "(0.86,0.5)": (0.86, 0.5),
                "(0.5,0.86)": (0.5, 0.86), "flattest(0,1)": (0.0, 1.0)}
TELEMETRY = ("consensus_error", "consensus_error_pre_mix", "memory_norm",
             "grad_norm", "error")


def objective(x: torch.Tensor, i: int) -> torch.Tensor:
    """Agent i's f_i at x (2,), for ``core.loop.run``."""
    a, b = CENTERS[i]
    return 0.5 * (x[0] - a) ** 2 + 0.005 * (x[1] - b) ** 2


def _fsum(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by repeated halving.  Elementwise adds round the
    same on every device, where a library reduction (``sum``, ``bmm``)
    picks its own order: so the sweep gives the same bits on the card and
    on the CPU."""
    while p.shape[dim] > 1:
        n = p.shape[dim]
        h = n // 2
        s = p.narrow(dim, 0, h) + p.narrow(dim, h, h)
        if n % 2:
            s.narrow(dim, 0, 1).add_(p.narrow(dim, n - 1, 1))
        p = s
    return p.squeeze(dim)


def _norm(v: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sqrt(_fsum(torch.square(v), dim))


def _consensus_error(z: torch.Tensor) -> torch.Tensor:
    """(B, A, n) -> (B,) RMS per-agent disagreement."""
    A = z.shape[1]
    d = z - (_fsum(z, 1) / A)[:, None]
    return torch.sqrt(_fsum(_fsum(torch.square(d), -1), -1) / A)


def _algorithm1(x0s, alphas, betas, lams, Ts, steps: int, device,
                telemetry: bool = False):
    """B independent runs of Algorithm 1, one per row of the (B,) numpy
    inputs (x0s: (B, 2)), on ``device``.  Returns the per-round mean
    distance to x* = 0 as a (steps, B) tensor, or with ``telemetry`` a dict
    of (steps, B) tensors keyed by ``TELEMETRY``.

    Every sum is a product then an ``_fsum``, and the weights are computed
    on the host, so a run gives the same bits on any device."""
    f32 = dict(dtype=torch.float32, device=device)
    x0s, alphas, betas, lams, Ts = (np.asarray(v, np.float32) for v in (
        x0s, alphas, betas, lams, Ts))
    B = x0s.shape[0]
    W = torch.as_tensor(G.xiao_boyd_weights(G.complete(N_AGENTS)), **f32)
    c = torch.tensor(CENTERS, **f32)
    s = torch.tensor([1.0, 0.01], **f32)
    n = np.arange(1, T_PAD + 1, dtype=np.float32)
    w = np.where(n[None] <= Ts[:, None],
                 n[None] ** (lams[:, None] - np.float32(1.0)),
                 np.float32(0.0))
    # slot s of the history holds g^(k-n), n = (cursor - s) mod T_PAD (0 read
    # as T_PAD): its weights are roll(flip(w), cursor), as in
    # core.memory.slot_weights
    w_rev = torch.as_tensor(np.ascontiguousarray(w[:, ::-1]), **f32)
    a = torch.as_tensor(alphas, **f32)[:, None, None]
    b = torch.as_tensor(betas, **f32)[:, None, None]
    xs = torch.as_tensor(x0s, **f32)[:, None, :].repeat(1, N_AGENTS, 1)
    hist = torch.zeros((B, T_PAD, N_AGENTS, 2), **f32)
    names = TELEMETRY if telemetry else ("error",)
    out = {k: torch.empty((steps, B), **f32) for k in names}
    for k in range(steps):
        g = (xs - c) * s
        cursor = (k - 1) % T_PAD
        w_slot = torch.roll(w_rev, cursor, dims=1)
        M = _fsum(w_slot[:, :, None, None] * hist, 1)      # (B, A, 2)
        if k > 0:
            xs = xs - a * g - b * M
            hist[:, cursor] = g
        if telemetry:
            out["consensus_error_pre_mix"][k] = _consensus_error(xs)
        xs = _fsum(W[None, :, :, None] * xs[:, None], 2)  # W @ xs
        out["error"][k] = _fsum(_norm(xs, -1), -1) / N_AGENTS
        if telemetry:
            out["consensus_error"][k] = _consensus_error(xs)
            out["memory_norm"][k] = _norm(M.reshape(B, -1), -1)
            out["grad_norm"][k] = _norm(g.reshape(B, -1), -1)
    return out if telemetry else out["error"]


def run_batch(x0s, alphas, betas, lams, Ts, device: Device = None
              ) -> np.ndarray:
    """The sweep over a batch: every argument has leading dim B (x0s
    (B, 2)); returns iterations to ``TOL`` (B,) ints, ``K_MAX`` where a
    run never gets there."""
    dev = resolve_device(device)
    errs = _algorithm1(x0s, alphas, betas, lams, Ts, K_MAX, dev)
    below = errs < TOL
    hit = torch.argmax(below.to(torch.uint8), dim=0)    # first True
    return torch.where(below.any(dim=0), hit,
                       torch.full_like(hit, K_MAX)).cpu().numpy()


def telemetry_trace(x0, alpha, beta, lam, T, steps: int,
                    device: Device = None) -> Dict[str, np.ndarray]:
    """One run of Algorithm 1 with the per-step diagnostics pack: consensus
    error (after and before mixing), ||M||, ||g|| and the distance to the
    optimum, each (steps,)."""
    dev = resolve_device(device)
    mets = _algorithm1([x0], [alpha], [beta], [lam], [T], steps, dev,
                       telemetry=True)
    return {k: v[:, 0].cpu().numpy() for k, v in mets.items()}


def write_metrics_jsonl(path, steps=600, x0=(1.0, 0.0),
                        alpha=0.8, beta=0.35, lam=0.15, T=90.0,
                        device: Device = None):
    """Run the three variants at one representative hyperparameter point and
    stream per-step telemetry to JSONL.  ``step_time_ms`` is the host
    clock over a second, warm run (ended by the copy to the host), per
    step."""
    dev = resolve_device(device)
    with obs.JsonlSink(path) as sink:
        for v in VARIANTS:
            va, vb, vl, vt = variant_params(
                v, np.float32(alpha), np.float32(beta), np.float32(lam),
                np.float32(T))
            telemetry_trace(x0, va, vb, vl, vt, steps, dev)       # warm-up
            t0 = time.perf_counter()
            host = telemetry_trace(x0, va, vb, vl, vt, steps, dev)
            ms_per_step = (time.perf_counter() - t0) * 1e3 / steps
            for s in range(steps):
                sink.write({"exp": "exp1_quadratic", "variant": v,
                            "step": s,
                            "step_time_ms": round(ms_per_step, 6),
                            **{k: float(a[s]) for k, a in host.items()}})
    return path


def variant_params(variant, alpha, beta, lam, T):
    if variant == "fractional":
        return alpha, beta, lam, T
    if variant == "heavy_ball":
        return alpha, beta, np.full_like(lam, 0.5), np.ones_like(T)
    return alpha, np.zeros_like(beta), lam, np.ones_like(T)  # no_memory


def sample_hparams(n, seed):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.6, 1.0, n).astype(np.float32)
    beta = np.asarray([rng.uniform(a / 2.5, a / 1.5) for a in alpha],
                      np.float32)
    lam = rng.uniform(0.1, 0.2, n).astype(np.float32)
    T = rng.integers(80, 101, n).astype(np.float32)
    return alpha, beta, lam, T


def sweep(n_sets=100, n_circle=50, seed=0, device: Device = None) -> dict:
    """Iterations to tolerance of every variant, from the named starts (each
    against every set) and the unit-circle starts (start j with set
    j mod n_sets): ``{variant: {"named": {start: (n_sets,)}, "circle":
    (n_circle,)}}``.  All of it runs as one batch."""
    alpha, beta, lam, T = sample_hparams(n_sets, seed)
    rng = np.random.default_rng(seed + 1)
    angles = rng.uniform(0, 2 * np.pi, n_circle)
    circle = np.stack([np.cos(angles), np.sin(angles)], -1).astype(np.float32)
    idx = np.arange(n_circle) % n_sets

    cols = [[], [], [], [], []]            # x0s, alphas, betas, lams, Ts
    for v in VARIANTS:
        va, vb, vl, vt = variant_params(v, alpha, beta, lam, T)
        for st in NAMED_STARTS.values():
            for col, x in zip(cols, (np.tile(np.asarray(st, np.float32),
                                             (n_sets, 1)), va, vb, vl, vt)):
                col.append(x)
        for col, x in zip(cols, (circle, va[idx], vb[idx], vl[idx],
                                 vt[idx])):
            col.append(x)
    iters = run_batch(*(np.concatenate(c) for c in cols), device=device)

    results, i = {}, 0
    for v in VARIANTS:
        named = {}
        for name in NAMED_STARTS:
            named[name] = iters[i:i + n_sets]
            i += n_sets
        results[v] = {"named": named, "circle": iters[i:i + n_circle]}
        i += n_circle
    return results


def summarize(results: dict) -> dict:
    """The JAX script's summary of a ``sweep``: per-variant means and
    spreads, the KS tests and the steep/flat ratios."""
    summary = {}
    for v, r in results.items():
        summary[v] = {
            "named_mean_std": {k: (float(x.mean()), float(x.std()))
                               for k, x in r["named"].items()},
            "circle_mean": float(r["circle"].mean()),
            "circle_std": float(r["circle"].std()),
        }

    ks = {}
    for v, r in results.items():
        st = stats.ks_2samp(r["named"]["steepest(1,0)"],
                            r["named"]["flattest(0,1)"])
        ks[f"two_sided_steep_vs_flat[{v}]"] = {
            "stat": float(st.statistic), "p": float(st.pvalue)}
    for other in ("heavy_ball", "no_memory"):
        # H1: fractional iteration counts are stochastically SMALLER, i.e.
        # its CDF dominates -> scipy alternative="greater"
        st = stats.ks_2samp(results["fractional"]["circle"],
                            results[other]["circle"], alternative="greater")
        ks[f"one_sided_fractional<{other}"] = {
            "stat": float(st.statistic), "p": float(st.pvalue)}
    summary["ks_tests"] = ks
    # stability metric: how much harder is the flattest start than the
    # steepest (paper: fractional is 'consistent'; we report the ratio)
    summary["steep_flat_ratio"] = {
        v: float(np.mean(r["named"]["flattest(0,1)"])
                 / max(np.mean(r["named"]["steepest(1,0)"]), 1))
        for v, r in results.items()}
    return summary


def run_experiment(n_sets=100, n_circle=50, seed=0, out=None,
                   metrics_out=None, metrics_steps=600,
                   device: Device = None):
    dev = resolve_device(device)
    set_full_precision()
    if metrics_out:
        write_metrics_jsonl(metrics_out, steps=metrics_steps, device=dev)
    summary = summarize(sweep(n_sets, n_circle, seed, dev))
    summary["device"] = str(dev)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=100)
    ap.add_argument("--circle", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for the hyperparameter sweep and circle "
                         "starts; same seed -> identical JSONL (mod timing)")
    ap.add_argument("--out", default="experiments/torch_exp1_quadratic.json")
    ap.add_argument("--metrics-out",
                    default="experiments/torch_exp1_metrics.jsonl",
                    help="per-step telemetry JSONL ('' disables)")
    ap.add_argument("--metrics-steps", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on purpose only)")
    args = ap.parse_args(argv)
    print(json.dumps(run_experiment(args.sets, args.circle, seed=args.seed,
                                    out=args.out,
                                    metrics_out=args.metrics_out or None,
                                    metrics_steps=args.metrics_steps,
                                    device=args.device),
                     indent=1))


if __name__ == "__main__":
    main()
