"""Experiment 3 — robustness under faults (beyond-paper), on the port.

Per-step link drops at 10/30/50% (plus the healthy control arm), directed
or symmetric, on

* the paper's Exp-1 ill-conditioned quadratic (4 agents, complete graph,
  Xiao-Boyd weights, x* = 0), run through ``core.loop.run`` with
  ``faults=``, and
* a reduced federated classification task (4 agents, a 784-64-10 MLP on the
  synthetic MNIST stand-in, batch 32) with fault-masked consensus
  (``consensus.mix_time_varying``) every step.  As in the JAX script, its
  update mask is not applied (the drop schedules have no stragglers).

FrODO (exact memory, T = 90) goes through the fused update kernel
(``use_kernel=True``; its plain version on the CPU).

This mirrors the JAX script ``benchmarks/exp3_faults.py``: the same fault
schedules (bit-equal compiled arrays), data, batch order, hyperparameters,
summary keys and JSONL records.  The federated arm's initial weights come
from a ``torch.Generator`` seeded from ``--seed`` (``jax.random`` draws
cannot be reproduced); ``run_experiment`` also takes ``init_fn(seed)``
returning numpy weights, e.g. exported from the JAX script.

Headline check (the robustness claim FrODO's memory buys): under 30% link
drop, FrODO reaches the target error in a fraction of the steps DGD needs —
``summary["quadratic"]["drop30"]["dgd_over_frodo_iters"]``.

    python -m repro_torch.experiments.exp3_faults --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import consensus as C
from repro_torch.core import graph as G
from repro_torch.core import loop
from repro_torch.core.baselines import REGISTRY
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.frodo import FrodoConfig, apply_updates, frodo
from repro_torch.data.synthetic import make_classification
from repro_torch.device import Device, resolve_device, set_full_precision
from repro_torch.experiments.exp1_quadratic import objective as quad_objective
from repro_torch.experiments.exp2_federated import init_mlp, mlp_loss
from repro_torch.obs import metrics as obs

N_AGENTS = 4
DROP_RATES = (0.1, 0.3, 0.5)
#: target mean distance to x* = 0 (coarse on purpose: directed drops make
#: every method floor around 1e-3..1e-2 at 30-50% drop; docs/robustness.md)
QUAD_TOL = 0.1
METHODS = ("frodo", "heavy_ball", "gd")

# Exp-1 representative hyperparameters (paper §3.1 sweep midpoint)
ALPHA, BETA, LAM, T_MEM = 0.8, 0.35, 0.15, 90

FED_DIM, FED_CLASSES, FED_HIDDEN, FED_BATCH = 784, 10, 64, 32
FED_SIZES = (FED_DIM, FED_HIDDEN, FED_CLASSES)
FAULT_KEYS = ("faults_links_dropped", "faults_agents_isolated",
              "faults_staleness_max")


def make_opt(method: str, scale: float = 1.0, use_kernel: bool = True):
    a, b = ALPHA * scale, BETA * scale
    if method == "frodo":
        return frodo(FrodoConfig(alpha=a, beta=b, lam=LAM, T=T_MEM,
                                 use_kernel=use_kernel))
    if method == "heavy_ball":
        return REGISTRY["heavy_ball"](alpha=a, beta=b)
    if method == "gd":
        return REGISTRY["no_memory"](alpha=a)
    raise ValueError(method)


def compiled_schedule(drop: float, K: int, seed: int,
                      drop_mode: str = "directed"):
    """Seeded link-drop schedule against the Exp-1 graph (drop=0 keeps the
    healthy W every step: the control arm)."""
    sched = FaultSchedule(link_drop=drop, seed=seed, drop_mode=drop_mode)
    return sched.compile(G.complete(N_AGENTS), K,
                         weight_fn=G.xiao_boyd_weights)


# ------------------------------------------------------------- quadratic

def run_quadratic(method: str, drop: float, K: int, seed: int,
                  collect_metrics: bool = False,
                  drop_mode: str = "directed", device: Device = None,
                  use_kernel: bool = True) -> dict:
    """Start along the flat axis (curvature 0.01), where plain DGD crawls
    and the fractional memory accelerates."""
    dev = resolve_device(device)
    x0 = torch.tensor([0.0, 1.0], device=dev).repeat(N_AGENTS, 1)
    faults = compiled_schedule(drop, K, seed, drop_mode)
    res = loop.run(quad_objective, x0, make_opt(method, use_kernel=use_kernel),
                   None, K, x_star=np.zeros(2, np.float32), faults=faults,
                   collect_metrics=collect_metrics)
    res["jitter_ms"] = faults.jitter_ms[np.arange(K) % faults.n_steps]
    return res


def iters_to_tol(errors: np.ndarray, tol: float = QUAD_TOL) -> int:
    hit = np.nonzero(errors < tol)[0]
    return int(hit[0]) if hit.size else len(errors)


# ------------------------------------------------------------- federated

def run_federated(method: str, drop: float, steps: int, seed: int,
                  drop_mode: str = "directed", device: Device = None,
                  init: Optional[Any] = None,
                  use_kernel: bool = True) -> dict:
    """Per-step fault-masked consensus on the synthetic 10-class problem.
    Returns per-step loss/acc, the consensus-error and the fault traces
    (numpy).  ``init``: numpy agent-stacked initial weights; by default they
    are drawn from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    X, y = make_classification(n_per_class=50, n_agents=N_AGENTS, seed=seed,
                               noise=2.0)
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, dtype=torch.int64, device=dev)
    faults = compiled_schedule(drop, steps, seed, drop_mode)
    W_seq = torch.as_tensor(faults.W_seq, dtype=torch.float32, device=dev)
    opt = make_opt(method, scale=0.0625, use_kernel=use_kernel)
    params = (init_mlp(torch.Generator().manual_seed(seed), N_AGENTS,
                       FED_SIZES, dev) if init is None
              else convert.params_from_numpy(init, dev))
    opt_state = opt.init(params)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 99]))
    idx = torch.as_tensor(rng.integers(0, y.shape[1],
                                       size=(steps, N_AGENTS, FED_BATCH)),
                          dtype=torch.int64, device=dev)
    keys = sorted(params)
    mets = {k: [] for k in ("loss", "acc", "consensus_error",
                            "consensus_error_pre_mix")}
    for k in range(steps):
        xb = torch.take_along_dim(Xd, idx[k][..., None], dim=1)
        yb = torch.take_along_dim(yd, idx[k], dim=1)
        leaves = {n: params[n].detach().requires_grad_(True) for n in keys}
        loss, acc = mlp_loss(leaves, xb, yb)
        # the agents' losses are independent: the gradient of their sum is
        # each agent's own gradient
        grads = dict(zip(keys, torch.autograd.grad(
            loss.sum(), [leaves[n] for n in keys])))
        delta, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, delta)
        params, caux = C.mix_time_varying(params, W_seq, k,
                                          with_metrics=True)
        mets["loss"].append(loss.detach().mean())
        mets["acc"].append(acc.mean())
        mets["consensus_error"].append(caux["consensus_error_post"])
        mets["consensus_error_pre_mix"].append(caux["consensus_error_pre"])
    out = {k: torch.stack(v).cpu().numpy() for k, v in mets.items()}
    idx_k = np.arange(steps) % faults.n_steps
    out.update({k: v[idx_k] for k, v in faults.counter_arrays().items()})
    out["jitter_ms"] = faults.jitter_ms[idx_k]
    return out


def steps_to_loss(losses: np.ndarray, target: float) -> int:
    hit = np.nonzero(losses <= target)[0]
    return int(hit[0]) if hit.size else len(losses)


# ---------------------------------------------------------------- sweep

def _drop_tag(drop: float) -> str:
    return f"drop{int(round(drop * 100))}"


def run_experiment(seed=0, quad_steps=2000, fed_steps=150, out=None,
                   metrics_out=None, metrics_steps=120,
                   drop_mode="directed", device: Device = None,
                   init_fn=None) -> dict:
    """Full sweep: methods x (healthy + DROP_RATES) on both tasks.

    ``metrics_out`` streams per-step telemetry JSONL for the first
    ``metrics_steps`` rounds of every arm; the summary carries
    iterations-to-tolerance, final losses, steps to the healthy-GD loss and
    the FrODO-vs-DGD robustness headline.  ``init_fn(seed)``, if given,
    returns the federated arm's numpy initial weights."""
    dev = resolve_device(device)
    set_full_precision()
    init = init_fn(seed) if init_fn is not None else None
    sink = obs.JsonlSink(metrics_out) if metrics_out else None
    drops = (0.0,) + tuple(DROP_RATES)
    summary = {"quadratic": {}, "federated": {}, "drop_mode": drop_mode,
               "device": str(dev)}

    for drop in drops:
        tag = _drop_tag(drop)
        qrow, frow = {}, {}
        for m in METHODS:
            t0 = time.perf_counter()
            res = run_quadratic(m, drop, quad_steps, seed,
                                collect_metrics=sink is not None,
                                drop_mode=drop_mode, device=dev)
            ms = (time.perf_counter() - t0) * 1e3 / max(quad_steps, 1)
            qrow[m] = {"iters_to_tol": iters_to_tol(res["errors"]),
                       "final_error": float(res["errors"][-1]),
                       "final_f": float(res["f"][-1])}
            if sink is not None:
                for s in range(min(metrics_steps, quad_steps)):
                    sink.write({
                        "exp": "exp3_faults",
                        "variant": f"quadratic-{tag}", "method": m,
                        "step": s,
                        "error": float(res["errors"][s]),
                        "consensus_error": float(res["consensus_error"][s]),
                        "consensus_error_pre_mix":
                            float(res["consensus_error_pre_mix"][s]),
                        **{k: float(res[k][s]) for k in FAULT_KEYS},
                        "step_time_ms":
                            round(ms + float(res["jitter_ms"][s]), 6),
                    })
            fed = run_federated(m, drop, fed_steps, seed,
                                drop_mode=drop_mode, device=dev, init=init)
            frow[m] = {"final_loss": float(fed["loss"][-1]),
                       "final_acc": float(fed["acc"][-1])}
            if sink is not None:
                for s in range(min(metrics_steps, fed_steps)):
                    sink.write({
                        "exp": "exp3_faults",
                        "variant": f"federated-{tag}", "method": m,
                        "step": s,
                        "loss": float(fed["loss"][s]),
                        "acc": float(fed["acc"][s]),
                        "consensus_error": float(fed["consensus_error"][s]),
                        "consensus_error_pre_mix":
                            float(fed["consensus_error_pre_mix"][s]),
                        **{k: float(fed[k][s]) for k in FAULT_KEYS},
                        "step_time_ms": round(float(fed["jitter_ms"][s]), 6),
                    })
            frow[m]["curve_loss"] = fed["loss"]
        # steps to the healthy-GD final loss, the exp2-style speed metric
        if drop == 0.0:
            summary["federated"]["target_loss(gd_healthy_final)"] = \
                frow["gd"]["final_loss"]
        target = summary["federated"].get("target_loss(gd_healthy_final)")
        for m in METHODS:
            frow[m]["steps_to_target"] = steps_to_loss(
                frow[m].pop("curve_loss"), target)
        summary["quadratic"][tag] = qrow
        summary["federated"][tag] = frow

    if sink is not None:
        sink.close()

    # robustness headline: FrODO vs DGD iterations under each drop rate
    for tag, row in summary["quadratic"].items():
        gd, fr = row["gd"]["iters_to_tol"], row["frodo"]["iters_to_tol"]
        row["dgd_over_frodo_iters"] = gd / max(fr, 1)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the fault schedules, data shards, inits and "
                         "batch order; fixed seed -> byte-stable JSONL "
                         "(mod step_time_ms)")
    ap.add_argument("--quad-steps", type=int, default=2000)
    ap.add_argument("--fed-steps", type=int, default=150)
    ap.add_argument("--out", default="experiments/torch_exp3_faults.json")
    ap.add_argument("--metrics-out",
                    default="experiments/torch_exp3_metrics.jsonl",
                    help="per-step telemetry JSONL ('' disables)")
    ap.add_argument("--metrics-steps", type=int, default=120)
    ap.add_argument("--drop-mode", choices=("directed", "symmetric"),
                    default="directed",
                    help="'directed': one-way drops, rows renormalized "
                         "(mean drifts); 'symmetric': undirected failures "
                         "with mass-to-diagonal absorption (W_t stays "
                         "doubly stochastic, no drift floor)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on purpose only)")
    args = ap.parse_args(argv)
    print(json.dumps(run_experiment(seed=args.seed,
                                    quad_steps=args.quad_steps,
                                    fed_steps=args.fed_steps,
                                    out=args.out,
                                    metrics_out=args.metrics_out or None,
                                    metrics_steps=args.metrics_steps,
                                    drop_mode=args.drop_mode,
                                    device=args.device),
                     indent=1))


if __name__ == "__main__":
    main()
