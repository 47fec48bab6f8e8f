"""Ablations beyond the paper's figures, on the quadratic testbed: the port
of the JAX package's ``benchmarks/ablations.py``.

1. **lambda sensitivity**: λ swept on two condition numbers,
   iterations-to-tol of FrODO with exact memory (T = 90).
2. **exp-sum memory compression (K)**: fit error of the power-law kernel
   and end-to-end convergence against the exact O(Tn) buffer, for K in
   {2, 4, 6, 8, 12}.
3. **consensus interval H**: convergence as mixing becomes sparser (no
   update at round 0, mixing when k mod H = 0, as Algorithm 1's loop with
   the mixing skipped between).
4. **exp-sum accumulator dtype (bf16 vs f32)**: the same dynamics with K
   accumulators in bfloat16, per step ``memory_norm`` /
   ``consensus_error`` / ``error`` JSONL plus the host-timed
   ``phase_update_ms`` / ``phase_mix_ms`` / ``phase_metrics_ms`` columns
   (each phase ends in a device sync, so it times the work, not its
   launch).

On the card FrODO runs with ``use_kernel=True``: the exact arms through
the exact kernel, the exp-sum arms through the exp-sum kernel (f32 and
bf16 accumulators).  On the CPU it runs the plain path.  ``rounds`` cuts
every arm's round count (default ``K_MAX`` = 4000, the JAX script's);
iteration counts that reach it read ``rounds`` (not converged).

    PYTHONPATH=src python -m repro_torch.experiments.ablations --device cuda
    PYTHONPATH=src python -m repro_torch.experiments.ablations \\
        --device cpu --only expsum_K --rounds 600
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import consensus as C
from repro_torch.core import graph as G
from repro_torch.core import loop
from repro_torch.core import memory as fmem
from repro_torch.core.frodo import FrodoConfig, apply_updates, frodo
from repro_torch.device import Device, resolve_device, set_full_precision

TOL = 1e-6
K_MAX = 4000
X0 = (0.5, 0.86)
N_AGENTS = 4


def _gradient(cond: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """4 agents, global Hessian diag(2, 2/cond) (exp-1 style): row i of
    ``grad(xs)`` is grad f_i at xs[i], with f_i(x) = 0.5 (x1 - u_i)^2 +
    0.5 c2 (x2 - v_i)^2, the JAX script's four objectives ((2 - x1)^2 is
    (x1 - 2)^2 to the bit: negation is exact), all agents in one autograd
    pass (a loop over agents launches four times the kernels)."""
    c2 = 0.01 * (100.0 / cond)

    def grad(xs: torch.Tensor) -> torch.Tensor:
        u = xs.new_tensor([2.0, -2.0, 0.0, 0.0])
        v = xs.new_tensor([0.0, 0.0, 2.0, -2.0])
        with torch.enable_grad():
            x = xs.detach().requires_grad_(True)
            f = (0.5 * (x[:, 0] - u) ** 2
                 + 0.5 * c2 * (x[:, 1] - v) ** 2)
            return torch.autograd.grad(f.sum(), x)[0]
    return grad


def _errors(opt, cond: float, rounds: int = K_MAX, interval: int = 1,
            device: Device = None) -> np.ndarray:
    """Algorithm 1 on the quadratic testbed: no update at round 0, mixing
    when k mod ``interval`` = 0 (every round at 1, as ``core.loop.run``);
    the per-round mean distance to x* = 0."""
    dev = resolve_device(device)
    W = G.xiao_boyd_weights(G.complete(N_AGENTS))
    grad = _gradient(cond)
    xs = torch.tensor(X0, dtype=torch.float32, device=dev).repeat(
        N_AGENTS, 1)
    state, errs = opt.init(xs), []
    for k in range(rounds):
        if k > 0:
            d, state = opt.update(grad(xs), state, xs)
            xs = apply_updates(xs, d)
        if k % interval == 0:
            xs = C.mix_stacked(xs, W)
        errs.append(torch.mean(torch.linalg.vector_norm(xs, dim=-1)))
    return torch.stack(errs).cpu().numpy()


def _iters(opt, cond: float, rounds: int = K_MAX, interval: int = 1,
           device: Device = None, errors: Optional[dict] = None,
           key: str = "") -> int:
    errs = _errors(opt, cond, rounds, interval, device)
    if errors is not None:
        errors[key] = errs
    return loop.iterations_to_tol(errs, TOL)


def _frodo(dev, use_kernel: Optional[bool] = None, **kw):
    """FrODO at the ablations' point (alpha 0.8, beta 0.35, lambda 0.15,
    T = 90; ``kw`` overrides), through the kernels on the card unless
    ``use_kernel`` says otherwise."""
    return frodo(FrodoConfig(
        **{"alpha": 0.8, "beta": 0.35, "lam": 0.15, "T": 90, **kw},
        use_kernel=dev.type == "cuda" if use_kernel is None else use_kernel))


def lambda_sensitivity(rounds: int = K_MAX, device: Device = None,
                       use_kernel: Optional[bool] = None,
                       errors: Optional[dict] = None) -> dict:
    """``errors``, if given, gets each run's per-round errors by row."""
    dev = resolve_device(device)
    rows = {}
    for cond in (10.0, 100.0):
        rows[f"cond{int(cond)}"] = {
            f"lam={lam}": _iters(_frodo(dev, use_kernel, lam=lam), cond,
                                 rounds, device=dev, errors=errors,
                                 key=f"cond{int(cond)}/lam={lam}")
            for lam in (0.05, 0.1, 0.15, 0.2, 0.4, 0.8)}
    return rows


def expsum_K(rounds: int = K_MAX, device: Device = None,
             use_kernel: Optional[bool] = None,
             errors: Optional[dict] = None) -> dict:
    dev = resolve_device(device)
    rows = {"exact_T90": _iters(_frodo(dev, use_kernel,
                                       memory_mode="exact"), 100.0, rounds,
                                device=dev, errors=errors, key="exact_T90")}
    for K in (2, 4, 6, 8, 12):
        it = _iters(_frodo(dev, use_kernel, memory_mode="expsum", K=K),
                    100.0, rounds, device=dev, errors=errors, key=f"K={K}")
        rows[f"K={K}"] = {"iters": it,
                          "fit_rel_l2": fmem.expsum_error(90, 0.15, K),
                          "state_vs_exact": K / 90.0}
    return rows


def consensus_interval(rounds: int = K_MAX, device: Device = None,
                       use_kernel: Optional[bool] = None,
                       errors: Optional[dict] = None) -> dict:
    dev = resolve_device(device)
    return {f"H={h}": _iters(_frodo(dev, use_kernel), 100.0, rounds,
                             interval=h, device=dev, errors=errors,
                             key=f"H={h}")
            for h in (1, 2, 4, 8)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def expsum_dtype(jsonl_path: Optional[str] = None, steps: int = 800,
                 K_acc: int = 8, device: Device = None) -> dict:
    """bf16 vs f32 exp-sum accumulators, instrumented per step.

    A host loop of separate update and mix stages, each ended by a device
    sync, so the per-phase split is host-observable: each JSONL row carries
    ``error``, ``memory_norm``, ``consensus_error(_pre_mix)`` plus
    ``phase_update_ms``/``phase_mix_ms``/``phase_metrics_ms`` and their
    ``step_time_ms`` total (``repro_torch.obs.report`` renders the
    breakdown per variant).  With a ``SpanRecorder`` installed the same
    stages land as ``ablate.dtype/ablate.update`` ... spans.
    """
    dev = resolve_device(device)
    grad = _gradient(100.0)
    W = G.xiao_boyd_weights(G.complete(N_AGENTS))
    x0 = torch.tensor(X0, dtype=torch.float32, device=dev).repeat(
        N_AGENTS, 1)
    sink = obs.JsonlSink(jsonl_path) if jsonl_path else None
    rows = {}
    for dtype in ("float32", "bfloat16"):
        opt = _frodo(dev, memory_mode="expsum", K=K_acc, acc_dtype=dtype,
                     collect_metrics=True)

        def grad_update(xs, state):
            d, state = opt.update(grad(xs), state, xs)
            return apply_updates(xs, d), state

        xs, state = x0, opt.init(x0)
        errs = np.empty(steps)
        with obs.span("ablate.dtype", variant=dtype):
            for k in range(steps):
                t0 = time.perf_counter()
                if k > 0:           # Algorithm 1 skips the k=0 update
                    with obs.span("ablate.update"):
                        xs, state = grad_update(xs, state)
                        _sync(dev)
                t1 = time.perf_counter()
                with obs.span("ablate.mix"):
                    xs, caux = C.mix_stacked(xs, W, with_metrics=True)
                    _sync(dev)
                t2 = time.perf_counter()
                with obs.span("ablate.metrics"):
                    err = float(torch.mean(torch.linalg.vector_norm(
                        xs, dim=-1)))
                    errs[k] = err
                    if sink is not None:
                        t3 = time.perf_counter()
                        sink.write({
                            "exp": "ablate_expsum_dtype", "variant": dtype,
                            "step": k, "error": err,
                            "memory_norm":
                                float(state["metrics"]["memory_norm"]),
                            "consensus_error":
                                float(caux["consensus_error_post"]),
                            "consensus_error_pre_mix":
                                float(caux["consensus_error_pre"]),
                            "step_time_ms": round((t3 - t0) * 1e3, 6),
                            "phase_update_ms": round((t1 - t0) * 1e3, 6),
                            "phase_mix_ms": round((t2 - t1) * 1e3, 6),
                            "phase_metrics_ms": round((t3 - t2) * 1e3, 6),
                        })
        acc_bytes = {"float32": 4, "bfloat16": 2}[dtype] * K_acc
        rows[dtype] = {
            "iters_to_1e-2": loop.iterations_to_tol(errs, 1e-2),
            "iters_to_1e-3": loop.iterations_to_tol(errs, 1e-3),
            "iters_to_1e-6": loop.iterations_to_tol(errs, TOL),
            "floor_error": float(errs[steps // 2:].min()),
            "final_error": float(errs[-1]),
            "final_memory_norm": float(state["metrics"]["memory_norm"]),
            "acc_bytes_per_param": acc_bytes,
        }
    if sink is not None:
        sink.close()
    return rows


ARMS = {"lambda": ("lambda_sensitivity",
                   lambda a: lambda_sensitivity(a.rounds, a.device)),
        "expsum_K": ("expsum_K", lambda a: expsum_K(a.rounds, a.device)),
        "interval": ("consensus_interval_H",
                     lambda a: consensus_interval(a.rounds, a.device)),
        "dtype": ("expsum_dtype",
                  lambda a: expsum_dtype(jsonl_path=a.dtype_jsonl or None,
                                         steps=a.dtype_steps,
                                         device=a.device))}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="+", choices=sorted(ARMS), default=None,
                    help="run a subset of ablation arms")
    ap.add_argument("--out", default="experiments/ablations_torch.json")
    ap.add_argument("--dtype-jsonl",
                    default="experiments/ablate_dtype_torch.jsonl",
                    help="per-step JSONL for the dtype arm ('' disables)")
    ap.add_argument("--dtype-steps", type=int, default=800)
    ap.add_argument("--rounds", type=int, default=K_MAX,
                    help="rounds of the lambda, K and interval arms")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    set_full_precision()
    out = {}
    for arm in args.only or sorted(ARMS):
        key, fn = ARMS[arm]
        out[key] = fn(args)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
