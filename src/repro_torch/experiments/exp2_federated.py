"""Experiment 2 — federated MLP training (paper §3.2, Fig. 1 right), on the
port.

Two agents, each with a 784-1024-128-10 MLP (936,330 parameters), on the
synthetic 10-class 784-dim problem of ``data.synthetic`` (the stand-in for
MNIST), mini-batch 64, complete graph with Xiao-Boyd weights.  The methods
are FrODO (exact memory, T = 80, through the fused update kernel) and the
baselines gradient descent, Nesterov, heavy ball (T=1) and Adam, each "a
variation of Algorithm 1 with a modified stage-2 descent term".

This mirrors the JAX script ``benchmarks/exp2_federated.py``: the same data,
batch order, hyperparameters and telemetry records.  Initial weights are
drawn from a ``torch.Generator`` seeded from ``--seed`` (``jax.random`` draws
cannot be reproduced); ``train`` also takes numpy weights, e.g. exported
from the JAX script, through ``repro_torch.convert``.

    python -m repro_torch.experiments.exp2_federated --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch import tree as TR
from repro_torch.core import consensus as C
from repro_torch.core import graph as G
from repro_torch.core.baselines import REGISTRY
from repro_torch.core.frodo import FrodoConfig, Optimizer, apply_updates, frodo
from repro_torch.data.synthetic import make_classification
from repro_torch.device import Device, resolve_device, set_full_precision
from repro_torch.obs import metrics as obs

N_AGENTS = 2
BATCH = 64
HIDDEN = (1024, 128)
N_CLASSES = 10
DIM = 784
SIZES = (DIM,) + HIDDEN + (N_CLASSES,)
METHODS = ("frodo", "gd", "nesterov", "heavy_ball", "adam")


def init_mlp(generator: torch.Generator, n_agents: int = N_AGENTS,
             sizes: Sequence[int] = SIZES, device: Device = "cpu"):
    """Agent-stacked He-normal weights ``w{i}: (A, a, b)`` and zero biases
    ``b{i}: (A, b)``, drawn on the host from ``generator``."""
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((n_agents, a, b), generator=generator) \
            * np.sqrt(2.0 / a)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((n_agents, b), device=device)
    return params


def n_params(params) -> int:
    """Parameters of one agent."""
    return sum(p[0].numel() for p in TR.leaves(params))


def mlp_loss(params: Dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor):
    """x: (A, B, in), y: (A, B).  Returns per-agent mean cross-entropy and
    accuracy, both (A,)."""
    h = x
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = torch.baddbmm(params[f"b{i}"][:, None, :], h, params[f"w{i}"])
        if i < n_layers - 1:
            h = torch.relu(h)
    logp = torch.log_softmax(h, dim=-1)
    loss = -torch.mean(torch.gather(logp, -1, y[..., None])[..., 0], dim=-1)
    acc = torch.mean((torch.argmax(h, dim=-1) == y).float(), dim=-1)
    return loss, acc


def make_optimizer(name: str, scale: float = 1.0,
                   telemetry: bool = False) -> Optimizer:
    if name == "frodo":
        return frodo(FrodoConfig(alpha=0.05 * scale, beta=0.02 * scale,
                                 lam=0.15, T=80, memory_mode="exact",
                                 use_kernel=True, collect_metrics=telemetry))
    if name == "heavy_ball":
        return REGISTRY["heavy_ball"](alpha=0.05 * scale, beta=0.02 * scale)
    if name == "gd":
        return REGISTRY["no_memory"](alpha=0.05 * scale)
    if name == "nesterov":
        return REGISTRY["nesterov"](alpha=0.05 * scale)
    if name == "adam":
        return REGISTRY["adam"](alpha=1e-3 * scale)
    raise ValueError(name)


def batch_indices(seed: int, steps: int, n_per_agent: int) -> np.ndarray:
    """(steps, A, BATCH) sample indices, the JAX script's draw."""
    rng = np.random.default_rng(seed + 77)
    return rng.integers(0, n_per_agent, size=(steps, N_AGENTS, BATCH))


def train(opt: Optimizer, params: Any, X, y, idx, W: np.ndarray,
          telemetry: bool = False,
          device: Device = None) -> Dict[str, Any]:
    """Algorithm 1 on the agent-stacked MLP: per step, the per-agent
    gradient on the batch ``idx[k]``, the optimizer update, then consensus
    with ``W``.

    ``params`` is a dict of tensors or of numpy arrays (converted with
    ``convert.params_from_numpy``); ``X``, ``y`` and ``idx`` are numpy
    arrays or tensors, copied to the device unless already there.  Returns per-step ``loss`` and ``acc``
    (means over agents, numpy), ``step_time_ms`` (host clock over the whole
    loop, ended by a device sync, divided by the steps), the final
    ``params`` and, with ``telemetry``, per-step ``consensus_error``,
    ``consensus_error_pre_mix``, ``grad_norm`` and ``memory_norm``.
    """
    dev = resolve_device(device)
    if not isinstance(TR.leaves(params)[0], torch.Tensor):
        params = convert.params_from_numpy(params, dev)
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, dtype=torch.int64, device=dev)
    idxd = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    opt_state = opt.init(params)
    has_opt_metrics = telemetry and "metrics" in opt_state
    keys = sorted(params)
    losses, accs = [], []
    tel = {k: [] for k in ("consensus_error", "consensus_error_pre_mix",
                           "grad_norm", "memory_norm")} if telemetry else {}

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for k in range(idxd.shape[0]):
        bi = idxd[k]
        xb = torch.take_along_dim(Xd, bi[..., None], dim=1)
        yb = torch.take_along_dim(yd, bi, dim=1)
        leaves = {n: params[n].detach().requires_grad_(True) for n in keys}
        loss, acc = mlp_loss(leaves, xb, yb)
        # the agents' losses are independent: the gradient of their sum is
        # each agent's own gradient
        grads = dict(zip(keys, torch.autograd.grad(
            loss.sum(), [leaves[n] for n in keys])))
        delta, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, delta)
        losses.append(loss.detach().mean())
        accs.append(acc.mean())
        if telemetry:
            params, caux = C.mix_stacked(params, W, with_metrics=True)
            tel["consensus_error"].append(caux["consensus_error_post"])
            tel["consensus_error_pre_mix"].append(caux["consensus_error_pre"])
            tel["grad_norm"].append(obs.global_norm(grads))
            tel["memory_norm"].append(
                opt_state["metrics"]["memory_norm"] if has_opt_metrics
                else torch.zeros((), device=dev))
        else:
            params = C.mix_stacked(params, W)
    out = {"loss": torch.stack(losses).cpu().numpy(),
           "acc": torch.stack(accs).cpu().numpy()}
    out["step_time_ms"] = (time.perf_counter() - t0) * 1e3 / max(
        idxd.shape[0], 1)
    out.update({k: torch.stack(v).cpu().numpy() for k, v in tel.items()})
    out["params"] = params
    return out


def run_one(name: str, seed: int, steps: int, telemetry: bool = False,
            device: Device = None, init: Optional[Any] = None):
    """One method, one seed.  Returns (losses, accs), or with ``telemetry``
    (losses, accs, tel) where ``tel`` holds the per-step telemetry and
    ``step_time_ms``.  ``init``: numpy initial parameters (agent-stacked);
    by default they are drawn from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    X, y = make_classification(n_per_class=200, n_agents=N_AGENTS,
                               seed=seed, noise=2.0)
    W = G.xiao_boyd_weights(G.complete(N_AGENTS))
    if init is None:
        init = init_mlp(torch.Generator().manual_seed(seed), device=dev)
    res = train(make_optimizer(name, telemetry=telemetry), init, X, y,
                batch_indices(seed, steps, y.shape[1]), W,
                telemetry=telemetry, device=dev)
    if not telemetry:
        return res["loss"], res["acc"]
    tel = {k: res[k] for k in ("consensus_error", "consensus_error_pre_mix",
                               "grad_norm", "memory_norm", "step_time_ms")}
    return res["loss"], res["acc"], tel


def steps_to_loss(losses: np.ndarray, target: float) -> int:
    hit = np.nonzero(losses <= target)[0]
    return int(hit[0]) if hit.size else len(losses)


def run_experiment(steps=300, n_seeds=5, out=None, metrics_out=None, seed=0,
                   device: Device = None, init_fn=None):
    """Every method over ``n_seeds`` runs; run s uses ``seed + s`` for the
    data shards, initial weights and batch order.  The first run of each
    method writes per-step telemetry to ``metrics_out`` (JSONL).
    ``init_fn(run_seed)``, if given, returns numpy initial parameters."""
    dev = resolve_device(device)
    set_full_precision()
    curves = {m: [] for m in METHODS}
    sink = obs.JsonlSink(metrics_out) if metrics_out else None
    for m in METHODS:
        for s in range(n_seeds):
            run_seed = seed + s
            init = init_fn(run_seed) if init_fn is not None else None
            if sink is not None and s == 0:
                losses, accs, tel = run_one(m, run_seed, steps, True, dev,
                                            init)
                ms = tel.pop("step_time_ms")
                for k in range(steps):
                    sink.write({"exp": "exp2_federated", "method": m,
                                "seed": run_seed, "step": k,
                                "loss": float(losses[k]),
                                "acc": float(accs[k]),
                                "step_time_ms": round(ms, 4),
                                **{kk: float(a[k]) for kk, a in tel.items()}})
            else:
                losses, accs = run_one(m, run_seed, steps, False, dev, init)
            curves[m].append((losses, accs))
    if sink is not None:
        sink.close()

    # speed metric: steps to reach the loss that plain GD reaches at the end
    gd_final = float(np.mean([c[0][-1] for c in curves["gd"]]))
    summary = {"device": str(dev), "target_loss(gd_final)": gd_final,
               "n_params": n_params(init_mlp(torch.Generator().manual_seed(0)))}
    for m in METHODS:
        st = [steps_to_loss(c[0], gd_final) for c in curves[m]]
        summary[m] = {
            "final_loss_mean": float(np.mean([c[0][-1] for c in curves[m]])),
            "final_acc_mean": float(np.mean([c[1][-1] for c in curves[m]])),
            "steps_to_gd_final": (float(np.mean(st)), float(np.std(st))),
        }
    for m in ("gd", "nesterov", "heavy_ball"):
        summary[f"speedup_vs_{m}"] = (
            summary[m]["steps_to_gd_final"][0]
            / max(summary["frodo"]["steps_to_gd_final"][0], 1.0))

    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; run s uses seed+s for data/init/batches")
    ap.add_argument("--out", default="experiments/torch_exp2_federated.json")
    ap.add_argument("--metrics-out",
                    default="experiments/torch_exp2_metrics.jsonl",
                    help="per-step telemetry JSONL ('' disables)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on purpose only)")
    args = ap.parse_args(argv)
    print(json.dumps(run_experiment(args.steps, args.seeds, out=args.out,
                                    metrics_out=args.metrics_out or None,
                                    seed=args.seed, device=args.device),
                     indent=1))


if __name__ == "__main__":
    main()
