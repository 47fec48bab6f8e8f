"""Small-scale FrODO loop: Algorithm 1 verbatim.

Agents are a leading axis of size N; the objectives are one function
``objective(x, i)``, agent i's private f_i at x (n,), written in torch so
autograd gives the gradients.

Ordering follows Algorithm 1: the gradient/memory/update stage is skipped
in the first round (k = 0 here), and consensus runs every round *after* the
update stage.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import consensus
from repro_torch.core.frodo import Optimizer, apply_updates


def _grads(objective, xs: torch.Tensor) -> torch.Tensor:
    """Row i holds grad f_i at xs[i] (each f_i sees only its own row)."""
    with torch.enable_grad():
        x = xs.detach().requires_grad_(True)
        total = sum(objective(x[i], i) for i in range(x.shape[0]))
        return torch.autograd.grad(total, x)[0]


def run(objective: Callable[[torch.Tensor, int], torch.Tensor],
        x0: torch.Tensor,                   # (N, n) initial agent states
        opt: Optimizer,
        W: Optional[np.ndarray],            # (N, N) row-stochastic mixing
        K: int,
        x_star=None,
        faults=None,                        # faults.CompiledFaults
        collect_metrics: bool = False,
        ) -> dict:
    """Run K rounds of Algorithm 1 on ``x0``'s device.  Returns a dict with
    the final states ``"x"``, the per-round mean distance to ``x_star``
    (``"errors"``, zeros without it) and the global objective
    ``sum_i f_i(mean state)`` (``"f"``).  ``x_star`` (a tensor or array) is
    moved to ``x0``'s device here.

    With ``faults`` set (``W`` is then ignored and may be None), consensus
    runs over the schedule's per-step ``W_t`` and its update mask applies:
    an inactive agent (straggler, crashed) pushes a zero gradient into its
    memory and takes a zero update for the round.  The result then also
    carries the schedule's fault counter trajectories (``faults_*``, cycled
    to K rounds).  ``collect_metrics=True`` adds per-round
    ``consensus_error`` / ``consensus_error_pre_mix`` in either mode."""
    N = x0.shape[0]
    dev = x0.device
    xs = x0
    if x_star is not None:
        x_star = torch.as_tensor(x_star, dtype=x0.dtype, device=dev)
    if faults is not None:
        # copied once per run; a round indexes them with its host integer
        W_seq = torch.as_tensor(faults.W_seq, dtype=torch.float32,
                                device=dev)
        u_seq = torch.as_tensor(faults.update_mask, dtype=torch.float32,
                                device=dev)
    opt_state = opt.init(x0)
    errs, fvals, pre, post = [], [], [], []
    for k in range(K):
        if k > 0:
            g = _grads(objective, xs)
            if faults is not None:
                # mask g before the update: the masked (zero) gradient is
                # what the memory, kernel or not, pushes into its slot
                u = u_seq[k % u_seq.shape[0]][:, None]
                g = g * u.to(g.dtype)
            delta, opt_state = opt.update(g, opt_state, xs)
            if faults is not None:
                delta = delta * u.to(delta.dtype)
            xs = apply_updates(xs, delta)
        if faults is not None:
            mixed = consensus.mix_time_varying(xs, W_seq, k,
                                               with_metrics=collect_metrics)
        else:
            mixed = consensus.mix_stacked(xs, W, with_metrics=collect_metrics)
        if collect_metrics:
            xs, aux = mixed
            pre.append(aux["consensus_error_pre"])
            post.append(aux["consensus_error_post"])
        else:
            xs = mixed
        with torch.no_grad():
            errs.append(torch.mean(torch.linalg.vector_norm(
                xs - x_star[None], dim=-1)) if x_star is not None
                else torch.zeros((), device=dev))
            xbar = xs.mean(dim=0)
            fvals.append(sum(objective(xbar, i) for i in range(N)))
    result = {"x": xs,
              "errors": torch.stack(errs).cpu().numpy(),
              "f": torch.stack(fvals).detach().cpu().numpy()}
    if collect_metrics:
        result["consensus_error_pre_mix"] = torch.stack(pre).cpu().numpy()
        result["consensus_error"] = torch.stack(post).cpu().numpy()
    if faults is not None:
        idx = np.arange(K) % faults.n_steps
        result.update({k: v[idx]
                       for k, v in faults.counter_arrays().items()})
    return result


def iterations_to_tol(errors: np.ndarray, tol: float = 1e-6) -> int:
    """First round at which mean distance to x* drops below tol (or len)."""
    hit = np.nonzero(errors < tol)[0]
    return int(hit[0]) if hit.size else len(errors)
