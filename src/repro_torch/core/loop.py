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
        W: np.ndarray,                      # (N, N) row-stochastic mixing
        K: int,
        x_star: Optional[torch.Tensor] = None,
        faults=None,
        collect_metrics: bool = False,
        ) -> dict:
    """Run K rounds of Algorithm 1 on ``x0``'s device.  Returns a dict with
    the final states ``"x"``, the per-round mean distance to ``x_star``
    (``"errors"``, zeros without it) and the global objective
    ``sum_i f_i(mean state)`` (``"f"``); ``collect_metrics=True`` adds
    per-round ``consensus_error`` / ``consensus_error_pre_mix``.

    The fault-injection branch (``faults=``) is not ported yet."""
    if faults is not None:
        raise NotImplementedError(
            "faults= is not ported to repro_torch yet; run it with the JAX "
            "package")
    N = x0.shape[0]
    xs = x0
    opt_state = opt.init(x0)
    errs, fvals, pre, post = [], [], [], []
    for k in range(K):
        if k > 0:
            g = _grads(objective, xs)
            delta, opt_state = opt.update(g, opt_state, xs)
            xs = apply_updates(xs, delta)
        if collect_metrics:
            xs, aux = consensus.mix_stacked(xs, W, with_metrics=True)
            pre.append(aux["consensus_error_pre"])
            post.append(aux["consensus_error_post"])
        else:
            xs = consensus.mix_stacked(xs, W)
        with torch.no_grad():
            errs.append(torch.mean(torch.linalg.vector_norm(
                xs - x_star[None], dim=-1)) if x_star is not None
                else torch.zeros((), device=xs.device))
            xbar = xs.mean(dim=0)
            fvals.append(sum(objective(xbar, i) for i in range(N)))
    result = {"x": xs,
              "errors": torch.stack(errs).cpu().numpy(),
              "f": torch.stack(fvals).detach().cpu().numpy()}
    if collect_metrics:
        result["consensus_error_pre_mix"] = torch.stack(pre).cpu().numpy()
        result["consensus_error"] = torch.stack(post).cpu().numpy()
    return result


def iterations_to_tol(errors: np.ndarray, tol: float = 1e-6) -> int:
    """First round at which mean distance to x* drops below tol (or len)."""
    hit = np.nonzero(errors < tol)[0]
    return int(hit[0]) if hit.size else len(errors)
