"""Stage-3 consensus: x <- W x over the agent dimension (stacked layout).

Agent states carry an explicit leading dim A.  Mixing contracts that dim
with the row-stochastic W in float32 (TF32 off: see
``repro_torch.device.set_full_precision``).  The uniform complete graph,
W == 11^T/A, takes a mean over the agent dim instead.

The time-varying, hierarchical and collective forms of the JAX package's
``repro.core.consensus`` are not ported yet.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.obs import metrics as obs_metrics

Tree = Any


def is_uniform_complete(W: np.ndarray, tol: float = 1e-9) -> bool:
    A = W.shape[0]
    return bool(np.allclose(W, np.full((A, A), 1.0 / A), atol=tol))


def mix_stacked(x: Tree, W, with_metrics: bool = False):
    """x[a] <- sum_b W[a,b] x[b]   for every leaf (leading dim = agents).

    ``W`` is a host numpy matrix (which may take the uniform-complete mean
    shortcut) or a tensor, which always takes the general contraction.

    ``with_metrics=True`` also returns ``{"consensus_error_pre",
    "consensus_error_post"}``: the RMS per-agent disagreement before and
    after mixing (the Thm 2.1 Lyapunov quantity).
    """
    if isinstance(W, np.ndarray) and is_uniform_complete(W):
        def leaf(v):
            m = torch.mean(v.float(), dim=0, keepdim=True).to(v.dtype)
            return m.expand_as(v).contiguous()
    else:
        Wt = torch.as_tensor(W, dtype=torch.float32,
                             device=TR.leaves(x)[0].device)

        def leaf(v):
            o = torch.einsum("ab,b...->a...", Wt, v.float())
            return o.to(v.dtype)
    out = TR.tree_map(leaf, x)
    if not with_metrics:
        return out
    aux = {"consensus_error_pre": obs_metrics.consensus_error(x),
           "consensus_error_post": obs_metrics.consensus_error(out)}
    return out, aux
