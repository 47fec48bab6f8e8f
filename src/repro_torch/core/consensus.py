"""Stage-3 consensus: x <- W x over the agent dimension (stacked layout).

Agent states carry an explicit leading dim A.  Mixing contracts that dim
with the row-stochastic W in float32 (TF32 off: see
``repro_torch.device.set_full_precision``).  The uniform complete graph,
W == 11^T/A, takes a mean over the agent dim instead.  ``mix_time_varying``
applies one step of a fault-masked sequence of W; ``mix_hierarchical`` the
two-level (pod x intra-pod) Kronecker mixing.

The collective (shard_map) forms of the JAX package's
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


def mix_time_varying(x: Tree, W_seq, step: int, with_metrics: bool = False):
    """Fault-aware consensus: apply step ``step``'s matrix of a precompiled
    (K, A, A) mixing sequence (``faults.CompiledFaults.W_seq``) to the
    stacked states.  Steps beyond the schedule's horizon wrap around
    (``step % K``).

    ``W_seq`` is best a tensor on the states' device, copied there once per
    run: indexing it with the host integer ``step`` then makes no copy and
    no sync.  The step's W_t reaches ``mix_stacked`` as a tensor, so it
    takes the general f32 contraction, as the JAX package's traced W_t
    does, even where W_t is 11^T/A."""
    W_t = torch.as_tensor(W_seq[step % W_seq.shape[0]], dtype=torch.float32,
                          device=TR.leaves(x)[0].device)
    return mix_stacked(x, W_t, with_metrics=with_metrics)


def mix_hierarchical(x: Tree, W_intra: np.ndarray, W_pod: np.ndarray,
                     step: int, period: int = 1) -> Tree:
    """Two-level mixing on a leading dim A = P*D (pod-major).

    The intra-pod factor applies every step; the cross-pod factor when
    ``step % period == 0``.  period=1 recovers W_pod (x) W_intra.  A uniform
    complete factor takes the mean shortcut.
    """
    P, D = W_pod.shape[0], W_intra.shape[0]
    cross = step % period == 0
    dev = TR.leaves(x)[0].device
    Wi = None if is_uniform_complete(W_intra) else torch.as_tensor(
        W_intra, dtype=torch.float32, device=dev)
    Wp = None if is_uniform_complete(W_pod) else torch.as_tensor(
        W_pod, dtype=torch.float32, device=dev)

    def leaf(v):
        u = v.reshape((P, D) + tuple(v.shape[1:])).float()
        if Wi is None:
            u = torch.mean(u, dim=1, keepdim=True).expand_as(u)
        else:
            u = torch.einsum("de,pe...->pd...", Wi, u)
        if cross:
            if Wp is None:
                u = torch.mean(u, dim=0, keepdim=True).expand_as(u)
            else:
                u = torch.einsum("qp,pd...->qd...", Wp, u)
        return u.reshape(v.shape).to(v.dtype)

    return TR.tree_map(leaf, x)
