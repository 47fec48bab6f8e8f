"""Stage-3 consensus: x <- W x over the agent dimension (stacked layout).

Agent states carry an explicit leading dim A.  Mixing contracts that dim
with the row-stochastic W in float32 (TF32 off: see
``repro_torch.device.set_full_precision``).  The uniform complete graph,
W == 11^T/A, takes a mean over the agent dim instead.  ``mix_time_varying``
applies one step of a fault-masked sequence of W; ``mix_hierarchical`` the
two-level (pod x intra-pod) Kronecker mixing.

The collective forms (the JAX package's ``shard_map`` ones) run on
``torch.distributed``: each takes the rank's local agent slice
``(A_local, ...)`` of every leaf and a group (``distributed.comm``: a
``ProcessGroup``, ``None`` for the default one, or a ``(DeviceMesh, dim
name)`` pair).  ``pmean_mix``/``pmean_shardmap`` and
``mix_uniform_constrained`` all-reduce an f32 sum; ``ring_mix`` swaps
blocks with the neighbouring ranks (``batch_isend_irecv``);
``general_mix`` all-gathers the agents and applies the rank's rows of W.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.distributed import comm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.timing import trace_scope

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
        scope = "consensus.mix_uniform"

        def leaf(v):
            # per column, so in column slices (obs.metrics.col_slices)
            out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
            x, o = v.reshape(v.shape[0], -1), out.view(v.shape[0], -1)
            for i, j in obs_metrics.col_slices(x.shape[1]):
                o[:, i:j] = torch.mean(x[:, i:j].float(), dim=0,
                                       keepdim=True).to(v.dtype)
            return out
    else:
        scope = "consensus.mix_general"
        Wt = torch.as_tensor(W, dtype=torch.float32,
                             device=TR.leaves(x)[0].device)

        def leaf(v):
            o = torch.einsum("ab,b...->a...", Wt, v.float())
            return o.to(v.dtype)
    with trace_scope(scope):
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
    with trace_scope("consensus.mix_time_varying"):
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

    with trace_scope("consensus.mix_hierarchical"):
        return TR.tree_map(leaf, x)


# -------------------------------------------------------------- collective
# One agent per rank makes each of these the stacked form of the same W.

def _pmean(x: Tree, group) -> Tree:
    w = comm.world_size(group)

    def leaf(v):
        s = comm.all_reduce_sum(v.float().clone(), group)
        return (s / w).to(v.dtype)
    return TR.tree_map(leaf, x)


def pmean_mix(x: Tree, group=None) -> Tree:
    """Uniform complete-graph consensus: the mean over the group's ranks
    of their blocks (an all-reduce of the f32 sum, divided by the rank
    count and cast back), the JAX form's ``pmean`` over the agent axes."""
    with trace_scope("consensus.pmean_mix"):
        return _pmean(x, group)


def pmean_shardmap(x: Tree, group=None) -> Tree:
    """The same all-reduce mean, in the JAX package called from outside
    ``shard_map`` on a stacked tree sharded over the agent axes: 2 x the
    local bytes per rank, against A x for an agent-dim all-gather."""
    with trace_scope("consensus.pmean_shardmap"):
        return _pmean(x, group)


def mix_uniform_constrained(x: Tree, group=None,
                            n_agents: Optional[int] = None) -> Tree:
    """Uniform complete-graph consensus of an agent-sharded stack: each
    rank sums its agents in f32, the sums are all-reduced, divided by the
    global agent count ``n_agents`` (A_local x ranks unless given) and
    broadcast back into the local stack."""
    A = n_agents or TR.leaves(x)[0].shape[0] * comm.world_size(group)

    def leaf(v):
        s = comm.all_reduce_sum(torch.sum(v.float(), dim=0), group)
        return (s / A).to(v.dtype).expand_as(v).contiguous()

    with trace_scope("consensus.mix_uniform_constrained"):
        return TR.tree_map(leaf, x)


def ring_mix(x: Tree, group=None, w_self: float = 0.5,
             bidirectional: bool = True) -> Tree:
    """Ring consensus over the group's ranks by neighbour exchange: O(n)
    per rank per neighbour, no all-gather.  ``w_self`` plus the neighbour
    weights sum to 1 (row-stochastic)."""
    n_nbrs = 2 if bidirectional else 1
    w_nbr = (1.0 - w_self) / n_nbrs

    def leaf(v):
        fwd = comm.shift(v, 1, group)             # rank r-1's block
        acc = w_self * v.float() + w_nbr * fwd.float()
        if bidirectional:
            acc = acc + w_nbr * comm.shift(v, -1, group).float()
        return acc.to(v.dtype)

    with trace_scope("consensus.ring_mix"):
        return TR.tree_map(leaf, x)


def general_mix(x: Tree, W, group=None) -> Tree:
    """Arbitrary row-stochastic (A, A) W over an agent-sharded stack:
    all-gather every rank's agents, then apply this rank's rows of W in
    f32.  O(A n) per rank: the form for arbitrary digraphs."""
    r = comm.rank(group)
    leaves = TR.leaves(x)
    A_loc = leaves[0].shape[0]
    Wt = torch.as_tensor(W, dtype=torch.float32, device=leaves[0].device)
    rows = Wt[r * A_loc:(r + 1) * A_loc]

    def leaf(v):
        allv = comm.all_gather(v, group)
        allv = allv.reshape((-1,) + tuple(v.shape[1:]))
        return torch.einsum("ab,b...->a...", rows, allv.float()).to(v.dtype)

    with trace_scope("consensus.general_mix"):
        return TR.tree_map(leaf, x)
