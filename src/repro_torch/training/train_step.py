"""The agent-stacked FrODO training step: the port of the JAX package's
``repro.training.train_step``.

Layout: every param leaf carries a leading **agent** dim A.  The JAX step
``vmap``s the per-agent value-and-grad; here a Python loop runs each agent's
loss on ``unbind`` views of the stacked leaves, and one backward of the sum
of the agents' losses gives every agent its own gradient (the losses are
independent), landing in a contiguous ``(A, ...)`` tensor per leaf: the
layout the fused update kernels take.  (``torch.func.vmap`` would need the
layer loop's checkpointing and the chunked loss under ``vmap``; the loop
keeps both plain.)  The FrODO update is elementwise over that tensor; the
consensus stage mixes the agent dim.  A=1 is centralized fractional-order
GD, the paper's N=1 corner.

The mesh-constrained consensus (``mix_uniform_constrained``) and the
sharding-spec functions of the JAX module belong to the distributed slice
and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.core import baselines
from repro_torch.core import consensus as C
from repro_torch.core import graph as G
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.frodo import (FrodoConfig, Optimizer, apply_updates,
                                    frodo)
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.training.loss import (chunked_cross_entropy,
                                       clip_by_global_norm)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    ce_chunks: int = 8                   # chunked-CE row chunks (memory)
    optimizer: str = "frodo"             # frodo|no_memory|heavy_ball|nesterov|adam
    alpha: float = 0.02                  # gradient step (LR)
    beta: float = 0.008                  # memory feedback
    lam: float = 0.15
    T: int = 90
    memory_mode: str = "expsum"          # expsum default at LLM scale
    K: int = 8
    acc_dtype: str = "float32"
    use_kernel: bool = False
    grad_clip: float = 1.0
    remat: object = True        # False | True("nothing") | "dots" | "dots_no_batch"
    microbatches: int = 1                # grad-accumulation steps per round
    # consensus
    topology: str = "complete"           # complete|ring|hierarchical
    weights: str = "xiao_boyd"           # uniform|metropolis|xiao_boyd
    consensus_interval: int = 1          # mix every H steps (beyond-paper)
    cross_pod_period: int = 1            # hierarchical: DCN mixing period
    # fault injection (core/faults.py): a schedule compiles to per-step
    # masked mixing matrices + agent update masks over ``fault_horizon``
    # steps, cycled (step % horizon) beyond it
    fault_schedule: Optional[FaultSchedule] = None
    fault_horizon: int = 64
    # observability: also return consensus_error/memory_norm/... from the
    # step (drained to a sink by the trainer)
    collect_metrics: bool = False


class TrainState(NamedTuple):
    params: Any          # (A, ...) stacked
    opt_state: Any
    step: int            # a host integer: reading it never waits


def build_optimizer(tc: TrainConfig) -> Optimizer:
    if tc.optimizer == "frodo":
        return frodo(FrodoConfig(alpha=tc.alpha, beta=tc.beta, lam=tc.lam,
                                 T=tc.T, memory_mode=tc.memory_mode, K=tc.K,
                                 use_kernel=tc.use_kernel,
                                 acc_dtype=tc.acc_dtype,
                                 collect_metrics=tc.collect_metrics))
    if tc.optimizer == "no_memory":
        return baselines.no_memory(tc.alpha)
    if tc.optimizer == "heavy_ball":
        return baselines.heavy_ball(tc.alpha, tc.beta)
    if tc.optimizer == "nesterov":
        return baselines.nesterov(tc.alpha)
    if tc.optimizer == "adam":
        return baselines.adam(tc.alpha)
    raise ValueError(tc.optimizer)


def build_mixing(tc: TrainConfig, n_agents: int, n_pods: int = 1):
    """Returns (W, W_intra, W_pod) — W for flat mixing, the pair for
    hierarchical."""
    if n_agents == 1:
        return np.ones((1, 1)), None, None
    if tc.topology == "hierarchical" and n_pods > 1:
        intra = n_agents // n_pods
        W_intra = _weights(tc.weights, G.complete(intra))
        W_pod = _weights(tc.weights, G.complete(n_pods))
        return None, W_intra, W_pod
    topo = {"complete": G.complete, "ring": partial(G.ring, directed=False)}[
        tc.topology](n_agents)
    return _weights(tc.weights, topo), None, None


def _weights(kind: str, A: np.ndarray) -> np.ndarray:
    return {"uniform": G.uniform_weights, "metropolis": G.metropolis_weights,
            "xiao_boyd": G.xiao_boyd_weights}[kind](A)


# --------------------------------------------------------------- the step

def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    def loss_fn(params, batch):
        x, aux = T.forward_features(params, batch, cfg, remat=tc.remat)
        ce, metrics = chunked_cross_entropy(
            x, T.head_weight(params, cfg), batch["labels"],
            n_chunks=tc.ce_chunks, softcap=cfg.logit_softcap)
        return ce + aux, metrics
    return loss_fn


def _agent_grads(loss_fn, flat, treedef, batch, n_agents):
    """One backward for every agent: per-agent losses (A,), metrics
    {name: (A,)} and the grads, one contiguous (A, ...) tensor per leaf."""
    req = [p.detach().requires_grad_(True) for p in flat]
    views = [p.unbind(0) for p in req]
    losses, mets = [], []
    with torch.enable_grad():
        for a in range(n_agents):
            params_a = TR.unflatten(treedef, [v[a] for v in views])
            l, met = loss_fn(params_a, {k: v[a] for k, v in batch.items()})
            losses.append(l)
            mets.append(met)
        grads = torch.autograd.grad(sum(losses), req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, req)]
    loss = torch.stack([l.detach() for l in losses])
    met = {k: torch.stack([m[k].detach() for m in mets]) for k in mets[0]}
    return loss, met, grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig, n_agents: int,
                    n_pods: int = 1) -> Callable:
    """Builds train_step(state, batch) -> (state, metrics).  Batch leaves
    (numpy arrays or tensors) carry the leading agent dim A (= n_agents).
    The optimizer state is advanced in place: the state passed in is
    consumed."""
    opt = build_optimizer(tc)
    W, W_intra, W_pod = build_mixing(tc, n_agents, n_pods)
    loss_fn = make_loss_fn(cfg, tc)

    faults = None
    if tc.fault_schedule is not None and n_agents > 1:
        if W is None:
            raise ValueError("fault injection does not compose with the "
                             "hierarchical topology (flatten to complete/"
                             "ring, or drop the schedule)")
        adj = {"complete": G.complete,
               "ring": partial(G.ring, directed=False)}[tc.topology](n_agents)
        # reuse the already-built weights so the healthy-step W is identical
        # to the no-fault build
        faults = tc.fault_schedule.compile(adj, tc.fault_horizon,
                                           weight_fn=lambda _A: W)
        fault_counters = faults.counter_arrays()
        on_device = {}         # W_seq and the update mask, once per device

        def fault_arrays(dev):
            if dev not in on_device:
                on_device[dev] = (
                    torch.as_tensor(faults.update_mask, dtype=torch.float32,
                                    device=dev),
                    torch.as_tensor(faults.W_seq, dtype=torch.float32,
                                    device=dev))
            return on_device[dev]

    def agent_grads(flat, treedef, batch):
        """Per-agent (loss, metrics), grads — microbatched grad accumulation
        in f32 when tc.microbatches > 1."""
        M = tc.microbatches
        if M <= 1:
            return _agent_grads(loss_fn, flat, treedef, batch, n_agents)
        mb = {k: v.reshape((n_agents, M, v.shape[1] // M) + v.shape[2:])
              for k, v in batch.items()}
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in flat]
        l_acc, m_acc = 0.0, {"ce": 0.0, "accuracy": 0.0}
        for m in range(M):
            l, met, g = _agent_grads(loss_fn, flat, treedef,
                                     {k: v[:, m] for k, v in mb.items()},
                                     n_agents)
            g_acc = [a + b.float() for a, b in zip(g_acc, g)]
            l_acc = l_acc + l
            m_acc = {k: m_acc[k] + met[k] for k in m_acc}
        return (l_acc / M, {k: v / M for k, v in m_acc.items()},
                [x / M for x in g_acc])

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        flat, treedef = TR.flatten(state.params)
        dev = flat[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, metrics, g = agent_grads(flat, treedef, batch)
        grads = TR.unflatten(treedef, g)
        del g

        if tc.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(
                grads, float(tc.grad_clip * np.sqrt(n_agents)))
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=dev)

        if faults is not None:
            # stragglers / crashed agents: gradient discarded and update
            # withheld for the step (state moves only via consensus)
            fault_u, fault_W_seq = fault_arrays(dev)
            u_t = fault_u[state.step % fault_u.shape[0]]

            def agent_mask(t):
                return TR.tree_map(
                    lambda v: v * u_t.reshape(
                        (n_agents,) + (1,) * (v.dim() - 1)).to(v.dtype), t)

            grads = agent_mask(grads)

        delta, opt_state = opt.update(grads, state.opt_state, state.params)
        del grads
        if faults is not None:
            delta = agent_mask(delta)
        params = apply_updates(state.params, delta)
        del delta
        out_metrics = {"loss": torch.mean(loss), "grad_norm": gnorm,
                       "agent_loss": loss}
        out_metrics.update({k: torch.mean(v) for k, v in metrics.items()})
        if tc.collect_metrics:
            # optimizer aux (||M||, ||delta||; its grad_norm is post-clip —
            # the pre-clip gnorm above wins the key)
            if isinstance(opt_state, dict):
                for k, v in opt_state.get("metrics", {}).items():
                    out_metrics.setdefault(k, v)
            out_metrics["consensus_error_pre_mix"] = \
                obs_metrics.consensus_error(params)

        # stage 3: consensus over the agent dim
        if n_agents > 1 and state.step % tc.consensus_interval == 0:
            if faults is not None:
                params = C.mix_time_varying(params, fault_W_seq, state.step)
            elif W is None:
                params = C.mix_hierarchical(params, W_intra, W_pod,
                                            state.step, tc.cross_pod_period)
            else:
                params = C.mix_stacked(params, W)

        if tc.collect_metrics:
            out_metrics["consensus_error"] = obs_metrics.consensus_error(
                params)
            out_metrics["param_norm"] = obs_metrics.global_norm(params)
            if faults is not None:
                t = state.step % faults.n_steps
                out_metrics.update({k: v[t]
                                    for k, v in fault_counters.items()})
        return TrainState(params, opt_state, state.step + 1), out_metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tc: TrainConfig, n_agents: int,
                     device=None) -> TrainState:
    """Random init on ``device`` (``gen`` lives there).  Every agent gets
    its own draw: the paper starts agents at distinct states."""
    params = T.init_params(gen, cfg, (n_agents,), device)
    return train_state_from_params(params, tc)


def train_state_from_params(params: Any, tc: TrainConfig) -> TrainState:
    """A fresh state (optimizer initialised, step 0) around stacked
    parameters — for example the JAX package's, carried across with
    ``repro_torch.convert.params_from_numpy``."""
    return TrainState(params, build_optimizer(tc).init(params), 0)
