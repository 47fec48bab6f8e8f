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

**Agent-sharded.**  Given a process group of w ranks, rank r holds agents
``[r·A/w, (r+1)·A/w)`` of that layout (the JAX package shards the agent
dim over the agent mesh axes).  The per-agent work and the update are
local; what spans agents goes through ``torch.distributed``: the gradient
clip's norm (each rank's squared sum, all-reduced), the consensus (a
uniform complete W through ``mix_uniform_constrained``, as the JAX step
does under a mesh; every other W, the fault schedule's W_t and the
hierarchical schedule's Kronecker factors included, through
``general_mix``), and the metrics.  The result is the one-process stacked
run's to f32 rounding (bit for bit at one rank).

**On a mesh.**  Built under ``use_rules(build_rules(...), mesh)`` with a
mesh whose axes that carry no agents are not all 1 wide (a "model" axis
wider than 1, or data axes of the batch and fsdp rules: the five fsdp
configs, whose agents go over "pod" or are one), every rank holds its
local shard of each leaf of the state under ``train_state_specs``
(``repro_torch.convert`` cuts them) and its rows of its agents' batch
under ``batch_specs`` (the rows divisible by the batch axes).  The agents
go over the rules' agent axes, the model runs split over the "model"
axis, and each layer's fsdp leaves are gathered over the data axes at use
(their gradients reduce-scattered back).  The loss is the ratio of sums
over every rank's rows; the gradients of the leaves not split over the
batch axes are summed over them in f32, once a step, after the
microbatches' accumulation.  With ``microbatches`` M > 1, microbatch m
is the JAX step's: rows ``[m·B/M, (m+1)·B/M)`` of the agent's batch,
wherever they lie, each rank holding its B/(M·D) of them
(``microbatch_rows``: the batch's int rows all-gathered over the batch
axes once a step); the loss, MoE's capacity and means then span that
microbatch's rows on every rank.  A leaf is counted once in the clip's
norm and in the metrics (where this rank's coordinate is 0 on every
non-agent axis that replicates it), whose sums then span the whole mesh.
The FrODO update runs on the local shards, in place.

The sharding-spec functions (``build_rules``, ``param_specs``,
``train_state_specs``, ...) give the JAX package's specs for the same
trees.
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
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
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


def build_optimizer(tc: TrainConfig, counted=None) -> Optimizer:
    """``counted``: FrODO's per-leaf flags for its in-step norms
    (``frodo``); the baselines keep no norms."""
    if tc.optimizer == "frodo":
        return frodo(FrodoConfig(alpha=tc.alpha, beta=tc.beta, lam=tc.lam,
                                 T=tc.T, memory_mode=tc.memory_mode, K=tc.K,
                                 use_kernel=tc.use_kernel,
                                 acc_dtype=tc.acc_dtype,
                                 collect_metrics=tc.collect_metrics),
                     counted)
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


# ------------------------------------------------------------------ rules
# The spec functions take any mesh that ``SH.mesh_axis_sizes`` reads (a
# ``DeviceMesh``, or an object with ``axis_names`` and ``devices.shape``)
# and trees of tensors (``meta`` ones at full size) or of anything with a
# ``shape``; a leaf without one (the optimizer's host-integer step) is a
# scalar.

def build_rules(cfg: ModelConfig, multi_pod: bool) -> Dict[str, Any]:
    agent_axes = cfg.agent_axes_multi if multi_pod else cfg.agent_axes_single
    all_data = ("pod", "data") if multi_pod else ("data",)
    leftover = tuple(a for a in all_data if a not in agent_axes)
    rules = dict(SH.DEFAULT_RULES)
    rules["agent"] = tuple(agent_axes) or None
    rules["batch"] = leftover or None
    rules["fsdp"] = leftover if (cfg.fsdp and leftover) else None
    return rules


def serve_rules(cfg: ModelConfig, multi_pod: bool, batch: int,
                mesh, weights_fsdp: bool = False) -> Dict[str, Any]:
    """Serving has no agents: batch over the data axes when divisible, else
    the KV sequence dim takes them (flash-decode style cache split).

    ``weights_fsdp`` additionally shards weights over the data axes
    (gathered per layer at use) — required to fit models whose TP-sharded
    weights alone exceed a device's memory (kimi-k2)."""
    sizes = SH.mesh_axis_sizes(mesh)
    all_data = ("pod", "data") if multi_pod else ("data",)
    total = int(np.prod([sizes[a] for a in all_data]))
    rules = dict(SH.DEFAULT_RULES)
    rules["agent"] = None
    if batch % total == 0 and batch >= total:
        rules["batch"] = all_data
        rules["kv_seq"] = "model"       # split long caches across TP shards
    else:
        rules["batch"] = None
        rules["kv_seq"] = all_data + ("model",)
    rules["fsdp"] = all_data if weights_fsdp else None
    return rules


def n_agents_for(cfg: ModelConfig, mesh, multi_pod: bool) -> int:
    sizes = SH.mesh_axis_sizes(mesh)
    axes = cfg.agent_axes_multi if multi_pod else cfg.agent_axes_single
    return int(np.prod([sizes[a] for a in axes])) if axes else 1


# ------------------------------------------------------------- spec trees

def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def sanitize_specs(specs: Any, shapes: Any, mesh) -> Any:
    """Drop mesh axes from dims they don't divide."""
    sizes = SH.mesh_axis_sizes(mesh)
    return TR.tree_map(
        lambda spec, leaf: SH.divisible_spec(spec, _shape(leaf), sizes),
        specs, shapes)


def param_specs(param_shapes: Any, rules: Dict[str, Any], mesh,
                agent_stacked: bool = True) -> Any:
    specs = SH.spec_tree(param_shapes, rules, agent_stacked=agent_stacked)
    return sanitize_specs(specs, param_shapes, mesh)


def opt_state_specs(opt_shapes: Any, p_specs: Any, param_shapes: Any,
                    mesh) -> Any:
    """Derive optimizer-state specs from param specs: leaves whose shape is
    (X,) + param_shape get (None,) + param_spec; same-shape leaves inherit.
    The optimizers' state paths are the JAX package's ("hist/<param
    path>", "acc/...", "m/...", "v/...", "mom/..."), so the same match
    finds them."""
    flat_p = SH.flatten_with_paths(param_shapes)
    flat_ps = SH.flatten_with_paths(p_specs)

    def match(path: str, leaf):
        parts = path.split("/", 1)
        if len(parts) == 2 and parts[1] in flat_p:
            pshape = _shape(flat_p[parts[1]])
            pspec = flat_ps[parts[1]]
            if _shape(leaf) == pshape:
                return pspec
            if _shape(leaf)[1:] == pshape:
                return SH.P(*((None,) + tuple(pspec)))
        return SH.P()

    flat_o = SH.flatten_with_paths(opt_shapes)
    return SH.unflatten_with_paths({p: match(p, l)
                                    for p, l in flat_o.items()})


_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "ssm": ("batch", "heads", None, None),
    "conv": ("batch", None, "mlp"),
    "h": ("batch", "mlp"),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "cross_k": ("batch", "frames", "kv_heads", None),
    "cross_v": ("batch", "frames", "kv_heads", None),
}


def _last_keys(tree: Any, key: str = ""):
    """Each leaf's own key (dict key or NamedTuple field), in
    ``tree.flatten`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _last_keys(tree[k], k)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _last_keys(getattr(tree, k), k)
    else:
        yield key


def cache_specs(cache_shapes: Any, rules: Dict[str, Any], mesh) -> Any:
    """Specs for the decode cache: leaves are matched by their final field
    name (KVCache.k, MambaCache.ssm, ...); every leaf carries a leading
    layer-stack dim."""
    flat, treedef = TR.flatten(cache_shapes)
    specs = []
    for key, leaf in zip(_last_keys(cache_shapes), flat):
        nd = len(_shape(leaf))
        axes = (None,) + _CACHE_AXES.get(key, ())   # layer-stack dim
        specs.append(SH.logical_to_spec((axes + (None,) * nd)[:nd], rules))
    return sanitize_specs(TR.unflatten(treedef, specs), cache_shapes, mesh)


def batch_specs_serve(batch_shapes: Dict[str, Any], rules: Dict[str, Any],
                      mesh) -> Dict[str, Any]:
    """Serving batch: (B, S[, ...]) -> (batch, None, ...)."""
    specs = TR.tree_map(lambda leaf: SH.logical_to_spec(
        ("batch",) + (None,) * (len(_shape(leaf)) - 1), rules), batch_shapes)
    return sanitize_specs(specs, batch_shapes, mesh)


def batch_specs(batch_shapes: Dict[str, Any], rules: Dict[str, Any],
                mesh) -> Dict[str, Any]:
    """Training batch: (A, B_local, S[, ...]) -> (agent, batch, None...)."""
    specs = TR.tree_map(lambda leaf: SH.logical_to_spec(
        ("agent", "batch") + (None,) * (len(_shape(leaf)) - 2), rules),
        batch_shapes)
    return sanitize_specs(specs, batch_shapes, mesh)


def train_state_specs(state_shapes: "TrainState", cfg: ModelConfig,
                      rules: Dict[str, Any], mesh) -> "TrainState":
    ps = param_specs(state_shapes.params, rules, mesh, agent_stacked=True)
    os_ = opt_state_specs(state_shapes.opt_state, ps, state_shapes.params,
                          mesh)
    os_ = sanitize_specs(os_, state_shapes.opt_state, mesh)
    return TrainState(ps, os_, SH.P())


def abstract_train_state(cfg: ModelConfig, tc: "TrainConfig",
                         n_agents: int) -> "TrainState":
    """The train state on the ``meta`` device: shapes and dtypes, no
    storage (the dry-run's counterpart of JAX's ``eval_shape``)."""
    return init_train_state(torch.Generator(), cfg, tc, n_agents, "meta")


# --------------------------------------------------------------- the step

def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    def loss_fn(params, batch):
        x, aux = T.forward_features(params, batch, cfg, remat=tc.remat)
        ce, metrics = chunked_cross_entropy(
            x, T.head_weight(params, cfg), batch["labels"],
            n_chunks=tc.ce_chunks, softcap=cfg.logit_softcap,
            vocab=cfg.vocab)
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


def _global_norm(tree: Any, group=None) -> torch.Tensor:
    """The L2 norm over every leaf of every agent: the squares summed in
    f32 in leaf order (``loss.global_norm``'s sum), and with a ``group``
    each rank's sum all-reduced before the root."""
    sq = obs_metrics.tree_sq_sum(tree)
    if group is not None:
        comm.all_reduce_sum(sq, group)
    return torch.sqrt(sq)


def _tp_global_norm(tree: Any, counted) -> torch.Tensor:
    """The L2 norm over every leaf of every agent when each rank holds its
    shards: each rank's squares of the leaves flagged in ``counted``,
    summed over the whole mesh (the default group)."""
    return torch.sqrt(comm.all_reduce_sum(
        obs_metrics.tree_sq_sum(tree, counted), None))


def _non_agent_axes(rules: Dict[str, Any], mesh) -> Tuple[str, ...]:
    agents = set(SH.axes_of(rules.get("agent")))
    return tuple(a for a in mesh.mesh_dim_names if a not in agents)


def _leaf_axes(cfg: ModelConfig, n_agents: int, rules: Dict[str, Any],
               mesh) -> list:
    """Per param leaf (``tree.leaves`` order): the mesh axes that split
    it under ``param_specs``."""
    shapes = T.init_params(torch.Generator(), cfg, (n_agents,), "meta")
    specs = param_specs(shapes, rules, mesh, agent_stacked=True)
    return [{a for p in spec for a in SH.axes_of(p)}
            for spec in TR.leaves(specs)]


def model_counted(cfg: ModelConfig, n_agents: int, rules: Dict[str, Any],
                  mesh) -> list:
    """Per param leaf (``tree.leaves`` order): whether this rank counts it
    in a sum over the mesh: where its coordinate is 0 on every non-agent
    axis over which the leaf is replicated (the model axis, and the data
    axes of the batch and fsdp rules)."""
    coords = SH.mesh_coords(mesh)
    others = _non_agent_axes(rules, mesh)
    return [all(coords[a] == 0 for a in others if a not in used)
            for used in _leaf_axes(cfg, n_agents, rules, mesh)]


def batch_summed(cfg: ModelConfig, n_agents: int, rules: Dict[str, Any],
                 mesh) -> list:
    """Per param leaf: whether its gradient is summed over the "batch"
    rule's axes after the backward: every leaf not split over them (an
    fsdp-split leaf gets that sum from its gather's reduce-scatter)."""
    rows = set(SH.axes_of(rules.get("batch")))
    return [not rows & used
            for used in _leaf_axes(cfg, n_agents, rules, mesh)]


class Layout(NamedTuple):
    """Where a step's rank sits on the active mesh."""
    sharded: bool        # some non-agent axis is wider than 1
    group: Any           # the agents' group (None: every agent here)
    counted: Optional[list]              # ``model_counted``'s flags
    rows: Optional[SH.DataAxes]          # the batch rule's axes
    summed: Optional[list]               # ``batch_summed``'s flags


def _layout(cfg: ModelConfig, n_agents: int, group) -> Layout:
    """The step's layout under the active rules and mesh: sharded
    whenever an axis that does not carry agents is wider than 1 (the
    model axis, or the data axes of the batch and fsdp rules), with the
    agents' group from the rules' agent axes unless ``group`` is given;
    else the agent-sharded or one-process layout around ``group``."""
    mesh, rules = SH.current_mesh(), SH.current_rules()
    if mesh is None or rules is None:
        return Layout(False, group, None, None, None)
    sizes = SH.mesh_axis_sizes(mesh)
    if all(sizes[a] == 1 for a in _non_agent_axes(rules, mesh)):
        return Layout(False, group, None, None, None)
    if group is None and SH.axes_of(rules.get("agent")):
        group = SH.axes_group(mesh, SH.axes_of(rules["agent"]))
    rows = SH.data_axes("batch")
    return Layout(True, group, model_counted(cfg, n_agents, rules, mesh),
                  rows,
                  None if rows is None else
                  batch_summed(cfg, n_agents, rules, mesh))


#: the f32 bytes of one all-reduce of ``_sum_over_rows`` (a larger leaf
#: goes alone)
ROWS_BUCKET_BYTES = 1 << 28


def _sum_over_rows(grads: list, summed: list, rows: SH.DataAxes) -> list:
    """Each flagged gradient summed over the batch axes in f32, rounded
    once to its dtype; the small ones packed into all-reduces of up to
    ``ROWS_BUCKET_BYTES``."""
    out = list(grads)
    bucket, size = [], 0

    def flush():
        if bucket:
            # a leaf alone is summed in its f32 copy (or in place: it is
            # replaced by the sum)
            parts = [grads[i].reshape(-1).float() for i in bucket]
            flat = comm.all_reduce_sum(
                parts[0] if len(parts) == 1 else torch.cat(parts),
                rows.group)
            for i, part in zip(bucket, flat.split(
                    [grads[i].numel() for i in bucket])):
                out[i] = part.reshape(grads[i].shape).to(grads[i].dtype)
            bucket.clear()

    for i, flag in enumerate(summed):
        if not flag:
            continue
        n = grads[i].numel() * 4
        if size + n > ROWS_BUCKET_BYTES:
            flush()
            size = 0
        bucket.append(i)
        size += n
    flush()
    return out


def microbatch_rows(batch: Dict[str, torch.Tensor], M: int,
                    rows: Optional[SH.DataAxes]) -> Dict[str, torch.Tensor]:
    """This rank's rows of each of ``M`` microbatches, ``(A, M, b, ...)`` a
    leaf: microbatch m is rows ``[m·B/M, (m+1)·B/M)`` of the agent's B rows
    (the JAX step's reshape of the agent's batch), cut over the batch
    rule's axes (``rows``: D ranks, each holding a block of B/D rows) as
    ``batch_specs`` cuts a batch, b = B/(M·D) of them here.  With D > 1
    the leaves of one dtype are all-gathered over those axes in one call
    (the int tokens and labels: no activation), once a step."""
    D = 1 if rows is None else rows.size
    for k, v in batch.items():
        if v.shape[1] % M:
            raise ValueError(
                f"{k}: {v.shape[1]} rows do not split into {M} microbatches"
                if D == 1 else
                f"{k}: the agent's {v.shape[1] * D} rows make {M} "
                f"microbatches of {v.shape[1] * D / M:g} rows, which do not "
                f"split over the batch axes' {D} ranks")
    if rows is None:
        return {k: v.reshape((v.shape[0], M, v.shape[1] // M) + v.shape[2:])
                for k, v in batch.items()}
    out = {}
    for dtype in dict.fromkeys(v.dtype for v in batch.values()):
        keys = [k for k, v in batch.items() if v.dtype == dtype]
        A, B_loc = batch[keys[0]].shape[:2]
        flat = [batch[k].reshape(A, B_loc, -1) for k in keys]
        parts = comm.all_gather(torch.cat(flat, dim=2), rows.group)
        # (D, A, B/D, n) -> (A, M, D, b, n): this rank's b rows of each
        mine = parts.movedim(0, 1).reshape(A, M, D, B_loc // M, -1)[
            :, :, rows.rank]
        for k, part in zip(keys, mine.split([f.shape[2] for f in flat],
                                            dim=3)):
            out[k] = part.reshape((A, M, B_loc // M) + batch[k].shape[2:])
    return {k: out[k] for k in batch}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, n_agents: int,
                    n_pods: int = 1, group=None) -> Callable:
    """Builds train_step(state, batch) -> (state, metrics).  Batch leaves
    (numpy arrays or tensors) carry the leading agent dim: all A
    (= n_agents) agents, or with a process ``group`` (``distributed.comm``)
    this rank's A / world of them, as its state does.  The optimizer state
    is advanced in place: the state passed in is consumed.  Built under
    ``use_rules(rules, mesh)`` with an axis that carries no agents wider
    than 1 (the model axis, the data axes of the batch and fsdp rules),
    the step runs on this rank's shards and rows (module docstring); its
    agents' group is then the rules' agent axes unless ``group`` is
    given."""
    lay = _layout(cfg, n_agents, group)
    group, counted = lay.group, lay.counted
    opt = build_optimizer(tc, counted)
    W, W_intra, W_pod = build_mixing(tc, n_agents, n_pods)
    loss_fn = make_loss_fn(cfg, tc)
    A_loc, lo = n_agents, 0
    if group is not None:
        world = comm.world_size(group)
        if n_agents % world:
            raise ValueError(f"{n_agents} agents do not split over {world} "
                             f"ranks")
        A_loc = n_agents // world
        lo = comm.rank(group) * A_loc

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
        in f32 when tc.microbatches > 1 (``microbatch_rows``: microbatch m
        is the JAX step's, this rank's part of it)."""
        M = tc.microbatches
        if M <= 1:
            return _agent_grads(loss_fn, flat, treedef, batch, A_loc)
        mb = microbatch_rows(batch, M, lay.rows)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in flat]
        l_acc, m_acc = 0.0, {"ce": 0.0, "accuracy": 0.0}
        for m in range(M):
            l, met, g = _agent_grads(loss_fn, flat, treedef,
                                     {k: v[:, m] for k, v in mb.items()},
                                     A_loc)
            g_acc = [a + b.float() for a, b in zip(g_acc, g)]
            l_acc = l_acc + l
            m_acc = {k: m_acc[k] + met[k] for k in m_acc}
        return (l_acc / M, {k: v / M for k, v in m_acc.items()},
                [x / M for x in g_acc])

    def mix(params, step: int, dev):
        """Stage 3: consensus over the agent dim."""
        if group is None:
            if faults is not None:
                return C.mix_time_varying(params, fault_arrays(dev)[1], step)
            if W is None:
                return C.mix_hierarchical(params, W_intra, W_pod, step,
                                          tc.cross_pod_period)
            return C.mix_stacked(params, W)
        if faults is not None:
            W_seq = fault_arrays(dev)[1]
            return C.general_mix(params, W_seq[step % W_seq.shape[0]], group)
        if W is None:
            cross = step % tc.cross_pod_period == 0
            return C.general_mix(params, np.kron(
                W_pod if cross else np.eye(n_pods), W_intra), group)
        if C.is_uniform_complete(W):
            return C.mix_uniform_constrained(params, group, n_agents)
        return C.general_mix(params, W, group)

    def gather_agents(loss, metrics):
        """Per-agent loss and metrics of all A agents, (A,) each."""
        if group is None:
            return loss, metrics
        keys = sorted(metrics)
        packed = torch.stack([loss.float()] + [metrics[k].float()
                                               for k in keys], dim=1)
        allp = comm.all_gather(packed, group).reshape(n_agents, -1)
        return allp[:, 0], {k: allp[:, i + 1] for i, k in enumerate(keys)}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        flat, treedef = TR.flatten(state.params)
        dev = flat[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, metrics, g = agent_grads(flat, treedef, batch)
        if lay.summed is not None:
            g = _sum_over_rows(g, lay.summed, lay.rows)
        grads = TR.unflatten(treedef, g)
        del g

        if tc.grad_clip > 0:
            norm = (_tp_global_norm(grads, counted) if lay.sharded
                    else _global_norm(grads, group))
            grads, gnorm = clip_by_global_norm(
                grads, float(tc.grad_clip * np.sqrt(n_agents)), norm=norm)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=dev)

        if faults is not None:
            # stragglers / crashed agents: gradient discarded and update
            # withheld for the step (state moves only via consensus)
            fault_u = fault_arrays(dev)[0]
            u_t = fault_u[state.step % fault_u.shape[0]][lo:lo + A_loc]

            def agent_mask(t):
                return TR.tree_map(
                    lambda v: v * u_t.reshape(
                        (A_loc,) + (1,) * (v.dim() - 1)).to(v.dtype), t)

            grads = agent_mask(grads)

        delta, opt_state = opt.update(grads, state.opt_state, state.params)
        del grads
        if faults is not None:
            delta = agent_mask(delta)
        params = apply_updates(state.params, delta)
        del delta
        loss, metrics = gather_agents(loss, metrics)
        out_metrics = {"loss": torch.mean(loss), "grad_norm": gnorm,
                       "agent_loss": loss}
        out_metrics.update({k: torch.mean(v) for k, v in metrics.items()})
        if tc.collect_metrics:
            # optimizer aux (||M||, ||delta||; its grad_norm is post-clip —
            # the pre-clip gnorm above wins the key); norms over every
            # rank's agents
            if isinstance(opt_state, dict):
                for k, v in opt_state.get("metrics", {}).items():
                    if lay.sharded:          # every rank's counted leaves
                        v = torch.sqrt(comm.all_reduce_sum(v * v, None))
                    elif group is not None:
                        v = torch.sqrt(comm.all_reduce_sum(v * v, group))
                    out_metrics.setdefault(k, v)
            out_metrics["consensus_error_pre_mix"] = \
                obs_metrics.consensus_error(params, group, counted)

        if n_agents > 1 and state.step % tc.consensus_interval == 0:
            params = mix(params, state.step, dev)

        if tc.collect_metrics:
            out_metrics["consensus_error"] = obs_metrics.consensus_error(
                params, group, counted)
            out_metrics["param_norm"] = (
                _tp_global_norm(params, counted) if lay.sharded
                else _global_norm(params, group))
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
