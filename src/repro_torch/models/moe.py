"""Mixture-of-Experts with top-k routing and sort-based capacity dispatch:
the port of the JAX package's ``repro.models.moe``.

Tokens never build a (tokens x experts x capacity) one-hot:

  1. route: top-k expert ids and weights per token (the router in f32);
  2. each assignment's position inside its expert, from a stable sort by
     expert id (running index minus the expert's offset);
  3. scatter the token embeddings into an (E, C, d) capacity buffer; an
     assignment past its expert's capacity C goes to a spare slot that is
     thrown away (``capacity_factor`` sets C);
  4. the batched expert MLP over the buffer;
  5. gather each assignment's output back and combine with the router
     weights.

The combine adds a token's k terms one after another in assignment order
(j = 0..k-1), rounding to the output dtype after each add, as the JAX
package's scatter-add does; ``index_add_`` would add them with float
atomics in an order that changes from run to run.  The gate and up
products are two batched matmuls over the same buffer: the JAX code
concatenates the two weight stacks first, which here would copy 2/3 of the
expert weights on every call.

A caller that must never drop (decode at one position per row, where the
JAX package routes each row alone and a token's k distinct experts always
fit) passes ``min_capacity`` = the row count.

``dispatch_groups`` = G > 1 splits the N tokens into G groups of N/G (the
data-parallel shards of the JAX package's mesh): each group has its own
capacity ``_capacity(N/G)`` (raised to ``min_capacity``) and scatters only
its own tokens, into its own C rows of each expert in one (E, G*C, d)
buffer (the JAX package's (G, E, C, d) buffer with each expert's groups
side by side), so the expert products stay one batched matmul over E; the
combine stays within each group.

Tensor-parallel over the "expert" axis (the JAX rules: ``experts/*``
split on the expert dim, the router replicated), every rank routes every
token and builds the whole buffer, runs its E/m experts' rows, combines
only their terms (in f32) and sums the result over the axis, rounded
once.  ``copy_to_model`` stands at the entry of the expert region, on the
buffer and on ``top_w``, not on the router weight: the aux losses are
computed whole on every rank, so the router's gradient is whole there.

With the agent's rows split over the "batch" rule's data axes (the JAX
rules of an fsdp config), a dispatch group spans every rank's rows, as the
JAX package's one group spans the agent's whole batch: the capacity is
that of the group's tokens, and each rank takes each expert's
assignments on the ranks ahead of it from their counts (one small
all-gather of the routing, not of the tokens), so an assignment drops
where it drops in one process.  The aux losses' means run over every
rank's rows (one f32 all-reduce).

Aux losses: load balance (Switch-style) and router z-loss, returned for
the trainer to add.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L


def moe_init(gen, cfg: ModelConfig, lead: tuple = (), device=None) -> dict:
    dt = L.dtype_of(cfg.param_dtype)
    m = cfg.moe
    d, ff, E = cfg.d_model, m.expert_d_ff, m.n_experts
    lead = tuple(lead)
    kw = dict(dtype=dt, lead=lead + (E,), device=device)
    p = {"router": {"w": L.dense_init(gen, d, E, dtype=torch.float32,
                                      lead=lead, device=device)},
         "experts": {"gate": L.dense_init(gen, d, ff, **kw),
                     "up": L.dense_init(gen, d, ff, **kw),
                     "down": L.dense_init(gen, ff, d, **kw)}}
    if m.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, m.shared_d_ff or m.expert_d_ff,
                                 True, dt, lead, device)
    return p


def no_drop(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with an expert capacity of every token (capacity factor
    E/k), so a MoE forward drops nothing, as decode never does; a config of
    another family as it is."""
    if cfg.family != "moe":
        return cfg
    m = cfg.moe
    return cfg.replace(moe=m.__class__(**{
        **m.__dict__, "capacity_factor": m.n_experts / m.top_k}))


def _capacity(n_tokens: int, m) -> int:
    c = int(np.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, int(np.ceil(c / 8)) * 8)


def _expert_counts(e: torch.Tensor, E: int) -> torch.Tensor:
    """``bincount(e, minlength=E)`` for expert ids below E, exact, by an
    integer scatter-add (which, unlike ``bincount``, also runs on the
    ``meta`` device: the dry-run's shape-only steps)."""
    return torch.zeros(E, dtype=torch.long, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))


def _dispatch_one(xt, top_e, E: int, k: int, C: int, before=None):
    """Sort-based dispatch of one token group.  xt: (n, d); top_e: (n, k).
    Returns the (E, C, d) buffer, each assignment's buffer row ``dest``
    (E*C where it dropped), ``keep`` and ``token_idx``, all (n*k,).
    ``before`` (E,): each expert's assignments of the group's tokens that
    other ranks hold ahead of these (its rows split over the batch axes):
    an assignment keeps its place in the group's order, ``before`` plus
    its place here, and drops past C; it is written at its place here."""
    n, d = xt.shape
    dev = xt.device
    flat_e = top_e.reshape(-1)                             # (n*k,)
    order = torch.sort(flat_e, stable=True).indices
    counts = _expert_counts(flat_e, E)                     # tokens per expert
    starts = torch.cumsum(counts, 0) - counts              # offset per expert
    rank_sorted = torch.arange(n * k, device=dev) - starts[flat_e[order]]
    pos_in_e = torch.empty_like(rank_sorted).index_put_((order,),
                                                        rank_sorted)
    keep = pos_in_e < C if before is None else \
        pos_in_e + before[flat_e] < C                      # capacity drop
    dest = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))   # E*C: drop slot
    token_idx = torch.arange(n, device=dev).repeat_interleave(k)
    buf = xt.new_zeros((E * C + 1, d)).index_put((dest,), xt[token_idx])
    return buf[:-1].reshape(E, C, d), dest, keep, token_idx


def route(params: dict, xt: torch.Tensor, cfg: ModelConfig):
    """The f32 router: ``(logits, probs, top_w, top_e)`` of tokens (N, d),
    top_w renormalised over the k chosen experts."""
    logits = xt.float() @ params["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_e


def moe_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
            min_capacity: int = 0, with_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar, or None
    without ``with_aux``: decode drops it, which the JAX package's compiler
    does for it).  The expert capacity is the JAX package's, per dispatch
    group, raised to ``min_capacity``: at the token count or above nothing
    drops, so decode at one position per row takes any row count."""
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    E, k = m.n_experts, m.top_k
    G = max(1, m.dispatch_groups)
    split = SH.data_axes("batch")
    if min_capacity >= N:
        G, split = 1, None  # no group can drop: the split changes nothing
    D = 1 if split is None else split.size
    if (N * D) % G:
        raise ValueError(f"{N * D} tokens do not split into {G} dispatch "
                         f"groups")
    C = max(_capacity(N * D // G, m), min_capacity)
    span = 1                           # ranks whose rows one group spans
    if G % D == 0:
        G //= D                        # this rank's rows: whole groups
    elif D % G == 0:
        span, G = D // G, 1
    else:
        raise ValueError(f"{G} dispatch groups over {D} ranks' rows")
    n = N // G
    xt = x.reshape(N, d)

    logits, probs, top_w, top_e = route(params, xt, cfg)
    before = None
    if span > 1:
        # the routing, not the tokens: each expert's assignments on the
        # ranks ahead of this one in its group
        counts = comm.all_gather(_expert_counts(top_e.reshape(-1), E),
                                 split.group)              # (D, E)
        before = counts[split.rank - split.rank % span:split.rank].sum(0)
    parts = [_dispatch_one(xt[g * n:(g + 1) * n], top_e[g * n:(g + 1) * n],
                           E, k, C, before) for g in range(G)]
    # one (E, G*C, d) buffer: each expert's rows of every group, so the
    # expert products are one batched matmul over E
    buf = parts[0][0] if G == 1 else torch.stack(
        [p[0] for p in parts], dim=1).reshape(E, G * C, d)
    # each assignment's row of it (a row past the end where it dropped)
    rows = torch.cat([
        torch.where(keep, (dest // C) * (G * C) + g * C + dest % C,
                    torch.full_like(dest, E * G * C))
        for g, (_, dest, keep, _) in enumerate(parts)])
    keep = torch.cat([p[2] for p in parts])

    ex = params["experts"]
    tp = L.split_axis(ex["gate"].shape[0], E)
    w = top_w.reshape(-1)
    R = E * G * C
    if tp is not None:
        # this rank's experts: rows [lo, lo + R_loc) of the buffer, whose
        # gradient (and top_w's) each rank holds a part of
        R_loc = R // tp.size
        lo = tp.rank * R_loc
        buf = comm.copy_to_model(buf, tp.group)[tp.rank * (E // tp.size):
                                                (tp.rank + 1) * (E // tp.size)]
        w = comm.copy_to_model(w, tp.group)
        keep = keep & (rows >= lo) & (rows < lo + R_loc)
        rows, R = rows - lo, R_loc

    # ---- batched expert MLP: (E, G*C, d) x (E, d, ff)
    h = L.activation(cfg.activation)(torch.bmm(buf, ex["gate"])) \
        * torch.bmm(buf, ex["up"])
    out_buf = torch.bmm(h, ex["down"])                     # (E, G*C, d)

    # ---- gather back and combine (within each group: a token's k rows
    # are its group's), term by term in assignment order
    gathered = out_buf.reshape(R, d)[torch.clamp(rows, 0, R - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=x.device))
    if tp is not None:
        # the local experts' terms in f32, summed over the axis, rounded
        # once
        terms = (gathered.float() * w[:, None]).reshape(N, k, d)
        out = terms.sum(dim=1)
        out = comm.reduce_from_model(out, tp.group)
    else:
        terms = (gathered * w[:, None].to(gathered.dtype)).reshape(N, k, d)
        out = terms[:, 0]
        for j in range(1, k):
            out = out + terms[:, j]
    out = out.reshape(B, S, d).to(x.dtype)

    if "shared" in params:
        m_sh = cfg.moe
        out = out + L.mlp(params["shared"], x, cfg.activation,
                          m_sh.shared_d_ff or m_sh.expert_d_ff)

    if not with_aux:
        return out, None
    # ---- aux losses (f32), means over the agent's whole batch
    sums, ranks = _over_batch(torch.cat([
        probs.sum(dim=0), _expert_counts(top_e.reshape(-1), E).float(),
        torch.square(torch.logsumexp(logits, dim=-1)).sum()[None]]))
    me = sums[:E] / (N * ranks)                            # mean router prob
    ce = sums[E:2 * E] / (N * ranks * k)
    load_balance = E * torch.sum(me * ce)
    z_loss = sums[-1] / (N * ranks)
    aux = m.router_aux_weight * (load_balance + 0.001 * z_loss)
    return out, aux


def _over_batch(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(``t`` summed over the "batch" rule's data axes, in f32, and their
    size), or (``t``, 1) where the rows are whole here.  Every rank then
    holds the whole batch's loss; the backward passes each rank the
    gradient of its own rows' terms."""
    split = SH.data_axes("batch")
    if split is None:
        return t, 1
    return comm.reduce_from_model(t, split.group), split.size
