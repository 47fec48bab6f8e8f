"""Losses and gradient clipping: the port of the JAX package's
``repro.training.loss``.

With a vocab-split head (tensor-parallel over the "model" axis) the
chunked cross-entropy takes the log-sum-exp from an all-reduced max and
sum of exponentials, the target logit from the rank whose columns hold
it, and accuracy's argmax over every rank's columns (the lowest global
index among ties, as ``jnp.argmax``).  With the agent's rows split over
the "batch" rule's data axes, the loss and accuracy are ratios of sums
over every rank's rows, as over the whole batch in one process."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as TR
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.obs import metrics as obs_metrics


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict]:
    """Token-mean CE.  logits (..., V) any float dtype; labels (...) int,
    negative labels are masked out."""
    lf = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    ce = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (ce * mask).sum() / denom
    out = loss
    if z_loss > 0:
        out = out + z_loss * ((lse ** 2) * mask).sum() / denom
    acc = ((lf.argmax(-1) == labels) * mask).sum() / denom
    return out, {"ce": loss, "accuracy": acc}


def _ce_chunk(xc, head_w, lc, softcap):
    logits = (xc @ head_w).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
    mask = (lc >= 0).float()
    correct = ((logits.argmax(-1) == lc) * mask).sum()
    return ((lse - gold) * mask).sum(), mask.sum(), correct


def _ce_chunk_split(xc, head_w, lc, softcap, vocab):
    """``_ce_chunk`` over this rank's columns of a vocab-split head."""
    tp = L.split_axis(head_w.shape[-1], vocab)
    logits = L._logits(xc, head_w, vocab, softcap)
    top = comm.all_reduce_max(logits.detach().amax(dim=-1), tp.group)
    se = torch.exp(logits - top[..., None]).sum(dim=-1)
    lse = torch.log(comm.reduce_from_model(se, tp.group)) + top
    n = logits.shape[-1]
    local = lc - tp.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = comm.reduce_from_model(
        torch.where(inside, gold[..., 0], torch.zeros_like(gold[..., 0])),
        tp.group)
    mask = (lc >= 0).float()
    correct = ((L.vocab_argmax(logits.detach(), vocab) == lc) * mask).sum()
    return ((lse - gold) * mask).sum(), mask.sum(), correct


def chunked_cross_entropy(x, head_w, labels, n_chunks: int = 8,
                          softcap: float = 0.0,
                          vocab: Optional[int] = None):
    """CE over (B,S,d) features without materializing (B,S,V) fp32 logits:
    rows are processed in checkpointed chunks, so the backward recomputes
    each chunk's logits instead of keeping them live (the fused-CE pattern).

    x: (B,S,d); head_w: (d,V); labels: (B,S) int (negatives masked).
    Returns (loss, metrics) like ``cross_entropy``.  ``n_chunks`` is halved
    until it divides B*S (this rank's rows under the "batch" rule).  ``vocab``: the full vocabulary, which tells this
    rank's columns of a vocab-split head from a whole one (None: whole)."""
    B, S, d = x.shape
    N = B * S
    while N % n_chunks:
        n_chunks //= 2
    n_chunks = max(n_chunks, 1)
    xr = x.reshape(n_chunks, N // n_chunks, d)
    lr = labels.long().reshape(n_chunks, N // n_chunks)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ce_sum, mask_sum, corr = zero, zero, zero
    split = L.split_axis(head_w.shape[-1], vocab) is not None
    for i in range(n_chunks):
        if split:
            # recomputed in autograd's thread: under this one's rules
            ce, m, c = checkpoint(SH.bound(_ce_chunk_split), xr[i], head_w,
                                  lr[i], softcap, vocab, use_reentrant=False)
        else:
            ce, m, c = checkpoint(_ce_chunk, xr[i], head_w, lr[i], softcap,
                                  use_reentrant=False)
        ce_sum, mask_sum, corr = ce_sum + ce, mask_sum + m, corr + c
    rows = SH.data_axes("batch")
    if rows is not None:
        # the agent's rows split over the batch axes: the ratio of the
        # sums over all of them; the backward passes each rank the
        # gradient of its own rows' terms
        ce_sum, mask_sum, corr = comm.reduce_from_model(
            torch.stack([ce_sum, mask_sum, corr]), rows.group).unbind(0)
    denom = torch.clamp(mask_sum, min=1.0)
    loss = ce_sum / denom
    return loss, {"ce": loss, "accuracy": corr / denom}


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf: squares summed in f32, leaf sums added in
    sorted-leaf order (``jax.tree.leaves``'s order for dicts)."""
    return torch.sqrt(sum(obs_metrics.sq_sum(x) for x in TR.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """Scale every leaf by ``min(1, max_norm / norm)``.  Scaled in f32 and
    rounded once to the leaf's dtype, as the JAX package does (a bf16 leaf
    times a 0-d f32 tensor would stay bf16 in torch and round the scale
    first).  ``norm`` is ``global_norm(tree)`` unless given (the
    agent-sharded step passes the norm over every rank's agents)."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def scaled(x):
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        # elementwise, so slice by slice (obs.metrics.chunks) is the same
        for o, c in zip(obs_metrics.chunks(out), obs_metrics.chunks(x)):
            o.copy_(c.float() * scale)
        return out

    return TR.tree_map(scaled, tree), norm
