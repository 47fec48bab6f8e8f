"""Losses and gradient clipping: the port of the JAX package's
``repro.training.loss``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as TR


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


def chunked_cross_entropy(x, head_w, labels, n_chunks: int = 8,
                          softcap: float = 0.0):
    """CE over (B,S,d) features without materializing (B,S,V) fp32 logits:
    rows are processed in checkpointed chunks, so the backward recomputes
    each chunk's logits instead of keeping them live (the fused-CE pattern).

    x: (B,S,d); head_w: (d,V); labels: (B,S) int (negatives masked).
    Returns (loss, metrics) like ``cross_entropy``.  ``n_chunks`` is halved
    until it divides B*S."""
    B, S, d = x.shape
    N = B * S
    while N % n_chunks:
        n_chunks //= 2
    n_chunks = max(n_chunks, 1)
    xr = x.reshape(n_chunks, N // n_chunks, d)
    lr = labels.long().reshape(n_chunks, N // n_chunks)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ce_sum, mask_sum, corr = zero, zero, zero
    for i in range(n_chunks):
        ce, m, c = checkpoint(_ce_chunk, xr[i], head_w, lr[i], softcap,
                              use_reentrant=False)
        ce_sum, mask_sum, corr = ce_sum + ce, mask_sum + m, corr + c
    denom = torch.clamp(mask_sum, min=1.0)
    loss = ce_sum / denom
    return loss, {"ce": loss, "accuracy": corr / denom}


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf: squares summed in f32, leaf sums added in
    sorted-leaf order (``jax.tree.leaves``'s order for dicts)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in TR.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """Scale every leaf by ``min(1, max_norm / norm)``.  Scaled in f32 and
    rounded once to the leaf's dtype, as the JAX package does (a bf16 leaf
    times a 0-d f32 tensor would stay bf16 in torch and round the scale
    first).  ``norm`` is ``global_norm(tree)`` unless given (the
    agent-sharded step passes the norm over every rank's agents)."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return TR.tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm
