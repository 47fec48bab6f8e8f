"""Fused FrODO update ops for one parameter leaf.

A tensor on the CPU takes the plain version (``kernels.ref``); a tensor on a
CUDA device takes the hand-written kernel (``kernels.frodo_update``), which
launches or raises.  There is no fallback from one to the other.  Each op
carries the JAX package's scope name (``pallas.frodo_exact_update``,
``pallas.frodo_expsum_update``) as a ``trace_scope``.

Both ops update their state argument IN PLACE and return it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import frodo_update as K
from repro_torch.kernels import ref
from repro_torch.obs.timing import trace_scope

LAUNCHES = K.LAUNCHES


def frodo_update(g: torch.Tensor, hist: torch.Tensor, cursor: int,
                 weights: torch.Tensor, alpha: float, beta: float):
    """Fused exact-memory update.  g: (...); hist: (T, ...); weights: (T,)
    unrotated mu; ``cursor`` the slot g is pushed into.  Returns
    ``(delta, hist)`` with ``hist[cursor] = g`` written in place."""
    with trace_scope("pallas.frodo_exact_update"):
        if g.device.type == "cpu":
            return ref.frodo_update_ref(g, hist, cursor, weights, alpha,
                                        beta)
        if g.device.type == "cuda":
            return K.exact_update(g, hist, cursor, weights, alpha,
                                  beta), hist
    raise ValueError(f"frodo_update: unsupported device {g.device}")


def frodo_expsum_update(g: torch.Tensor, acc: torch.Tensor,
                        rates: torch.Tensor, coeffs: torch.Tensor,
                        alpha: float, beta: float):
    """Fused exp-sum update.  acc: (K, ...); rates, coeffs: (K,) host
    tensors.  Returns ``(delta, acc)`` with the accumulators advanced in
    place (which saves the K·n of a second buffer)."""
    with trace_scope("pallas.frodo_expsum_update"):
        if g.device.type == "cpu":
            return ref.frodo_expsum_update_ref(g, acc, rates, coeffs, alpha,
                                               beta)
        if g.device.type == "cuda":
            return K.expsum_update(g, acc, rates, coeffs, alpha, beta), acc
    raise ValueError(f"frodo_expsum_update: unsupported device {g.device}")
