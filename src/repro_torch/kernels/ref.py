"""Plain PyTorch versions of the two fused FrODO update kernels.

They repeat the arithmetic of the TPU kernels (``_exact_kernel`` and
``_expsum_kernel`` in the JAX package's ``repro/kernels/frodo_update.py``)
and of the CUDA kernels that replace them: f32 weights, an f32 accumulator
summed slot by slot in order, one cast at the end.  ``kernels.ops`` runs them
for tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against them
on the card.

They are not the optimizer's ``use_kernel=False`` path, which contracts in
the state's dtype (``core.memory``) and so rounds differently in bf16.

Both update their state argument IN PLACE, as the kernels do.
"""
from __future__ import annotations

import torch

from repro_torch.core import memory as fmem


def frodo_update_ref(g: torch.Tensor, hist: torch.Tensor, cursor: int,
                     weights: torch.Tensor, alpha: float, beta: float):
    """Exact-memory fused update.  g: (...), hist: (T, ...), weights: (T,)
    mu.  Returns ``(delta, hist)`` with g pushed into ``hist[cursor]``."""
    w_slot = fmem.slot_weights(weights.float(), cursor)
    M = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for s in range(hist.shape[0]):
        M = M + w_slot[s] * hist[s].float()
    delta = (-(alpha * g.float() + beta * M)).to(g.dtype)
    return delta, fmem.exact_push(hist, cursor, g)


def frodo_expsum_update_ref(g: torch.Tensor, acc: torch.Tensor,
                            rates: torch.Tensor, coeffs: torch.Tensor,
                            alpha: float, beta: float):
    """Exp-sum fused update.  acc: (K, ...).  Returns ``(delta, acc)``
    with the accumulators advanced in place: ``M`` is read from the old
    ones, ``acc[k] <- r_k * (acc[k] + g)`` computed in f32, then rounded to
    ``acc.dtype``."""
    g32 = g.float()
    r = rates.float().tolist()
    c = coeffs.float().tolist()
    M = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for k in range(acc.shape[0]):
        a = acc[k].float()
        M = M + c[k] * a
        acc[k] = r[k] * (a + g32)
    delta = (-(alpha * g32 + beta * M)).to(g.dtype)
    return delta, acc
