"""Baseline optimizers from the paper's Experiment 2, in the same API.

Each is "a variation of Algorithm 1 with a modified stage-2 descent term":

* ``no_memory``   — beta = 0 (plain distributed GD).
* ``heavy_ball``  — FrODO with T = 1 (memory = previous gradient only).
* ``nesterov``    — classical Nesterov momentum on the stage-2 step.
* ``adam``        — Adam on the stage-2 step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.core.frodo import FrodoConfig, Optimizer, frodo


def no_memory(alpha: float) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        delta = TR.tree_map(lambda g: -alpha * g, grads)
        return delta, {"step": state["step"] + 1}

    return Optimizer(init, update)


def heavy_ball(alpha: float, beta: float) -> Optimizer:
    """FrODO at T=1: the memory term is exactly the previous gradient
    (mu(1)=1 whatever lambda)."""
    return frodo(FrodoConfig(alpha=alpha, beta=beta, lam=0.5, T=1,
                             memory_mode="exact"))


def nesterov(alpha: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": 0, "mom": TR.tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        mom = TR.tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
        delta = TR.tree_map(lambda m, g: -alpha * (momentum * m + g),
                            mom, grads)
        return delta, {"step": state["step"] + 1, "mom": mom}

    return Optimizer(init, update)


def adam(alpha: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = TR.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        return {"step": 0, "m": z, "v": TR.tree_map(torch.zeros_like, z)}

    def update(grads, state, params=None):
        t = state["step"] + 1
        m = TR.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype),
                        state["m"], grads)
        v = TR.tree_map(lambda v_, g: b2 * v_
                        + (1 - b2) * torch.square(g.to(v_.dtype)),
                        state["v"], grads)
        # bias corrections in float32, as the reference computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        delta = TR.tree_map(
            lambda m_, v_: -alpha * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps),
            m, v)
        return delta, {"step": t, "m": m, "v": v}

    return Optimizer(init, update)


REGISTRY = {
    "frodo": lambda **kw: frodo(FrodoConfig(**kw)),
    "no_memory": no_memory,
    "heavy_ball": heavy_ball,
    "nesterov": nesterov,
    "adam": adam,
}
