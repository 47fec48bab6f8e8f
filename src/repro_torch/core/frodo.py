"""FrODO optimizer (Algorithm 1, stages 1+2) as an ``(init, update)`` pair.

The consensus stage (stage 3) lives in ``core.consensus``.  This file
implements the per-agent update

    g_i   = grad f_i(x_i)
    M_i   = sum_{n=1..T} mu(n; lambda) g_i^(k-n)
    x_i  <- x_i - alpha g_i - beta M_i

with two memory representations (exact circular buffer / exponential-sum
accumulators, see ``core.memory``) and, with ``use_kernel=True``, the fused
update kernels of ``kernels.ops`` (hand-written CUDA on the card, their plain
versions on the CPU).

Parameters and gradients are trees of tensors (``repro_torch.tree``).  The
state is a dict whose ``"step"`` is a Python int, so the exact mode's cursor
never waits for the device.  ``update`` advances the memory buffers IN PLACE:
the state it was given is consumed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.core import memory as fmem
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as obs_metrics

Params = Any
Grads = Any
State = Any

#: scalar metrics attached to the optimizer state when
#: ``FrodoConfig.collect_metrics`` is set
METRIC_NAMES = ("grad_norm", "memory_norm", "update_norm")

ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Optimizer(NamedTuple):
    """``update`` returns (delta, new_state); the caller applies
    ``params = params + delta``."""
    init: Callable[[Params], State]
    update: Callable[[Grads, State, Optional[Params]], tuple[Any, State]]


@dataclasses.dataclass(frozen=True)
class FrodoConfig:
    alpha: float = 0.8          # gradient term magnitude
    beta: float = 0.35          # memory feedback magnitude
    lam: float = 0.15           # fractional order exponent, in (0,1)
    T: int = 90                 # memory length
    memory_mode: str = "exact"  # "exact" (paper) | "expsum" (beyond-paper)
    K: int = 8                  # number of exponentials for expsum mode
    exponent_scale: float = 1.0
    use_kernel: bool = False    # route the update through kernels.ops
    acc_dtype: str = "float32"  # expsum accumulator dtype (bf16 halves state)
    pad_T: int = 0              # buffer size override (weights zero beyond T)
    collect_metrics: bool = False  # ||g||/||M||/||delta|| in state["metrics"]

    def __post_init__(self):
        if self.memory_mode not in ("exact", "expsum"):
            raise ValueError(f"bad memory_mode {self.memory_mode!r}")
        if not (0.0 < self.lam < 1.0):
            raise ValueError("lambda must be in (0,1) per Algorithm 1")
        if self.acc_dtype not in ACC_DTYPES:
            raise ValueError(f"bad acc_dtype {self.acc_dtype!r}")


def frodo(cfg: FrodoConfig) -> Optimizer:
    if cfg.memory_mode == "exact":
        return _frodo_exact(cfg)
    return _frodo_expsum(cfg)


class _PerDevice:
    """A constant vector, copied once to each device it is asked for."""

    def __init__(self, host: torch.Tensor) -> None:
        self.host = host
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self.host.to(device)
        return self._on[device]


def _new_state(step: int, key: str, buffers, cfg: FrodoConfig, device):
    state = {"step": step, key: buffers}
    if cfg.collect_metrics:
        state["metrics"] = obs_metrics.zeros_like_metrics(METRIC_NAMES,
                                                          device)
    return state


# ------------------------------------------------------------------ exact

def _frodo_exact(cfg: FrodoConfig) -> Optimizer:
    T_buf = max(cfg.pad_T, cfg.T)
    w = np.zeros(T_buf)
    w[:cfg.T] = fmem.mu_weights(cfg.T, cfg.lam, cfg.exponent_scale)
    weights = _PerDevice(torch.tensor(w, dtype=torch.float32))

    def init(params: Params) -> State:
        hist = TR.tree_map(lambda p: fmem.exact_init(p, T_buf), params)
        return _new_state(0, "hist", hist, cfg, TR.leaves(params)[0].device)

    def update(grads: Grads, state: State, params: Optional[Params] = None):
        cursor = state["step"] % T_buf
        collect = cfg.collect_metrics
        flat_g, treedef = TR.flatten(grads)
        flat_h = TR.leaves(state["hist"])
        wts = weights.on(flat_g[0].device)
        deltas, hists, M_sq = [], [], []
        for g, h in zip(flat_g, flat_h):
            if cfg.use_kernel:
                # the kernel fuses M into the update and pushes g in place:
                # read M for telemetry first, and only when asked
                M = fmem.exact_memory_term(h, cursor, wts) if collect else None
                delta, h = kops.frodo_update(g, h, cursor, wts, cfg.alpha,
                                             cfg.beta)
            else:
                M = fmem.exact_memory_term(h, cursor, wts)
                delta = -(cfg.alpha * g + cfg.beta * M.to(g.dtype))
                h = fmem.exact_push(h, cursor, g)
            deltas.append(delta)
            hists.append(h)
            if collect:         # keep ||M||^2, not M: M is f32, n long
                M_sq.append(obs_metrics.tree_sq_sum(M))
        delta = TR.unflatten(treedef, deltas)
        new_state = {"step": state["step"] + 1,
                     "hist": TR.unflatten(treedef, hists)}
        if collect:
            new_state["metrics"] = obs_metrics.frodo_step_metrics_sq(
                grads, M_sq, delta)
        return delta, new_state

    return Optimizer(init, update)


# ---------------------------------------------------------------- expsum

def _frodo_expsum(cfg: FrodoConfig) -> Optimizer:
    rates_np, coeffs_np = fmem.fit_expsum(cfg.T, cfg.lam, cfg.K,
                                          cfg.exponent_scale)
    rates = _PerDevice(torch.tensor(rates_np, dtype=torch.float32))
    coeffs = _PerDevice(torch.tensor(coeffs_np, dtype=torch.float32))
    adt = ACC_DTYPES[cfg.acc_dtype]

    def init(params: Params) -> State:
        acc = TR.tree_map(lambda p: fmem.expsum_init(p, cfg.K).to(adt),
                          params)
        return _new_state(0, "acc", acc, cfg, TR.leaves(params)[0].device)

    def update(grads: Grads, state: State, params: Optional[Params] = None):
        collect = cfg.collect_metrics
        flat_g, treedef = TR.flatten(grads)
        flat_a = TR.leaves(state["acc"])
        dev = flat_g[0].device
        deltas, accs, M_sq = [], [], []
        for g, a in zip(flat_g, flat_a):
            if cfg.use_kernel:
                M = (fmem.expsum_memory_term(a, coeffs.on(dev)) if collect
                     else None)
                # rates/coeffs go to the kernel by value, from the host copy
                delta, a = kops.frodo_expsum_update(
                    g, a, rates.host, coeffs.host, cfg.alpha, cfg.beta)
            else:
                M = fmem.expsum_memory_term(a, coeffs.on(dev))
                delta = -(cfg.alpha * g + cfg.beta * M.to(g.dtype))
                a = fmem.expsum_push(a, rates.on(dev), g)
            deltas.append(delta)
            accs.append(a)
            if collect:         # keep ||M||^2, not M: M is f32, n long
                M_sq.append(obs_metrics.tree_sq_sum(M))
        delta = TR.unflatten(treedef, deltas)
        new_state = {"step": state["step"] + 1,
                     "acc": TR.unflatten(treedef, accs)}
        if collect:
            new_state["metrics"] = obs_metrics.frodo_step_metrics_sq(
                grads, M_sq, delta)
        return delta, new_state

    return Optimizer(init, update)


# ------------------------------------------------------------------ helpers

def apply_updates(params: Params, delta: Any) -> Params:
    return TR.tree_map(lambda p, d: p + d.to(p.dtype), params, delta)


def memory_bytes(params: Params, cfg: FrodoConfig) -> int:
    """Thm 2.2 accounting: O(Tn) exact / O(Kn) expsum state, in bytes."""
    n = sum(p.numel() * p.element_size() for p in TR.leaves(params))
    mult = cfg.T if cfg.memory_mode == "exact" else cfg.K
    return mult * n
