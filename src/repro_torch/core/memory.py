"""Fractional-order memory: power-law gradient weighting (FrODO §2).

The paper's memory term is

    M_i^(k) = sum_{n=1..T} mu(n; lambda) * g_i^(k-n),
    mu(n; lambda) = n^(lambda - 1)            (normalized: mu(1) = 1)

Two representations, as in the JAX package's ``repro.core.memory``:

* ``exact``  — a rolling buffer of the last T gradients (O(T n) state).
* ``expsum`` — the power-law kernel on [1, T] fitted by a sum of K
  exponentials, n^(lambda-1) ~= sum_k c_k r_k^n, kept as K EMA accumulators
  (O(K n) state).

The weight and fit functions stay numpy (bit-equal to the JAX package's);
the state operations work on torch tensors.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def mu_weights(T: int, lam: float, exponent_scale: float = 1.0) -> np.ndarray:
    """Normalized fractional weights mu(n; lambda) for n = 1..T.

    ``exponent_scale=2.0`` selects the squared power law
    ``(n^(lambda-1))^2``; the default is the single power law.
    """
    if not (0.0 <= lam <= 1.0):
        raise ValueError(f"lambda must be in [0,1], got {lam}")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    n = np.arange(1, T + 1, dtype=np.float64)
    mu0 = n ** (exponent_scale * (lam - 1.0))
    return (mu0 / mu0.max()).astype(np.float64)


@functools.lru_cache(maxsize=64)
def fit_expsum(T: int, lam: float, K: int = 8,
               exponent_scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Fit  mu(n) ~= sum_k c_k * r_k^n  on n = 1..T by linear least squares.

    Rates r_k = exp(-1/tau_k) with tau_k log-spaced in [0.5, T] (capped at
    T: the paper's kernel truncates at T); coefficients c_k solve the
    1/mu-weighted least-squares problem.  Returns (rates[K], coeffs[K]).
    """
    mu = mu_weights(T, lam, exponent_scale)
    n = np.arange(1, T + 1, dtype=np.float64)
    taus = np.geomspace(0.5, 1.0 * T, K)
    rates = np.exp(-1.0 / taus)
    A = rates[None, :] ** n[:, None]                      # (T, K)
    w = 1.0 / np.maximum(mu, 1e-12)
    coeffs, *_ = np.linalg.lstsq(A * w[:, None], mu * w, rcond=None)
    return rates, coeffs


def expsum_error(T: int, lam: float, K: int = 8) -> float:
    """Relative L2 error of the exp-sum fit against the exact weights."""
    mu = mu_weights(T, lam)
    rates, coeffs = fit_expsum(T, lam, K)
    n = np.arange(1, T + 1, dtype=np.float64)
    approx = (rates[None, :] ** n[:, None]) @ coeffs
    return float(np.linalg.norm(approx - mu) / np.linalg.norm(mu))


# ---------------------------------------------------------------------------
# Memory-state operations.  The exact mode keeps a circular buffer
# hist[T, ...] and an integer cursor (a Python int: the step count mod T, so
# reading it never waits for the device).  Slot ``(cursor - n) mod T`` holds
# g^(k-n); unfilled slots are zero (the paper's zero pre-history).
# ---------------------------------------------------------------------------

def slot_weights(weights: torch.Tensor, cursor: int) -> torch.Tensor:
    """``w_slot[s] = weights[n(s) - 1]`` with ``n(s) = (cursor - s) mod T``
    and n == 0 read as T: the mu weight of the gradient slot s holds.

    Equal to ``roll(flip(weights), cursor)``, which stays on the weights'
    device (no host index vector is copied over each step).
    """
    T = weights.shape[0]
    if not 0 <= cursor < T:
        raise ValueError(f"cursor {cursor} out of range for T={T}")
    return torch.roll(torch.flip(weights, (0,)), cursor)


def exact_init(param: torch.Tensor, T: int) -> torch.Tensor:
    return torch.zeros((T,) + tuple(param.shape), dtype=param.dtype,
                       device=param.device)


def exact_memory_term(hist: torch.Tensor, cursor: int,
                      weights: torch.Tensor) -> torch.Tensor:
    """M = sum_n mu(n) * hist[(cursor - n) mod T], contracted in the
    history's dtype (a bf16 history gives a bf16 sum, as in the JAX
    package)."""
    w_slot = slot_weights(weights, cursor).to(hist.dtype)
    return torch.tensordot(w_slot, hist, dims=([0], [0]))


def exact_push(hist: torch.Tensor, cursor: int,
               g: torch.Tensor) -> torch.Tensor:
    """Write g^(k) into the circular buffer at ``cursor``.

    Writes IN PLACE and returns ``hist`` itself (the JAX version returns a
    new buffer); read the memory term from ``hist`` before pushing."""
    hist[cursor].copy_(g.to(hist.dtype))
    return hist


def expsum_init(param: torch.Tensor, K: int) -> torch.Tensor:
    """Always float32; the optimizer casts to ``acc_dtype``."""
    return torch.zeros((K,) + tuple(param.shape), dtype=torch.float32,
                       device=param.device)


def expsum_memory_term(acc: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """M = sum_k c_k * S_k   with  S_k^(t) = sum_{n>=1} r_k^n g^(t-n)."""
    return torch.tensordot(coeffs.to(acc.dtype), acc, dims=([0], [0]))


def expsum_push(acc: torch.Tensor, rates: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """S_k <- r_k * (S_k + g^(t)), in the accumulators' dtype.  Returns a
    new tensor."""
    r = rates.to(acc.dtype).reshape((-1,) + (1,) * g.dim())
    return r * (acc + g.to(acc.dtype)[None])
