"""Convergence-theory utilities (Theorem 2.1 / 2.2).

Used by tests to check the *measured* convergence rate against the paper's
predicted contraction factors, and by the trainer to sanity-check parameter
choices (alpha vs L, beta vs C(lambda)).

A copy of the JAX package's ``repro.core.theory`` on the port's ``graph`` and
the numpy half of its ``memory``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import graph as cgraph
from repro_torch.core import memory as fmem


def C_lambda(T: int, lam: float) -> float:
    """The lambda-dependent constant bounding the memory term's contribution:
    the operator norm of the memory map is at most sum_n mu(n; lambda)
    (triangle inequality on M = sum mu(n) g^(k-n) with ||g^(k-n)|| bounded by
    the worst historical gradient norm)."""
    return float(fmem.mu_weights(T, lam).sum())


def rho(alpha: float, beta: float, mu: float, L: float,
        T: int, lam: float) -> float:
    """Optimization contraction factor of Thm 2.1:
    rho = max{|1-alpha*mu|, |1-alpha*L|} * (1 + beta*C(lambda))."""
    base = max(abs(1.0 - alpha * mu), abs(1.0 - alpha * L))
    return base * (1.0 + beta * C_lambda(T, lam))


def overall_rate(alpha: float, beta: float, mu: float, L: float,
                 T: int, lam: float, W: np.ndarray) -> float:
    """max{rho, sigma} — the linear rate of ||x_i^k - x*|| in Thm 2.1."""
    return max(rho(alpha, beta, mu, L, T, lam), cgraph.sigma(W))


def stable_beta_range(alpha: float, mu: float, L: float,
                      T: int, lam: float) -> float:
    """Largest beta with rho < 1 (0 if even beta=0 is unstable)."""
    base = max(abs(1.0 - alpha * mu), abs(1.0 - alpha * L))
    if base >= 1.0:
        return 0.0
    return (1.0 / base - 1.0) / C_lambda(T, lam)


def quadratic_curvature(Q: np.ndarray) -> tuple[float, float]:
    """(mu, L) of f(x) = 0.5 x^T Q x  — strong convexity & smoothness."""
    ev = np.linalg.eigvalsh(0.5 * (Q + Q.T))
    return float(ev.min()), float(ev.max())


def measured_rate(errors: np.ndarray, burn_in: int = 10) -> float:
    """Fit log ||e_k|| ~ k log(rate) by least squares on the tail."""
    e = np.asarray(errors, dtype=np.float64)
    e = e[burn_in:]
    e = e[e > 1e-14]
    if len(e) < 3:
        return 0.0
    k = np.arange(len(e))
    slope = np.polyfit(k, np.log(e), 1)[0]
    return float(np.exp(slope))
