"""repro_torch.core.theory against repro.core.theory: both are plain numpy
on the same graph and memory weights, so every value is equal."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import theory as jt  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import theory as tt  # noqa: E402


@pytest.mark.parametrize("T,lam", [(1, 0.5), (20, 0.15), (90, 0.1)])
def test_rates_match(T, lam):
    assert tt.C_lambda(T, lam) == jt.C_lambda(T, lam)
    for alpha, beta, mu, L in [(0.3, 0.01, 1.0, 3.0), (0.8, 0.35, 0.02, 2.0),
                               (1.5, 0.1, 1.0, 3.0)]:
        assert tt.rho(alpha, beta, mu, L, T, lam) == \
            jt.rho(alpha, beta, mu, L, T, lam)
        assert tt.stable_beta_range(alpha, mu, L, T, lam) == \
            jt.stable_beta_range(alpha, mu, L, T, lam)
        for W in (G.xiao_boyd_weights(G.complete(4)),
                  G.metropolis_weights(G.ring(5, directed=False))):
            assert tt.overall_rate(alpha, beta, mu, L, T, lam, W) == \
                jt.overall_rate(alpha, beta, mu, L, T, lam, W)
    assert tt.stable_beta_range(1.5, 1.0, 3.0, T, lam) == 0.0   # unstable


def test_curvature_and_measured_rate_match():
    rng = np.random.default_rng(0)
    Q = rng.normal(size=(3, 3))
    Q = Q @ Q.T + np.eye(3)
    assert tt.quadratic_curvature(Q) == jt.quadratic_curvature(Q)
    errs = 0.9 ** np.arange(60) * (1 + 0.01 * rng.normal(size=60))
    assert tt.measured_rate(errs) == jt.measured_rate(errs)
    assert tt.measured_rate(errs, burn_in=5) == jt.measured_rate(errs, 5)
    short = np.asarray([1.0, 0.5, 0.0])
    assert tt.measured_rate(short, burn_in=0) == 0.0 == \
        jt.measured_rate(short, burn_in=0)
