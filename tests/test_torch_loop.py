"""repro_torch.core.loop.run against repro.core.loop.run on the Exp 1
quadratic (4 agents, Hessian ~ diag(1, 0.01) per agent, x* = 0).

Tolerance: rtol 1e-5 / atol 1e-6 on every per-round trace and the final
states (f32 on both sides, 60 rounds of a contraction)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core import loop as jl  # noqa: E402
from repro.core.frodo import FrodoConfig as JCfg  # noqa: E402
from repro.core.frodo import frodo as jfrodo  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import loop as tl  # noqa: E402
from repro_torch.core.frodo import FrodoConfig as TCfg  # noqa: E402
from repro_torch.core.frodo import frodo as tfrodo  # noqa: E402

CENTERS = np.asarray([[2, 0], [-2, 0], [0, 2], [0, -2]], np.float32)
X0 = np.asarray([[1, 0], [0.86, 0.5], [0.5, 0.86], [0, 1]], np.float32)
TOL = dict(rtol=1e-5, atol=1e-6)


def jobj(x, i):
    d = x - jnp.asarray(CENTERS)[i]
    return 0.5 * d[0] ** 2 + 0.005 * d[1] ** 2


_TC = torch.from_numpy(CENTERS)


def tobj(x, i):
    d = x - _TC[i]
    return 0.5 * d[0] ** 2 + 0.005 * d[1] ** 2


FRODO = dict(alpha=0.8, beta=0.35, lam=0.15, T=20)
OPTS = {
    "frodo": (lambda: jfrodo(JCfg(**FRODO)), lambda: tfrodo(TCfg(**FRODO))),
    "frodo_kernel": (lambda: jfrodo(JCfg(**FRODO, use_kernel=True)),
                     lambda: tfrodo(TCfg(**FRODO, use_kernel=True))),
    "heavy_ball": (lambda: jb.heavy_ball(0.8, 0.35),
                   lambda: tb.heavy_ball(0.8, 0.35)),
    "no_memory": (lambda: jb.no_memory(0.8), lambda: tb.no_memory(0.8)),
}
GRAPHS = {"xiao_boyd_complete": G.xiao_boyd_weights(G.complete(4)),
          "metropolis_ring": G.metropolis_weights(G.ring(4, directed=False))}


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("oname", list(OPTS))
def test_run_matches_jax(oname, gname, collect):
    jopt, topt = (f() for f in OPTS[oname])
    W = GRAPHS[gname]
    K = 60
    jr = jl.run(jobj, jnp.asarray(X0), jopt, W, K, x_star=jnp.zeros(2),
                collect_metrics=collect)
    tr = tl.run(tobj, torch.from_numpy(X0), topt, W, K,
                x_star=torch.zeros(2), collect_metrics=collect)
    keys = {"errors", "f"} | ({"consensus_error", "consensus_error_pre_mix"}
                              if collect else set())
    assert keys <= set(tr) and set(tr) - {"x"} == set(jr) - {"x"}
    for k in keys:
        assert tr[k].shape == (K,)
        np.testing.assert_allclose(tr[k], jr[k], **TOL, err_msg=k)
    np.testing.assert_allclose(tr["x"].numpy(), np.asarray(jr["x"]), **TOL)
    assert tl.iterations_to_tol(tr["errors"], 1e-2) \
        == jl.iterations_to_tol(jr["errors"], 1e-2)


def test_first_round_is_consensus_only():
    """Algorithm 1 skips the update at k = 0: one round is one mix."""
    W = G.uniform_weights(G.complete(3), self_loop=False)
    x0 = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    out = tl.run(lambda x, i: 0.5 * torch.sum(x ** 2), x0,
                 tb.no_memory(1e9), W, 1, x_star=torch.zeros(2))
    np.testing.assert_allclose(out["x"].numpy(), W @ x0.numpy(), rtol=1e-6)
