"""repro_torch.core.consensus.mix_stacked against repro.core.consensus:
the uniform-complete mean shortcut and the general f32 contraction, with
and without metrics, on the same numpy states.

Tolerances: f32 rtol 1e-6 / atol 1e-6 (an f32 contraction over <= 5
agents in another order); bf16 leaves 2e-2 (one bf16 rounding)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jc  # noqa: E402
from repro_torch import convert, tree as TR  # noqa: E402
from repro_torch.core import consensus as tc  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402

WEIGHTS = {
    "xiao_boyd_complete2": G.xiao_boyd_weights(G.complete(2)),
    "uniform_complete4": G.uniform_weights(G.complete(4)),
    "metropolis_ring5": G.metropolis_weights(G.ring(5, directed=False)),
    "uniform_directed_ring4": G.uniform_weights(G.ring(4)),
}


def _state(rng, A, dtype):
    return {"w": jnp.asarray(rng.normal(size=(A, 3, 4)), dtype),
            "b": jnp.asarray(rng.normal(size=(A, 5)), dtype)}


def _check(jout, tout, tol):
    for j, t in zip(jax.tree.leaves(jout), TR.leaves(tout)):
        assert t.dtype == convert.tensor_from_numpy(np.asarray(j), "cpu").dtype
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("with_metrics", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_mix_stacked_matches_jax(wname, dtype, with_metrics):
    W = WEIGHTS[wname]
    assert tc.is_uniform_complete(W) == jc.is_uniform_complete(W)
    rng = np.random.default_rng(len(wname))
    jx = _state(rng, W.shape[0], getattr(jnp, dtype))
    tx = convert.params_from_numpy(jax.tree.map(np.asarray, jx), "cpu")
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-6, atol=1e-6)
    jout = jc.mix_stacked(jx, W, with_metrics=with_metrics)
    tout = tc.mix_stacked(tx, W, with_metrics=with_metrics)
    if with_metrics:
        (jout, jaux), (tout, taux) = jout, tout
        assert set(taux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-6)
    _check(jout, tout, tol)


def test_tensor_W_takes_the_general_contraction():
    """A tensor W (e.g. one step of a masked schedule) never takes the
    mean shortcut, and gives the same answer as the numpy W."""
    W = WEIGHTS["uniform_complete4"]
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    a = tc.mix_stacked(x, W)
    b = tc.mix_stacked(x, torch.as_tensor(W, dtype=torch.float32))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    out, aux = tc.mix_stacked(x, W, with_metrics=True)
    assert float(aux["consensus_error_post"]) == 0.0
    assert out.is_contiguous()
