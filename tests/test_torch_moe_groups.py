"""Grouped MoE dispatch (``MoEConfig.dispatch_groups`` = G > 1) in the
port's models/moe.py against the JAX package's ``moe_mlp``, on the MoE
blocks of qwen3-moe-30b-a3b's and kimi-k2-1t-a32b's smoke configs in f32,
from the JAX package's initial weights and the same numpy inputs (qwen3-moe
at G = 2 and 4, kimi-k2's shared expert at G = 2 where tokens drop).

G splits the tokens into G groups, each with its own capacity
``_capacity(N/G)``: at an ample capacity (nothing drops) every G gives the
G = 1 output; at capacity_factor 0.5 assignments drop, and the groups drop
other assignments than one group over all tokens does, so the outputs of
G = 2 and 4 differ from G = 1's, and each equals JAX's at its G.  N % G
!= 0 raises, as the JAX package asserts.  A ``min_capacity`` at or above
the token count (decode at one position per row) drops nothing whatever
the split, so any row count is taken.

Tolerance: rtol 1e-5 / atol 1e-6 of the largest magnitude (test_torch_moe's
f32 limit: the same arithmetic summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
TOL = dict(rtol=1e-5, atol=1e-6)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def configs(arch, **moe_kw):
    out = []
    for reg in (REG, JREG):
        c = reg.get_smoke_config(arch).replace(**F32)
        out.append(c.replace(moe=c.moe.__class__(
            **{**c.moe.__dict__, **moe_kw})))
    return out


def layer(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, JM.moe_init(jax.random.key(seed), jcfg))
    return jp, params_from_numpy(jp, "cpu")


def scale_tol(ref):
    return TOL["atol"] * max(1.0, float(np.abs(ref).max()))


def run_both(arch, G, cf, x, seed=0):
    """The port's output and aux at G groups, JAX's, and the port's at one
    group."""
    cfg, jcfg = configs(arch, dispatch_groups=G, capacity_factor=cf)
    jp, p = layer(jcfg, seed)
    out, aux = M.moe_mlp(p, torch.from_numpy(x), cfg)
    jout, jaux = JM.moe_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jcfg)
    one, _ = M.moe_mlp(p, torch.from_numpy(x),
                       configs(arch, capacity_factor=cf)[0])
    return (out.detach().numpy(), float(aux), np.asarray(jout), float(jaux),
            one.detach().numpy())


@pytest.mark.parametrize("arch,cf,G", [
    (ARCHS[0], None, 2), (ARCHS[0], None, 4), (ARCHS[0], 0.5, 2),
    (ARCHS[0], 0.5, 4), (ARCHS[1], 0.5, 2)])
def test_grouped_dispatch_matches_jax(arch, cf, G):
    cfg, _ = configs(arch)
    ample = cfg.moe.n_experts / cfg.moe.top_k
    x = np.random.default_rng(1).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    out, aux, jout, jaux, one = run_both(arch, G, cf or ample, x, seed=1)
    np.testing.assert_allclose(out, jout, rtol=TOL["rtol"],
                               atol=scale_tol(jout))
    np.testing.assert_allclose(aux, jaux, rtol=TOL["rtol"], atol=1e-6)
    if cf is None:      # nothing drops: the split changes nothing
        np.testing.assert_allclose(out, one, rtol=TOL["rtol"],
                                   atol=scale_tol(one))
    else:               # other drops than one group over all tokens
        rows = np.abs(out - one).max(-1) > 100 * scale_tol(one)
        assert 0 < rows.sum() < rows.size


def test_groups_must_divide_the_tokens():
    cfg, jcfg = configs(ARCHS[0], dispatch_groups=4)
    _, p = layer(jcfg)
    x = torch.zeros(3, 5, cfg.d_model)
    with pytest.raises(ValueError, match="dispatch groups"):
        M.moe_mlp(p, x, cfg)
    with pytest.raises(AssertionError):
        JM.moe_mlp(JM.moe_init(jax.random.key(0), jcfg),
                   jnp.zeros((3, 5, cfg.d_model)), jcfg)


def test_decode_rows_take_any_count_with_groups():
    """One position per row, min_capacity = the rows: 3 rows under G = 2
    (3 % 2 != 0) give what G = 1 gives."""
    cfg, jcfg = configs(ARCHS[0], dispatch_groups=2, capacity_factor=0.5)
    one, _ = configs(ARCHS[0], capacity_factor=0.5)
    _, p = layer(jcfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 1, cfg.d_model)).astype(np.float32))
    got, _ = M.moe_mlp(p, x, cfg, min_capacity=3, with_aux=False)
    want, _ = M.moe_mlp(p, x, one, min_capacity=3, with_aux=False)
    assert torch.equal(got, want)
