"""The port's Mixture-of-Experts layer (models/moe.py) against the JAX
package's ``repro.models.moe``, on the MoE blocks of qwen3-moe-30b-a3b's
smoke config (4 experts, top 2) and kimi-k2-1t-a32b's (a shared expert),
in f32, from the JAX package's initial weights and the same numpy inputs.

Tolerances: outputs, aux and gradients rtol 1e-5 / atol 1e-6 of the
largest magnitude, at least 1e-6 (the same f32 arithmetic; XLA and
PyTorch sum the products in other orders, ~1e-7 relative).  The
router's choices (``top_e``) and which assignments the capacity drops
(``keep``) are compared exactly, on inputs where drops occur
(capacity_factor 0.5).  Decode's no-drop rule: 16 rows forced to one
expert keep every assignment with ``min_capacity`` = 16 and give what
each row gives alone (the JAX package's per-slot decode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
TOL = dict(rtol=1e-5, atol=1e-6)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def configs(arch, **moe_kw):
    cfg, jcfg = (REG.get_smoke_config(arch).replace(**F32),
                 JREG.get_smoke_config(arch).replace(**F32))
    if moe_kw:
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **{**cfg.moe.__dict__, **moe_kw}))
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(
            **{**jcfg.moe.__dict__, **moe_kw}))
    return cfg, jcfg


def layer(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, JM.moe_init(jax.random.key(seed), jcfg))
    return jp, params_from_numpy(jp, "cpu")


def inputs(cfg, shape=(2, 24), seed=0):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


def close(mine, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        mine.detach().numpy(), ref, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(ref).max())))


def test_init_tree_matches_the_jax_tree():
    for arch in ARCHS:
        cfg, jcfg = configs(arch)
        jp = jax.eval_shape(lambda k: JM.moe_init(k, jcfg),
                            jax.random.key(0))
        mine = M.moe_init(torch.Generator().manual_seed(0), cfg, (3,))
        assert jax.tree.map(lambda a: (3,) + tuple(a.shape), jp) == \
            TR.tree_map(lambda a: tuple(a.shape), mine)
        assert mine["router"]["w"].dtype == torch.float32
        bf = M.moe_init(torch.Generator(), REG.get_smoke_config(arch))
        assert bf["router"]["w"].dtype == torch.float32
        assert bf["experts"]["gate"].dtype == torch.bfloat16


def test_capacity_is_the_jax_package_s():
    for arch in ARCHS + ("qwen3-moe-30b-a3b",):
        m = REG.get_config(arch).moe
        for n in (1, 8, 16, 100, 8192):
            assert M._capacity(n, m) == JM._capacity(n, m)


@pytest.mark.parametrize("arch,cf", [(ARCHS[0], None), (ARCHS[1], None),
                                     (ARCHS[0], 0.5), (ARCHS[1], 0.5)])
def test_moe_mlp_matches_jax(arch, cf):
    """Outputs and aux; with capacity_factor 0.5 assignments drop."""
    cfg, jcfg = configs(arch, **({} if cf is None else
                                 {"capacity_factor": cf}))
    jp, p = layer(jcfg)
    x = inputs(cfg)
    out, aux = M.moe_mlp(p, torch.from_numpy(x), cfg)
    jout, jaux = JM.moe_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jcfg)
    assert out.shape == x.shape and aux.dtype == torch.float32
    close(out, jout)
    close(aux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_drops_are_the_jax_package_s(arch):
    """top_e, the buffer rows and keep bit for bit, where drops occur."""
    cfg, jcfg = configs(arch, capacity_factor=0.5)
    jp, p = layer(jcfg, seed=1)
    x = inputs(cfg, (2, 32), seed=1).reshape(-1, cfg.d_model)
    m = cfg.moe
    C = M._capacity(x.shape[0], m)
    _, probs, top_w, top_e = M.route(p, torch.from_numpy(x), cfg)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    jw, je = jax.lax.top_k(jprobs, m.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    close(top_w, jw / jw.sum(-1, keepdims=True))
    buf, dest, keep, tok = M._dispatch_one(torch.from_numpy(x), top_e,
                                           m.n_experts, m.top_k, C)
    jbuf, jdest, jkeep, jtok = JM._dispatch_one(
        jnp.asarray(x), jw, je, m.n_experts, m.top_k, C, None, jcfg)
    assert 0 < int((~keep).sum()) < keep.numel()      # drops occur
    for a, b in ((dest, jdest), (keep, jkeep), (tok, jtok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_through_the_dispatch_match_jax(arch):
    """d(sum(out * r) + aux) by x and every leaf, with drops."""
    cfg, jcfg = configs(arch, capacity_factor=0.5)
    jp, p = layer(jcfg, seed=2)
    x = inputs(cfg, (2, 16), seed=2)
    r = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def jloss(params, x):
        out, aux = JM.moe_mlp(params, x, jcfg)
        return jnp.sum(out * r) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                               jnp.asarray(x))
    flat, td = TR.flatten(p)
    req = [t.requires_grad_(True) for t in flat]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_mlp(TR.unflatten(td, req), xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum() + aux,
                                req + [xt])
    jflat = jax.tree.leaves(jgp)
    assert len(jflat) == len(req)
    for g, jg in zip(grads, jflat + [jgx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)


def test_decode_rows_never_drop():
    """16 rows (a 16-slot arena) all routed to expert 0 first, 16 experts
    top 2 (qwen3-moe's capacity factor, 1.25): with min_capacity = 16
    every assignment is kept and each row equals the JAX layer on that row
    alone (the per-slot decode, which cannot drop); at the capacity of 16
    tokens (8) half of them would drop."""
    cfg, jcfg = configs(ARCHS[0], n_experts=16, capacity_factor=1.25)
    jp, _ = layer(jcfg, seed=4)
    d = cfg.d_model
    rng = np.random.default_rng(4)
    u = rng.normal(size=d).astype(np.float32)
    x = (4.0 * u + 0.1 * rng.normal(size=(16, 1, d))).astype(np.float32)
    jp["router"]["w"] = np.asarray(jp["router"]["w"]).copy()
    jp["router"]["w"][:, 0] = u
    p = params_from_numpy(jp, "cpu")
    _, _, _, top_e = M.route(p, torch.from_numpy(x.reshape(16, d)), cfg)
    assert bool((top_e[:, 0] == 0).all())
    assert M._capacity(16, cfg.moe) < 16
    out, _ = M.moe_mlp(p, torch.from_numpy(x), cfg, min_capacity=16)
    jfn = jax.jit(lambda xr: JM.moe_mlp(jax.tree.map(jnp.asarray, jp), xr,
                                        jcfg)[0])
    want = np.stack([np.asarray(jfn(jnp.asarray(x[i:i + 1])))[0]
                     for i in range(16)])
    close(out, want)
    dropped, _ = M.moe_mlp(p, torch.from_numpy(x), cfg)
    assert not np.allclose(dropped.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_keeps_every_assignment(arch):
    """``no_drop`` raises the capacity to every token: the 16 rows of
    test_decode_rows_never_drop, all routed to one expert, come out as
    with ``min_capacity`` = 16 (the JAX package's per-row answer); a
    config of another family is returned as it is."""
    cfg, jcfg = configs(arch, n_experts=16, capacity_factor=1.25)
    _, p = layer(jcfg, seed=4)
    d = cfg.d_model
    rng = np.random.default_rng(4)
    u = rng.normal(size=d).astype(np.float32)
    p["router"]["w"][:, 0] = torch.from_numpy(u)
    x = torch.from_numpy(
        (4.0 * u + 0.1 * rng.normal(size=(16, 1, d))).astype(np.float32))
    nd = M.no_drop(cfg)
    assert M._capacity(16, nd.moe) >= 16 > M._capacity(16, cfg.moe)
    out, _ = M.moe_mlp(p, x, nd)
    kept, _ = M.moe_mlp(p, x, cfg, min_capacity=16)
    assert torch.equal(out, kept)
    dense = REG.get_smoke_config("h2o-danube-1.8b")
    assert M.no_drop(dense) is dense
