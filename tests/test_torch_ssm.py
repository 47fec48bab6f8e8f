"""The port's mamba2 mixer (models/ssm.py) and the SSM family of its
transformer and trainer against the JAX package's, on the same numpy inputs
and the JAX package's initial weights (carried across with
convert.params_from_numpy), at mamba2-780m's smoke config (2 layers,
d_model 128, 16 heads of 16, d_state 16, chunk 32).

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the same products summed in another
order: the port contracts the SSD's three- and four-operand einsums as
fixed pairs, ~1e-6 relative); bf16 rtol 2e-2 with an absolute floor of
2e-2 of the largest magnitude (bf16 keeps ~3 digits and the two frameworks
round at different places).  Stepwise decode against the full-sequence
block (the recurrence against the chunked SSD, both in the port): rtol and
atol 5e-3, the JAX package's own test of the pair."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "mamba2-780m"
F32 = dict(rtol=1e-4, atol=1e-5)


def configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def compare(mine, ref, dtype="float32"):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, **F32)
    else:
        np.testing.assert_allclose(mine, ref, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(ref).max()))


def mixer_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JS.mamba_init(jax.random.key(seed), jcfg))


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def ssd_inputs(seed=0, B=2, S_=64, H=4, P=3, G=2, N=5):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S_, H, P)).astype(np.float32),
            (-np.abs(r.normal(size=(B, S_, H))) * 0.3).astype(np.float32),
            r.normal(size=(B, S_, G, N)).astype(np.float32),
            r.normal(size=(B, S_, G, N)).astype(np.float32))


def test_segsum_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    mine = S._segsum(t(x)).numpy()
    ref = np.asarray(JS._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(mine), np.isneginf(ref))
    assert np.isneginf(mine[..., 0, 1]).all()        # above the diagonal
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mine[fin], ref[fin], **F32)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax(chunk):
    x, dA, Bm, Cm = ssd_inputs()
    y, final = S.ssd_chunked(t(x), t(dA), t(Bm), t(Cm), chunk)
    jy, jfinal = JS.ssd_chunked(*map(jnp.asarray, (x, dA, Bm, Cm)), chunk)
    assert y.dtype == final.dtype == torch.float32
    compare(y, jy)
    compare(final, jfinal)


def test_ssd_chunked_rejects_a_ragged_sequence():
    x, dA, Bm, Cm = ssd_inputs(S_=20)
    with pytest.raises(ValueError, match="SSD chunk"):
        S.ssd_chunked(t(x), t(dA), t(Bm), t(Cm), 8)


def test_mamba_init_tree_matches_the_jax_tree():
    cfg, jcfg = configs("bfloat16")
    jp = jax.eval_shape(lambda k: JS.mamba_init(k, jcfg), jax.random.key(0))
    mine = S.mamba_init(torch.Generator().manual_seed(0), cfg, lead=(3,))
    want = jax.tree.map(lambda a: ((3,) + tuple(a.shape), str(a.dtype)), jp)
    got = TR.tree_map(lambda a: (tuple(a.shape),
                                 str(a.dtype).replace("torch.", "")), mine)
    assert got == want
    # A_log, D and dt_bias stay f32 whatever param_dtype says
    assert {k for k, v in mine.items() if not isinstance(v, dict)
            and v.dtype == torch.float32} == {"A_log", "D", "dt_bias"}
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert not torch.equal(mine["dt_bias"][0], mine["dt_bias"][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_jax(dtype):
    cfg, jcfg = configs(dtype)
    jp = mixer_params(jcfg)
    u = (np.random.default_rng(1).normal(size=(2, 64, cfg.d_model))
         * 0.5).astype(np.float32)
    ju = jnp.asarray(u, jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    mine = S.mamba_block(params_from_numpy(jp, "cpu"),
                         t(np.asarray(ju.astype(jnp.float32)),
                           L.dtype_of(dtype)), cfg)
    ref = JS.mamba_block(jax.tree.map(jnp.asarray, jp), ju, jcfg)
    assert mine.dtype == L.dtype_of(dtype)
    compare(mine, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """Eight one-token steps: output and both cache leaves."""
    cfg, jcfg = configs(dtype)
    jp = mixer_params(jcfg, seed=2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    u = jnp.asarray(np.random.default_rng(2).normal(
        size=(2, 8, cfg.d_model)) * 0.5, jdt)
    tu = t(np.asarray(u.astype(jnp.float32)), L.dtype_of(dtype))
    p, jpj = params_from_numpy(jp, "cpu"), jax.tree.map(jnp.asarray, jp)
    c = S.mamba_init_cache(cfg, 2, L.dtype_of(dtype))
    jc = JS.mamba_init_cache(jcfg, 2, jdt)
    assert c.ssm.dtype == torch.float32 and c.conv.dtype == L.dtype_of(dtype)
    for step in range(8):
        before = TR.tree_map(torch.clone, c)
        o, c_new = S.mamba_decode(p, tu[:, step:step + 1], c, cfg)
        # the cache it was given is left as it was
        assert all(torch.equal(a, b) for a, b in zip(TR.leaves(before),
                                                      TR.leaves(c)))
        c = c_new
        jo, jc = JS.mamba_decode(jpj, u[:, step:step + 1], jc, jcfg)
        compare(o, jo, dtype)
    compare(c.ssm, jc.ssm, "float32" if dtype == "float32" else dtype)
    compare(c.conv, jc.conv, dtype)


def test_mamba_decode_stepwise_matches_the_block():
    cfg, jcfg = configs("float32")
    p = params_from_numpy(mixer_params(jcfg, seed=3), "cpu")
    u = t(np.random.default_rng(3).normal(size=(2, 64, cfg.d_model)) * 0.3)
    full = S.mamba_block(p, u, cfg)
    c = S.mamba_init_cache(cfg, 2, torch.float32)
    outs = []
    for step in range(u.shape[1]):
        o, c = S.mamba_decode(p, u[:, step:step + 1], c, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_silu_and_softplus_round_as_jax_does():
    """layers.silu / softplus reproduce jax.nn.silu / softplus: bf16 silu
    bit for bit (the JAX package rounds sigmoid's every step to bf16)."""
    z = np.random.default_rng(4).normal(size=4096).astype(np.float32) * 4
    jz = jnp.asarray(z, jnp.bfloat16)
    x = t(np.asarray(jz.astype(jnp.float32)), torch.bfloat16)
    np.testing.assert_array_equal(
        L.silu(x).float().numpy(),
        np.asarray(jax.nn.silu(jz).astype(jnp.float32)))
    compare(L.silu(t(z)), jax.nn.silu(jnp.asarray(z)))
    compare(L.softplus(t(z)), jax.nn.softplus(jnp.asarray(z)))


# ------------------------------------------------------- the SSM model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_matches_jax(dtype):
    cfg, jcfg = configs(dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 64)).astype(
        np.int32)
    logits, aux = T.forward(params_from_numpy(jp, "cpu"),
                            {"tokens": torch.from_numpy(toks).long()}, cfg)
    jl, _ = JT.forward(jax.tree.map(jnp.asarray, jp),
                       {"tokens": jnp.asarray(toks)}, jcfg)
    assert logits.dtype == torch.float32 and float(aux) == 0
    compare(logits, jl, dtype)


def test_ssm_init_tree_matches_the_jax_tree():
    cfg, jcfg = configs("bfloat16")
    jp = jax.eval_shape(lambda k: JTS.init_train_state(
        k, jcfg, JTS.TrainConfig(), 2).params, jax.random.key(0))
    mine = TS.init_train_state(torch.Generator().manual_seed(0), cfg,
                               TS.TrainConfig(), 2).params
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        TR.tree_map(lambda a: (tuple(a.shape),
                               str(a.dtype).replace("torch.", "")), mine)
    assert len(TR.leaves(mine)) == 11


@pytest.mark.parametrize("remat", [False, True])
def test_ssm_loss_and_grads_match_jax(remat):
    """make_loss_fn's value and gradient for one agent, f32 (with remat:
    each layer under checkpoint, the backward through _segsum's -inf)."""
    cfg, jcfg = configs("float32")
    tc = TS.TrainConfig(remat=remat, ce_chunks=4)
    jtc = JTS.TrainConfig(remat=remat, ce_chunks=4)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(1), jcfg))
    r = np.random.default_rng(6)
    toks = r.integers(0, cfg.vocab, (2, 65)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        JTS.make_loss_fn(jcfg, jtc), has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in b.items()})
    flat, treedef = TR.flatten(params_from_numpy(jp, "cpu"))
    req = [a.detach().requires_grad_(True) for a in flat]
    loss, _ = TS.make_loss_fn(cfg, tc)(
        TR.unflatten(treedef, req),
        {k: torch.from_numpy(v.copy()).long() for k, v in b.items()})
    grads = torch.autograd.grad(loss, req)
    compare(loss, jl)
    for g, jgl in zip(grads, jax.tree.leaves(jg)):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), rtol=1e-3,
                                   atol=1e-5 * float(np.abs(jgl).max()))


@pytest.mark.parametrize("memory_mode", ["exact", "expsum"])
def test_ssm_train_step_matches_jax(memory_mode):
    """One train step of mamba2's smoke config (bf16 leaves and the f32
    A_log, D, dt_bias in one tree; 2 agents, FrODO through the kernels'
    plain versions): loss and grad norm against the JAX step, then the
    parameters after the update and the mixing."""
    cfg, jcfg = configs("bfloat16")
    kw = dict(memory_mode=memory_mode, T=8, K=4)
    tc, jtc = TS.TrainConfig(use_kernel=True, **kw), JTS.TrainConfig(**kw)
    jstate = JTS.init_train_state(jax.random.key(0), jcfg, jtc, 2)
    r = np.random.default_rng(7)
    toks = r.integers(0, cfg.vocab, (2, 2, 33)).astype(np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jnew, jmet = jax.jit(JTS.make_train_step(jcfg, jtc, 2))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state = TS.train_state_from_params(
        params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu"),
        tc)
    new, met = TS.make_train_step(cfg, tc, 2)(state, b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=2e-3)
    for a, ja in zip(TR.leaves(new.params), jax.tree.leaves(jnew.params)):
        assert a.dtype == L.dtype_of(str(ja.dtype))
        compare(a, ja, "bfloat16")
