"""The port's multi-head latent attention (the MLA half of
models/attention.py) against the JAX package's, on one layer of
minicpm3-4b's smoke config (d 256, 4 heads, q_lora 64, kv_lora 32, nope 16
/ rope 8 / v 16) in f32, from the JAX package's initial weights and the
same numpy inputs: the naive-form forward on its direct path and on its
blockwise path (attn_direct_max below the sequence), and the absorbed-form
decode against the latent cache, step by step from an empty cache, at one
position and at one position per row, and against the port's own forward.

Tolerance: rtol 1e-5 / atol 1e-5 (the same f32 arithmetic, products
summed in another order by XLA and PyTorch; the decode's absorbed form
sums its products in another order than the forward's naive form)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def configs(**kw):
    kw.update(F32)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def layer(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, JA.mla_init(jax.random.key(seed), jcfg))
    return jp, params_from_numpy(jp, "cpu")


def inputs(cfg, B, S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def close(mine, ref):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), **TOL)


def test_init_tree_matches_the_jax_tree():
    cfg, jcfg = configs()
    jp = jax.eval_shape(lambda k: JA.mla_init(k, jcfg), jax.random.key(0))
    mine = A.mla_init(torch.Generator().manual_seed(0), cfg, (2, 3))
    assert jax.tree.map(lambda a: (2, 3) + tuple(a.shape), jp) == \
        TR.tree_map(lambda a: tuple(a.shape), mine)
    m = cfg.mla
    assert mine["wo_mla"]["w"].shape[-3:] == (cfg.n_heads, m.v_head_dim,
                                              cfg.d_model)
    assert m.v_head_dim != m.qk_nope_dim + m.qk_rope_dim


@pytest.mark.parametrize("blockwise", [False, True])
def test_mla_attention_matches_jax(blockwise):
    """The naive-form forward, direct and blockwise (chunks of 16 over a
    sequence of 64: the causal block skip and the online softmax)."""
    kw = dict(attn_direct_max=16, attn_chunk=16) if blockwise else {}
    cfg, jcfg = configs(**kw)
    jp, p = layer(jcfg)
    x = inputs(cfg, 2, 64)
    pos = np.arange(64)
    out = A.mla_attention(p, torch.from_numpy(x), torch.from_numpy(pos),
                          cfg)
    jout = JA.mla_attention(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jnp.asarray(pos), jcfg)
    assert out.shape == x.shape
    close(out, jout)


def test_latent_projection_matches_jax():
    """q_nope, q_rope (rotated per head), the latent and k_rope (rotated
    once, shared by the heads)."""
    cfg, jcfg = configs()
    jp, p = layer(jcfg, seed=1)
    x = inputs(cfg, 2, 12, seed=1)
    pos = np.arange(12)
    mine = A._mla_qkv_latent(p, torch.from_numpy(x), torch.from_numpy(pos),
                             cfg)
    ref = JA._mla_qkv_latent(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             jnp.asarray(pos), jcfg)
    for a, b in zip(mine, ref):
        assert tuple(a.shape) == b.shape
        close(a, b)


def test_init_cache_matches_jax():
    cfg, jcfg = configs()
    jc = JA.mla_init_cache(jcfg, 3, 20, jnp.bfloat16)
    c = A.mla_init_cache(cfg, 3, 20, torch.bfloat16, (2,))
    assert type(c) is A.MLACache
    assert [tuple(t.shape) for t in c] == [(2,) + a.shape for a in jc]
    assert all(t.dtype == torch.bfloat16 and not t.any() for t in c)


@pytest.mark.parametrize("window", [0, 6])
def test_mla_decode_matches_jax_and_the_forward(window):
    """12 steps from an empty cache: the output of every step and the cache
    at the end against JAX's absorbed-form decode; without a window, every
    step against the port's naive-form forward at the same position."""
    cfg, jcfg = configs()
    jp, p = layer(jcfg, seed=2)
    B, S = 2, 12
    x = inputs(cfg, B, S, seed=2)
    jc = JA.mla_init_cache(jcfg, B, 16, jnp.float32)
    c = A.mla_init_cache(cfg, B, 16, torch.float32)
    jfn = jax.jit(JA.mla_decode, static_argnums=(4, 5))
    outs = []
    for t in range(S):
        jo, jc = jfn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x[:, t:t + 1]),
                     jc, jnp.int32(t), jcfg, window)
        pos = torch.full((B,), t)
        ctx = A.mla_decode_context(pos, 16, cfg, window)
        o, c = A.mla_decode(p, torch.from_numpy(x[:, t:t + 1]), c, pos, cfg,
                            ctx)
        close(o, jo)
        outs.append(o)
    for a, b in zip(c, jc):
        close(a, b)
    if window == 0:
        fwd = A.mla_attention(p, torch.from_numpy(x), torch.arange(S), cfg)
        close(torch.cat(outs, dim=1), fwd.detach().numpy())


def test_mla_decode_takes_one_position_per_row():
    """Rows at depths 3, 7 and 10 in one call give what each gives at its
    own position alone; the cache given is left as it was."""
    cfg, jcfg = configs()
    jp, p = layer(jcfg, seed=3)
    x = inputs(cfg, 3, 11, seed=3)
    c = A.mla_init_cache(cfg, 3, 16, torch.float32)
    for t in range(10):
        pos = torch.full((3,), t)
        _, c = A.mla_decode(p, torch.from_numpy(x[:, t:t + 1]), c, pos, cfg,
                            A.mla_decode_context(pos, 16, cfg))
    before = TR.tree_map(torch.clone, c)
    pos = torch.tensor([3, 7, 10])
    xt = torch.from_numpy(x[np.arange(3), pos.numpy()][:, None])
    o, c2 = A.mla_decode(p, xt, c, pos, cfg, A.mla_decode_context(pos, 16,
                                                                  cfg))
    assert all(torch.equal(a, b) for a, b in zip(c, before))
    for r in range(3):
        pr = pos[r:r + 1]
        cr = A.MLACache(*(t[r:r + 1] for t in c))
        orow, crow = A.mla_decode(p, xt[r:r + 1], cr, pr, cfg,
                                  A.mla_decode_context(pr, 16, cfg))
        close(o[r:r + 1], orow.detach().numpy())
        for a, b in zip(c2, crow):
            close(a[r:r + 1], b.detach().numpy())
