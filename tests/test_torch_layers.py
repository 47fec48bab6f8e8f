"""The port's models/layers.py and the GQA half of models/attention.py
against the JAX package's functions, on the same numpy inputs, at f32:
rmsnorm, RoPE, the MLPs, embedding and heads, the mask bias, direct
attention, and blockwise against direct attention (causal, windowed,
non-causal; tests/test_attention.py's cases).

Tolerance rtol 1e-5 / atol 1e-5 (f32 on both sides: XLA and PyTorch order
their sums differently, a few ulps); blockwise against direct 2e-4 as in
tests/test_attention.py (the online softmax rescales in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(mine, ref, tol=TOL):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref), **tol)


def test_rmsnorm_and_rmsnorm_nd():
    r = rng(1)
    x = r.normal(size=(2, 5, 16)).astype(np.float32)
    scale = r.normal(size=(16,)).astype(np.float32)
    close(L.rmsnorm({"scale": t(scale)}, t(x), 1e-6),
          JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))
    close(L.rmsnorm_nd(t(scale), t(x), 1e-5),
          JL.rmsnorm_nd(jnp.asarray(scale), jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
def test_rope(fraction):
    r = rng(2)
    x = r.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.arange(12)
    np.testing.assert_array_equal(L.rope_freqs(16, fraction, 1e4),
                                  JL.rope_freqs(16, fraction, 1e4))
    close(L.apply_rope(t(x), torch.arange(12), 1e4, fraction),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction))


def test_sinusoids():
    np.testing.assert_array_equal(L.sinusoidal_positions(7, 8),
                                  JL.sinusoidal_positions(7, 8))
    close(L.sinusoid_at(torch.tensor(5), 8),
          JL.sinusoid_at(jnp.asarray(5), 8))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("relu2", False)])
def test_mlp(act, gated):
    r = rng(3)
    d, ff = 16, 32
    p = {"up": {"w": r.normal(size=(d, ff))},
         "down": {"w": r.normal(size=(ff, d))}}
    if gated:
        p["gate"] = {"w": r.normal(size=(d, ff))}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32) / 4, p)
    x = r.normal(size=(2, 3, d)).astype(np.float32)
    mine = L.mlp(jax.tree.map(t, p), t(x), act)
    close(mine, JL.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act),
          dict(rtol=1e-5, atol=1e-4))


def test_embed_and_heads():
    r = rng(4)
    tbl = r.normal(size=(11, 8)).astype(np.float32)
    w = r.normal(size=(8, 11)).astype(np.float32)
    toks = r.integers(0, 11, size=(2, 5)).astype(np.int32)
    x = r.normal(size=(2, 5, 8)).astype(np.float32)
    close(L.embed({"table": t(tbl)}, t(toks)),
          JL.embed({"table": jnp.asarray(tbl)}, jnp.asarray(toks)))
    for cap in (0.0, 3.0):
        close(L.unembed({"table": t(tbl)}, t(x), cap),
              JL.unembed({"table": jnp.asarray(tbl)}, jnp.asarray(x), cap))
        close(L.lm_head({"w": t(w)}, t(x), cap),
              JL.lm_head({"w": jnp.asarray(w)}, jnp.asarray(x), cap))


def test_grad_dtype_barrier_casts_the_cotangent():
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = L.grad_dtype_barrier(x)
    g, = torch.autograd.grad((y.float() * 2.0).sum(), x)
    assert g.dtype == torch.bfloat16 and torch.equal(y, x)


def test_dense_init_is_seeded_and_truncated():
    a = L.dense_init(torch.Generator().manual_seed(0), 64, 8, 4,
                     dtype=torch.float32, lead=(2,))
    b = L.dense_init(torch.Generator().manual_seed(0), 64, 8, 4,
                     dtype=torch.float32, lead=(2,))
    assert a.shape == (2, 64, 8, 4) and torch.equal(a, b)
    assert float(a.abs().max()) <= 3.0 / 8.0
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("max_elements",
                         [64 * 8 * 4, 8 * 4, 16, 3, 1, 96, 100])
def test_sliced_init_is_one_draw(max_elements, monkeypatch):
    """A leaf past ``MAX_DRAW_ELEMENTS`` is drawn block by block along its
    leading axes into a leaf in its own dtype; on the CPU the numbers are
    those of one draw of the whole leaf, bit for bit (dense and embedding
    inits; the embedding's normal draw fills 16 numbers at a time, so its
    blocks of 48 x 16 and 16 elements).  At 96 and 100 a block holds
    several rows: 3 rows of 8 x 4 (dense) or 6 of 16 (embedding), 96
    elements each, the 100's rounded down to a multiple of 16."""
    def dense():
        return L.dense_init(torch.Generator().manual_seed(3), 64, 8, 4,
                            dtype=torch.bfloat16, lead=(3, 2))

    def embed():
        return L.embed_init(torch.Generator().manual_seed(3), 48, 16,
                            torch.bfloat16, (3,))["table"]

    for fn in ((dense, embed) if max_elements % 16 == 0
               or max_elements > 16 else (dense,)):
        whole = fn()
        with monkeypatch.context() as m:
            m.setattr(L, "MAX_DRAW_ELEMENTS", max_elements)
            sliced = fn()
        assert sliced.dtype == torch.bfloat16
        assert torch.equal(whole.view(torch.int16), sliced.view(torch.int16))
    if max_elements in (96, 100):          # blocks of several whole rows
        blocks = []

        def fill(t):
            blocks.append(tuple(t.shape))
            return t.fill_(1.0)

        monkeypatch.setattr(L, "MAX_DRAW_ELEMENTS", max_elements)
        out = L._draw((3, 2, 64, 8, 4), torch.bfloat16, None, fill)
        assert blocks == [(3, 8, 4)] * 128 and bool((out == 1).all())


# --------------------------------------------------------------- attention

def _qkv(B=2, S=256, H=4, G=2, hd=16, seed=0):
    r = rng(seed)
    return tuple(r.normal(size=(B, S, n, hd)).astype(np.float32)
                 for n in (H, G, G))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0)])
def test_mask_bias(causal, window):
    pos = np.arange(8)
    mine = A._mask_bias(torch.arange(8), torch.arange(8), causal, window)
    ref = JA._mask_bias(jnp.asarray(pos), jnp.asarray(pos), causal, window)
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert A.NEG_INF == JA.NEG_INF


@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 32),
                                                 (True, 64, 32),
                                                 (False, 0, 32),
                                                 (True, 64, 128)])
def test_direct_and_blockwise_attention(causal, window, chunk):
    q, k, v = _qkv(S=128 if not causal else 256)
    S = q.shape[1]
    pos = np.arange(S)
    tq, tk, tv = map(t, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    bias = A._mask_bias(torch.arange(S), torch.arange(S), causal,
                        window)[None, None]
    jbias = JA._mask_bias(jnp.asarray(pos), jnp.asarray(pos), causal,
                          window)[None, None]
    direct = A._direct_attn(tq, tk, tv, bias)
    close(direct, JA._direct_attn(jq, jk, jv, jbias))
    block = A._blockwise_attn(tq, tk, tv, torch.arange(S), torch.arange(S),
                              causal, window, chunk)
    close(block, JA._blockwise_attn(jq, jk, jv, jnp.asarray(pos),
                                    jnp.asarray(pos), causal, window, chunk))
    close(block, direct.numpy(), BLOCK_TOL)
    # no block skipping: the same result with every block computed
    full = A._blockwise_attn(tq, tk, tv, torch.arange(S), torch.arange(S),
                             causal, window, chunk, block_skip=False)
    close(full, block.numpy(), BLOCK_TOL)


@pytest.mark.parametrize("S,qk_norm", [(32, True), (64, False)])
def test_self_attention_both_paths(S, qk_norm):
    """Direct path at S <= attn_direct_max, blockwise above it."""
    kw = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, window=16, qk_norm=qk_norm, attn_chunk=16,
              attn_direct_max=32, param_dtype="float32",
              compute_dtype="float32")
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    jp = JA.gqa_init(jax.random.key(0), jcfg)
    p = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    x = rng(5).normal(size=(2, S, 32)).astype(np.float32)
    pos = np.arange(S)
    mine = A.self_attention(p, t(x), torch.arange(S), cfg, True, 16)
    ref = JA.self_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, True,
                            16)
    close(mine, ref, dict(rtol=1e-5, atol=2e-5))
    gen = torch.Generator().manual_seed(0)
    mp = A.gqa_init(gen, cfg)
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda a: tuple(a.shape), mp)
