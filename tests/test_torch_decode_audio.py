"""The audio family's decode (models/decode.py: the self KV cache beside
every decoder layer's cross K/V, ``encode_for_decode``, the decoder's
sinusoid at each row's position) against the JAX package's
``repro.models.decode``, on whisper-tiny's smoke config from the JAX
initial weights; decode against the full-sequence forward over the same
frames; and ragged decode at one position per row against each row run
alone.

Tolerances: f32 rtol 1e-4 / atol 1e-5 over 12 steps (the same arithmetic
summed in another order); bf16 rtol 2e-2 with an absolute floor of 2e-2
of the largest magnitude.  The port against itself at one batch size is
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "whisper-tiny"
F32 = dict(rtol=1e-4, atol=1e-5)
jax_step = jax.jit(JD.decode_step, static_argnums=(4, 5))
jax_ragged = jax.jit(JD.decode_step_ragged, static_argnums=(4, 5))
jax_encode = jax.jit(JD.encode_for_decode, static_argnums=(3,))


def configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def models(dtype="float32"):
    cfg, jcfg = configs(dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def frames(cfg, batch, seed=0):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.n_frames, cfg.d_model)).astype(np.float32)


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape)


def tt(a):
    return torch.from_numpy(np.array(a, np.int64))


def compare(mine, ref, dtype="float32"):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, **F32)
    else:
        np.testing.assert_allclose(mine, ref, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(ref).max()))


def encoded(p, cfg, fr, max_len):
    return D.encode_for_decode(p, D.init_cache(cfg, fr.shape[0], max_len),
                               torch.from_numpy(fr), cfg)


@pytest.mark.parametrize("window_override", [None, 8])
def test_init_cache_tree_matches_jax(window_override):
    cfg, jcfg = configs("bfloat16")
    jc = jax.eval_shape(lambda: JD.init_cache(jcfg, 3, 32, window_override))
    mine = D.init_cache(cfg, 3, 32, window_override)
    assert TR.tree_map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       mine) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jc)
    assert type(mine["blocks"]["self"]) is A.KVCache
    assert all(float(l.abs().sum()) == 0 for l in TR.leaves(mine))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_steps_match_jax(dtype):
    """encode_for_decode's cross K/V, then 12 steps: logits at every step
    and the whole cache at the end."""
    cfg, jcfg, p, jp = models(dtype)
    fr = frames(cfg, 2)
    toks = tokens(cfg, (2, 12))
    jc = jax_encode(jp, JD.init_cache(jcfg, 2, 16), jnp.asarray(fr), jcfg)
    c = encoded(p, cfg, fr, 16)
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        compare(a, b, dtype)
    assert float(c["blocks"]["cross_k"].abs().sum()) > 0
    for t in range(12):
        jl, jc = jax_step(jp, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t), jcfg, None)
        lg, c = D.decode_step(p, c, tt(toks[:, t:t + 1]), t, cfg)
        assert lg.shape == (2, 1, cfg.vocab) and lg.dtype == torch.float32
        compare(lg, jl, dtype)
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        compare(a, b, dtype)


def test_decode_matches_the_forward():
    """Every position's decode logits (from the cross K/V that
    encode_for_decode wrote) against the full-sequence forward over the
    same frames, f32."""
    cfg, _, p, _ = models()
    fr = frames(cfg, 2)
    toks = tt(tokens(cfg, (2, 24)))
    dec, _ = D.prefill_cache(p, encoded(p, cfg, fr, 24), toks, 0, cfg,
                             all_logits=True)
    fwd, _ = T.forward(p, {"tokens": toks, "frames": torch.from_numpy(fr)},
                       cfg)
    assert dec.shape == fwd.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **F32)


def test_a_step_passes_the_cross_kv_through():
    """A step returns the very cross K/V tensors it was given (no copy)
    and leaves the cache it was given as it was."""
    cfg, _, p, _ = models("bfloat16")
    c = encoded(p, cfg, frames(cfg, 2), 16)
    before = TR.tree_map(torch.clone, c)
    _, new = D.decode_step(p, c, tt([[3], [4]]), 0, cfg)
    assert new["blocks"]["cross_k"] is c["blocks"]["cross_k"]
    assert new["blocks"]["cross_v"] is c["blocks"]["cross_v"]
    assert not torch.equal(new["blocks"]["self"].k, c["blocks"]["self"].k)
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(c),
                                                 TR.leaves(before)))


def test_ragged_rows_match_each_row_alone_and_jax():
    """Three rows, each with its own frames, prefilled to depths 3, 7 and
    11, then three ragged steps: each row's logits equal that row decoded
    alone at batch 1 with an int position (f32, to summation order) and
    the JAX package's vmapped decode_step_ragged."""
    cfg, jcfg, p, jp = models()
    depth = [3, 7, 11]
    fr = frames(cfg, 3)
    toks = tokens(cfg, (3, 14))
    c = encoded(p, cfg, fr, 16)
    jc = jax_encode(jp, JD.init_cache(jcfg, 3, 16), jnp.asarray(fr), jcfg)
    alone = []
    for b, n in enumerate(depth):
        row = TR.tree_map(lambda l: l[:, b:b + 1], c)
        _, row = D.prefill_cache(p, row, tt(toks[b:b + 1, :n]), 0, cfg)
        for l, r in zip(TR.leaves(c), TR.leaves(row)):
            l[:, b:b + 1] = r
        alone.append(row)
        jrow = jax.tree.map(lambda l: l[:, b:b + 1], jc)
        _, jrow = JD.prefill_cache(jp, jrow, jnp.asarray(toks[b:b + 1, :n],
                                                         jnp.int32),
                                   jnp.int32(0), jcfg)
        jc = jax.tree.map(lambda l, r: l.at[:, b:b + 1].set(r), jc, jrow)
    pos = np.asarray(depth)
    for _ in range(3):
        tok = toks[np.arange(3), pos][:, None]
        lg, c = D.decode_step_ragged(p, c, tt(tok), tt(pos), cfg)
        jl, jc = jax_ragged(jp, jc, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32), jcfg, None)
        compare(lg, jl)
        for b in range(3):
            lb, alone[b] = D.decode_step(p, alone[b], tt(tok[b:b + 1]),
                                         int(pos[b]), cfg)
            compare(lg[b:b + 1], lb.numpy())
        pos = pos + 1


def test_a_row_does_not_see_its_neighbours():
    """Row 0 decodes to the same bits whatever the other rows hold (their
    frames, tokens and positions), at one batch size."""
    cfg, _, p, _ = models("bfloat16")
    out = []
    for seed in (0, 1):
        fr = frames(cfg, 3, seed)
        fr[0] = frames(cfg, 1, 9)[0]
        toks = tokens(cfg, (3, 5), seed)
        toks[0] = tokens(cfg, (1, 5), 9)[0]
        _, c = D.prefill_cache(p, encoded(p, cfg, fr, 16), tt(toks), 0, cfg)
        lg, c = D.decode_step_ragged(p, c, tt(toks[:, :1]),
                                     tt([5, 1 + seed, 4 - seed]), cfg)
        out.append((lg[0], TR.tree_map(lambda l: l[:, 0], c)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(out[0][1]),
                                                 TR.leaves(out[1][1])))
