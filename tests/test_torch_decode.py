"""The port's single-token decode (models/decode.py, the KV and latent
caches of models/attention.py) against the JAX package's
``repro.models.decode``, on the smoke configs of h2o-danube-1.8b (dense,
sliding window), mamba2-780m (SSM), qwen3-moe-30b-a3b and kimi-k2-1t-a32b
(MoE; kimi-k2 with a dense prefix layer and a shared expert) and
minicpm3-4b (MLA), from the JAX package's initial weights.  MoE decode is
compared in f32 only: in bf16 a one-ulp difference in a hidden state can
move a router's top-k choice.

Tolerances: f32 rtol 1e-4 / atol 1e-5 over 20 steps (the same arithmetic,
products summed in another order by XLA and PyTorch); bf16 rtol 2e-2 with
an absolute floor of 2e-2 of the largest magnitude.  The port against
itself is bit for bit: prefill_cache against stepwise decode_step, ragged
decode at one position against decode_step, and every row of a batch
against the same row decoded alone at the same batch size."""
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
from repro_torch.models.moe import no_drop  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DENSE, SSM = "h2o-danube-1.8b", "mamba2-780m"
QWEN, KIMI, MLA = "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "minicpm3-4b"
F32 = dict(rtol=1e-4, atol=1e-5)
#: the JAX package's steps, compiled once per config (eager JAX takes
#: ~0.5 s a step here)
jax_step = jax.jit(JD.decode_step, static_argnums=(4, 5))
jax_ragged = jax.jit(JD.decode_step_ragged, static_argnums=(4, 5))
jax_prefill = jax.jit(JD.prefill_cache, static_argnums=(4, 5))


def configs(arch, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(arch).replace(**kw),
            JREG.get_smoke_config(arch).replace(**kw))


def compare(mine, ref, dtype="float32"):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, **F32)
    else:
        np.testing.assert_allclose(mine, ref, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(ref).max()))


def models(arch, dtype="float32", seed=0):
    cfg, jcfg = configs(arch, dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, shape).astype(
        np.int32)


def tt(a):
    return torch.from_numpy(np.array(a, np.int64))


def tree_equal(a, b):
    la, lb = TR.leaves(a), TR.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ------------------------------------------------------------- the cache

@pytest.mark.parametrize("arch,window_override,max_len", [
    (DENSE, None, 32),        # smoke window 64 > max_len: a plain cache
    (DENSE, None, 128),       # window 64 < max_len: a ring of 64
    (DENSE, 0, 48),           # no window at all
    (DENSE, 16, 48),          # window override
    (SSM, None, 48), (QWEN, None, 32), (KIMI, None, 32), (MLA, None, 32)])
def test_init_cache_tree_matches_jax(arch, window_override, max_len):
    cfg, jcfg = configs(arch, "bfloat16")
    jc = jax.eval_shape(lambda: JD.init_cache(jcfg, 3, max_len,
                                              window_override))
    mine = D.init_cache(cfg, 3, max_len, window_override)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jc)
    assert TR.tree_map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       mine) == want
    assert all(float(l.abs().sum()) == 0 for l in TR.leaves(mine))
    cache = mine["blocks"]
    assert type(cache) is {SSM: S.MambaCache, MLA: A.MLACache}.get(
        arch, A.KVCache)
    assert ("dense_blocks" in mine) == (arch == KIMI)
    if arch == DENSE:                # k and v are two tensors, not one
        assert cache.k.data_ptr() != cache.v.data_ptr()


# ------------------------------------------------------- the step vs JAX

@pytest.mark.parametrize("arch,dtype,window_override", [
    (DENSE, "float32", 8), (DENSE, "bfloat16", 8), (DENSE, "float32", None),
    (SSM, "float32", None), (SSM, "bfloat16", None), (QWEN, "float32", None),
    (KIMI, "float32", None), (MLA, "float32", None), (MLA, "bfloat16", None),
    (MLA, "float32", 8)])
def test_decode_step_matches_jax(arch, dtype, window_override):
    """20 steps from an empty cache: logits at every step and the cache at
    the end.  With a window of 8 the ring wraps twice."""
    cfg, jcfg, p, jp = models(arch, dtype)
    jc = JD.init_cache(jcfg, 2, 32, window_override)
    c = D.init_cache(cfg, 2, 32, window_override)
    toks = tokens(cfg, (2, 20))
    for step in range(20):
        jl, jc = jax_step(jp, jc, jnp.asarray(toks[:, step:step + 1]),
                          jnp.int32(step), jcfg, window_override)
        lg, c = D.decode_step(p, c, tt(toks[:, step:step + 1]), step, cfg,
                              window_override)
        assert lg.dtype == torch.float32 and lg.shape == (2, 1, cfg.vocab)
        compare(lg, jl, dtype)
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        compare(a, b, dtype)


def test_decode_step_leaves_its_cache_as_it_was():
    for arch in (DENSE, SSM):
        cfg, _, p, _ = models(arch)
        c = D.prefill_cache(p, D.init_cache(cfg, 2, 16),
                            tt(tokens(cfg, (2, 5))), 0, cfg)[1]
        before = TR.tree_map(torch.clone, c)
        D.decode_step(p, c, tt(tokens(cfg, (2, 1), 1)), 5, cfg)
        assert tree_equal(c, before)


@pytest.mark.parametrize("arch", [DENSE, SSM, QWEN, KIMI, MLA])
def test_decode_matches_the_forward(arch):
    """Every position's decode logits against the full-sequence forward,
    f32, past a ring wrap for the dense model (window override 16); the
    MoE forward with the capacity of every token (decode drops none)."""
    cfg, _, p, _ = models(arch)
    wo = 16 if arch == DENSE else None
    toks = tt(tokens(cfg, (2, 64)))
    dec, _ = D.prefill_cache(p, D.init_cache(cfg, 2, 64, wo), toks, 0, cfg,
                             wo, all_logits=True)
    fwd, _ = T.forward(p, {"tokens": toks}, no_drop(cfg),
                       window_override=wo)
    assert dec.shape == fwd.shape == (2, 64, cfg.vocab)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **F32)


# ---------------------------------------------------- prefill + ragged

@pytest.mark.parametrize("arch,dtype", [(DENSE, "bfloat16"),
                                        (SSM, "bfloat16"), (SSM, "float32"),
                                        (KIMI, "float32"), (MLA, "bfloat16")])
def test_prefill_cache_is_stepwise_decode_bit_for_bit(arch, dtype):
    """Also in chunks from a running offset (pos0 > 0), as the scheduler
    prefills; and the JAX package's last logits."""
    cfg, jcfg, p, jp = models(arch, dtype)
    toks = tokens(cfg, (2, 12))
    c = D.init_cache(cfg, 2, 32)
    for step in range(12):
        lg, c = D.decode_step(p, c, tt(toks[:, step:step + 1]), step, cfg)
    c1 = D.init_cache(cfg, 2, 32)
    last1, c1 = D.prefill_cache(p, c1, tt(toks[:, :5]), 0, cfg)
    last, c1 = D.prefill_cache(p, c1, tt(toks[:, 5:]), 5, cfg)
    assert tree_equal(c, c1)
    assert torch.equal(last, lg[:, -1]) and last.shape == (2, cfg.vocab)
    jlast, _ = jax_prefill(jp, JD.init_cache(jcfg, 2, 32),
                           jnp.asarray(toks), jnp.int32(0), jcfg, None)
    compare(last, jlast, dtype)


@pytest.mark.parametrize("arch", [DENSE, SSM, KIMI, MLA])
def test_ragged_decode_at_one_position_is_decode_step(arch):
    cfg, _, p, _ = models(arch, "bfloat16")
    _, cache = D.prefill_cache(p, D.init_cache(cfg, 2, 32),
                               tt(tokens(cfg, (2, 3))), 0, cfg)
    tok = tt([[7], [8]])
    lp, cp = D.decode_step(p, cache, tok, 3, cfg)
    lr, cr = D.decode_step_ragged(p, cache, tok, tt([3, 3]), cfg)
    assert torch.equal(lp, lr) and tree_equal(cp, cr)
    with pytest.raises(ValueError):
        D.decode_step_ragged(p, cache, tok, 3, cfg)
    with pytest.raises(ValueError):
        D.decode_step_ragged(p, cache, tok, tt([3, 3, 3]), cfg)


@pytest.mark.parametrize("arch,dtype,window_override", [
    (DENSE, "float32", 8), (DENSE, "bfloat16", None), (SSM, "float32", None),
    (SSM, "bfloat16", None), (QWEN, "float32", None), (KIMI, "float32", None),
    (MLA, "float32", None), (MLA, "bfloat16", None)])
def test_ragged_decode_at_mixed_positions_matches_jax(arch, dtype,
                                                      window_override):
    """Three rows prefilled to depths 3, 9 and 14 (past the ring of 8 for
    the dense case), then three ragged steps: logits and cache against
    JAX's vmapped decode_step_ragged."""
    cfg, jcfg, p, jp = models(arch, dtype)
    depth = [3, 9, 14]
    toks = tokens(cfg, (3, 17))
    jc = JD.init_cache(jcfg, 3, 32, window_override)
    c = D.init_cache(cfg, 3, 32, window_override)
    # prefill each row to its own depth, one row at a time
    for b, n in enumerate(depth):
        row = jax.tree.map(lambda l: l[:, b:b + 1], jc)
        _, row = jax_prefill(jp, row, jnp.asarray(toks[b:b + 1, :n]),
                             jnp.int32(0), jcfg, window_override)
        jc = jax.tree.map(lambda l, r: l.at[:, b:b + 1].set(r), jc, row)
        row = TR.tree_map(lambda l: l[:, b:b + 1], c)
        _, row = D.prefill_cache(p, row, tt(toks[b:b + 1, :n]), 0, cfg,
                                 window_override)
        for l, r in zip(TR.leaves(c), TR.leaves(row)):
            l[:, b:b + 1] = r
    pos = np.asarray(depth)
    for k in range(3):
        tok = toks[np.arange(3), pos][:, None]
        jl, jc = jax_ragged(jp, jc, jnp.asarray(tok),
                            jnp.asarray(pos, jnp.int32), jcfg,
                            window_override)
        lg, c = D.decode_step_ragged(p, c, tt(tok), tt(pos), cfg,
                                     window_override)
        compare(lg, jl, dtype)
        pos = pos + 1
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        compare(a, b, dtype)


@pytest.mark.parametrize("arch", [DENSE, SSM, QWEN, KIMI, MLA])
def test_a_row_does_not_see_its_neighbours(arch):
    """Row 0 of a batch decodes to the same bits whatever rows 1-3 hold
    (same batch size, other tokens, positions and caches): the property
    that makes packed serving bit-equal to solo serving."""
    cfg, _, p, _ = models(arch, "bfloat16")
    base = D.init_cache(cfg, 4, 32)
    out = []
    for seed in (0, 1):
        c = TR.tree_map(torch.clone, base)
        toks = tokens(cfg, (4, 6), seed)
        toks[0] = tokens(cfg, (1, 6), 9)[0]
        _, c = D.prefill_cache(p, c, tt(toks), 0, cfg)
        pos = tt([6, 2 + seed, 4, 5 - seed])
        lg, c = D.decode_step_ragged(p, c, tt(toks[:, :1]), pos, cfg)
        out.append((lg[0], TR.tree_map(lambda l: l[:, 0], c)))
    assert torch.equal(out[0][0], out[1][0])
    assert tree_equal(out[0][1], out[1][1])


def test_moe_decode_at_16_slots_never_drops():
    """16 slots, 16 experts top 2, qwen3-moe's capacity factor (1.25): the
    capacity of 16 tokens is 8.  With one token at one position in every
    slot, every row routes to the same two experts, 16 assignments each;
    decode keeps all of them, as the JAX package's per-slot decode does
    (logits against its ragged decode, f32; at the capacity of 8, half
    the rows would lose their experts' output)."""
    cfg, jcfg = configs(QWEN)
    m = dict(cfg.moe.__dict__, n_experts=16, top_k=2, capacity_factor=1.25)
    cfg = cfg.replace(moe=cfg.moe.__class__(**m))
    jcfg = jcfg.replace(moe=jcfg.moe.__class__(**m))
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    p = params_from_numpy(jp, "cpu")
    from repro_torch.models import moe as M
    assert M._capacity(16, cfg.moe) == 8
    toks = np.full((16, 1), 7, np.int32)
    pos = np.zeros(16, np.int32)
    jl, _ = jax_ragged(jax.tree.map(jnp.asarray, jp),
                       JD.init_cache(jcfg, 16, 8), jnp.asarray(toks),
                       jnp.asarray(pos), jcfg, None)
    lg, _ = D.decode_step_ragged(p, D.init_cache(cfg, 16, 8), tt(toks),
                                 tt(pos), cfg)
    compare(lg, jl)
    assert torch.equal(lg[0], lg[15])
