"""The hybrid family's decode (models/decode.py: per group two RG-LRU
caches and a local-attention ring of ``min(local_window, max_len)`` slots,
and the rec tail's caches) against the JAX package's
``repro.models.decode`` on recurrentgemma-9b's smoke config (5 layers: one
group and a 2-layer tail; local window 32) from the JAX initial weights
drawn under ``jax.threefry_partitionable(False)``; decode against the
port's full-sequence forward; ragged decode at one position per row
against each row alone; and the slot pool's zeroing of the RG-LRU state.

Tolerances: f32 rtol 1e-4 / atol 1e-5 over 48 steps (the same arithmetic
summed in another order); bf16 rtol 2e-2 with an absolute floor of 5e-2
of the largest magnitude.  In bf16 the two packages round the
projections, norms and gates differently by an ulp here and there, and
the RG-LRU states carry each step's difference into the next: over 48
steps the largest logit difference reads 0.7-3.9% of the largest logit
(about 0.75) on the CPU, settling near 2% rather than growing.  The port
against itself at one batch size is bit for bit."""
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
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.kvpool import KVSlotPool  # noqa: E402

ARCH = "recurrentgemma-9b"
F32 = dict(rtol=1e-4, atol=1e-5)
#: past the smoke local window (32), so the ring wraps
SEQ = 48
jax_step = jax.jit(JD.decode_step, static_argnums=(4, 5))
jax_ragged = jax.jit(JD.decode_step_ragged, static_argnums=(4, 5))


def configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def models(dtype="float32"):
    cfg, jcfg = configs(dtype)
    with jax.threefry_partitionable(False):
        jp = jax.tree.map(np.asarray,
                          JT.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


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
                                   atol=5e-2 * float(np.abs(ref).max()))


@pytest.mark.parametrize("max_len", [64, 16])
def test_init_cache_tree_matches_jax(max_len):
    """At max_len 64 the ring holds the local window (32 slots), at 16 the
    whole sequence; the RG-LRU state is f32, its conv window bf16."""
    cfg, jcfg = configs("bfloat16")
    jc = jax.eval_shape(lambda: JD.init_cache(jcfg, 3, max_len))
    mine = D.init_cache(cfg, 3, max_len)
    assert TR.tree_map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")),
                       mine) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jc)
    assert type(mine["groups"]["attn"]) is A.KVCache
    assert type(mine["groups"]["rec1"]) is R.RGLRUCache
    assert type(mine["tail_blocks"]) is R.RGLRUCache
    assert mine["groups"]["attn"].k.shape[2] == min(32, max_len)
    assert mine["tail_blocks"].h.dtype == torch.float32
    assert all(float(l.abs().sum()) == 0 for l in TR.leaves(mine))


@pytest.mark.parametrize("path,dtype", [("decode_step", "float32"),
                                        ("prefill_cache", "float32"),
                                        ("decode_step", "bfloat16")])
def test_decode_matches_jax(path, dtype):
    """48 steps from an empty cache (the ring of 32 wraps): logits at every
    step and the whole cache at the end, through ``decode_step`` one token
    at a time or one ``prefill_cache`` call."""
    cfg, jcfg, p, jp = models(dtype)
    toks = tokens(cfg, (2, SEQ))
    jc = JD.init_cache(jcfg, 2, 64)
    ref = []
    for t in range(SEQ):
        jl, jc = jax_step(jp, jc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t), jcfg, None)
        ref.append(np.asarray(jl)[:, 0])
    c = D.init_cache(cfg, 2, 64)
    if path == "prefill_cache":
        lg, c = D.prefill_cache(p, c, tt(toks), 0, cfg, all_logits=True)
        compare(lg, np.stack(ref, axis=1), dtype)
    else:
        for t in range(SEQ):
            lg, c = D.decode_step(p, c, tt(toks[:, t:t + 1]), t, cfg)
            assert lg.shape == (2, 1, cfg.vocab) and lg.dtype == torch.float32
            compare(lg[:, 0], ref[t], dtype)
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        compare(a, b, dtype)


def test_decode_matches_the_forward():
    """Every position's decode logits against the port's full-sequence
    forward over the same 48 tokens (the local window masking there, the
    ring wrapping here), f32."""
    cfg, _, p, _ = models()
    toks = tt(tokens(cfg, (2, SEQ)))
    dec, _ = D.prefill_cache(p, D.init_cache(cfg, 2, 64), toks, 0, cfg,
                             all_logits=True)
    fwd, _ = T.forward(p, {"tokens": toks}, cfg)
    assert dec.shape == fwd.shape == (2, SEQ, cfg.vocab)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), **F32)


def test_ragged_rows_match_each_row_alone_and_jax():
    """Three rows prefilled to depths 3, 17 and 33 (past the window), then
    three ragged steps: each row's logits equal that row decoded alone at
    batch 1 with an int position and the JAX package's vmapped
    decode_step_ragged."""
    cfg, jcfg, p, jp = models()
    depth = [3, 17, 33]
    toks = tokens(cfg, (3, 40))
    c = D.init_cache(cfg, 3, 64)
    jc = JD.init_cache(jcfg, 3, 64)
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
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        compare(a, b)


def test_a_row_does_not_see_its_neighbours():
    """Row 0 decodes to the same bits (logits, RG-LRU states, conv windows
    and ring) whatever the other rows hold and wherever they are, at one
    batch size."""
    cfg, _, p, _ = models("bfloat16")
    out = []
    for seed in (0, 1):
        toks = tokens(cfg, (3, 36), seed)
        toks[0] = tokens(cfg, (1, 36), 9)[0]
        _, c = D.prefill_cache(p, D.init_cache(cfg, 3, 64), tt(toks), 0,
                               cfg)
        lg, c = D.decode_step_ragged(p, c, tt(toks[:, :1]),
                                     tt([36, 1 + seed, 40 - seed]), cfg)
        out.append((lg[0], TR.tree_map(lambda l: l[:, 0], c)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(out[0][1]),
                                                 TR.leaves(out[1][1])))


def test_pool_alloc_zeroes_the_rglru_state_and_write_slots_commits_it():
    """A freed slot's RG-LRU state, conv window and ring are zero again at
    its next ``alloc``; ``write_slots`` copies the given slots of a stepped
    arena (RG-LRU leaves included) and leaves the others' bytes."""
    cfg, _, p, _ = models("bfloat16")
    pool = KVSlotPool.create(cfg, 3, 64)
    for _ in range(3):
        pool.alloc()
    _, stepped = D.decode_step_ragged(p, pool.arena, tt([[5], [6], [7]]),
                                      tt([0, 0, 0]), cfg)
    before = TR.tree_map(torch.clone, pool.arena)
    pool.write_slots(tt([0, 2]), stepped)
    for l, s, b in zip(TR.leaves(pool.arena), TR.leaves(stepped),
                       TR.leaves(before)):
        assert torch.equal(l[:, [0, 2]], s[:, [0, 2]])
        assert torch.equal(l[:, 1], b[:, 1])
    h = pool.arena["groups"]["rec1"].h
    assert float(h[:, 2].abs().sum()) > 0
    assert float(pool.arena["tail_blocks"].conv[:, 2].abs().sum()) > 0
    pool.free(2)
    assert pool.alloc() == 2
    for l in TR.leaves(pool.arena):
        assert float(l[:, 2].float().abs().sum()) == 0
    assert float(h[:, 0].abs().sum()) > 0
