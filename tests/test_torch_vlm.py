"""The vision family (phi-3-vision-4.2b's smoke config: 2 layers, d 256,
16 image tokens) against the JAX package, in f32, from the JAX initial
weights carried across with convert.params_from_numpy: the parameter tree,
the forward with patch embeddings scattered at ``img_pos``, two FrODO
exp-sum train steps on batches from ``augment_modalities``, and decode
(the dense branch).

Tolerances: the forward rtol 1e-5 / atol 1e-5 on logits of magnitude ~4
(two layers of f32 products summed in another order, ~1e-6); the train
steps test_torch_train_step.py's rtol 1e-4 / atol 1e-5 (the backward and
two updates grow the difference); decode rtol 1e-4 / atol 1e-5 over 10
steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check  # noqa: E402

from repro.configs import registry as JREG  # noqa: E402
from repro.data import synthetic as JSYN  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import synthetic as SYN  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "phi-3-vision-4.2b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
DEC_TOL = dict(rtol=1e-4, atol=1e-5)


def configs():
    return (REG.get_smoke_config(ARCH).replace(**F32),
            JREG.get_smoke_config(ARCH).replace(**F32))


def token_batches(cfg, agents, n, seq, bpa=2):
    pipe = SYN.TokenPipeline(vocab=cfg.vocab, seq_len=seq,
                             batch_per_agent=bpa, n_agents=agents, seed=0)
    return list(SYN.augment_modalities(iter([next(pipe) for _ in range(n)]),
                                       cfg))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = configs()
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def test_init_tree_matches_the_jax_tree():
    cfg, jcfg = configs()
    jp = jax.eval_shape(lambda k: JT.init_params(k, jcfg), jax.random.key(0))
    mine = T.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        TR.tree_map(lambda a: tuple(a.shape), mine)
    assert "enc_blocks" not in mine and "xattn" not in mine["blocks"]


def test_modalities_are_the_jax_package_s():
    """The port's augment_modalities draws the JAX package's patch
    embeddings and positions, bit for bit."""
    cfg, jcfg = configs()
    mine = token_batches(cfg, 2, 2, 32)
    pipe = JSYN.TokenPipeline(vocab=jcfg.vocab, seq_len=32,
                              batch_per_agent=2, n_agents=2, seed=0)
    ref = list(JSYN.augment_modalities(iter([next(pipe), next(pipe)]),
                                       jcfg))
    for a, b in zip(mine, ref):
        assert set(a) == set(b) == {"tokens", "labels", "img_embeds",
                                    "img_pos"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_forward_with_image_tokens_matches_jax(model):
    cfg, jcfg, p, jp = model
    b = {k: v[0] for k, v in token_batches(cfg, 1, 1, 32)[0].items()}
    assert b["img_embeds"].shape == (2, cfg.n_img_tokens, cfg.d_model)
    tb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    logits, aux = T.forward(p, tb, cfg)
    jl, _ = JT.forward(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    assert logits.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **FWD_TOL)
    # the patch embeddings reach the model
    text, _ = T.forward(p, {"tokens": tb["tokens"]}, cfg)
    assert not torch.allclose(text, logits, **FWD_TOL)


def test_two_expsum_steps_match_jax():
    """Two FrODO exp-sum steps of 2 agents on batches with image tokens:
    every metric, the per-agent losses and the final parameters."""
    cfg, jcfg = configs()
    tc_kw = dict(memory_mode="expsum", T=8, K=4, grad_clip=1.0, remat=False,
                 collect_metrics=True, ce_chunks=4)
    jtc = JTS.TrainConfig(**tc_kw)
    jstate = JTS.init_train_state(jax.random.key(0), jcfg, jtc, 2)
    init = jax.tree.map(np.asarray, jstate.params)
    data = token_batches(cfg, 2, 2, 32)
    jstep = jax.jit(JTS.make_train_step(jcfg, jtc, 2, 1))
    ref = []
    for b in data:
        jstate, m = jstep(jstate, b)
        ref.append(jax.tree.map(np.asarray, m))
    tc = TS.TrainConfig(**tc_kw, use_kernel=True)
    state = TS.train_state_from_params(params_from_numpy(init, "cpu"), tc)
    step = TS.make_train_step(cfg, tc, 2, 1)
    mets = []
    for b in data:
        state, m = step(state, b)
        mets.append(m)
    check(ref, jax.tree.map(np.asarray, jstate.params), mets, state)


def test_decode_step_matches_jax(model):
    """The dense branch: 10 steps from an empty cache, logits at every step
    and the cache at the end."""
    cfg, jcfg, p, jp = model
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 10))
    jc = JD.init_cache(jcfg, 2, 16)
    c = D.init_cache(cfg, 2, 16)
    for t in range(10):
        jl, jc = JD.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1],
                                                    jnp.int32),
                                jnp.int32(t), jcfg)
        lg, c = D.decode_step(p, c, torch.from_numpy(toks[:, t:t + 1]), t,
                              cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **DEC_TOL)
    for a, b in zip(TR.leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **DEC_TOL)
