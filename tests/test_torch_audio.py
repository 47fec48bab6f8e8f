"""The audio family (whisper-tiny's smoke config: 2 encoder and 2 decoder
layers, d 128, 64 frames) against the JAX package, from the JAX initial
weights carried across with convert.params_from_numpy: the parameter tree,
``encode`` (a non-causal encoder over frame embeddings plus sinusoids),
the forward (decoder sinusoids, self and cross attention, the non-gated
gelu MLP), two FrODO exp-sum train steps on batches from
``augment_modalities``, and ``sinusoid_at`` at one position per row.

Tolerances: f32 rtol 1e-5 / atol 1e-5 for encode and the forward (the same
f32 arithmetic summed in another order, ~1e-6 of values of magnitude
~3); the train steps test_torch_train_step.py's rtol 1e-4 / atol 1e-5; bf16
rtol 2e-2 with an absolute floor of 2e-2 of the largest magnitude
(test_torch_transformer.py's: ``jax.nn.gelu`` rounds after each of its
operations in bf16, ``F.gelu`` once, and bf16 keeps ~3 digits); the
sinusoids atol 1e-6 (f32 powers and sines of XLA and PyTorch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check  # noqa: E402

from repro.configs import registry as JREG  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import synthetic as SYN  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "whisper-tiny"
F32 = dict(rtol=1e-5, atol=1e-5)


def configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def token_batches(cfg, agents, n, seq, bpa=2):
    pipe = SYN.TokenPipeline(vocab=cfg.vocab, seq_len=seq,
                             batch_per_agent=bpa, n_agents=agents, seed=0)
    return list(SYN.augment_modalities(iter([next(pipe) for _ in range(n)]),
                                       cfg))


def model(dtype):
    cfg, jcfg = configs(dtype)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def compare(mine, ref, dtype):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, **F32)
    else:
        np.testing.assert_allclose(mine, ref, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(ref).max()))


def test_init_tree_matches_the_jax_tree():
    cfg, jcfg = configs("bfloat16")
    jp = jax.eval_shape(lambda k: JT.init_params(k, jcfg), jax.random.key(0))
    mine = T.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        TR.tree_map(lambda a: (tuple(a.shape), "bfloat16"), mine)
    assert all(a.dtype == torch.bfloat16 for a in TR.leaves(mine))
    assert TR.leaves(mine["enc_blocks"])[0].shape[0] == cfg.n_enc_layers
    assert set(mine["blocks"]) == {"attn", "ln1", "ln2", "ln_x", "mlp",
                                   "xattn"}
    assert "gate" not in mine["blocks"]["mlp"]        # the gelu MLP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_forward_match_jax(dtype):
    cfg, jcfg, p, jp = model(dtype)
    b = {k: v[0] for k, v in token_batches(cfg, 1, 1, 32)[0].items()}
    assert b["frames"].shape == (2, cfg.n_frames, cfg.d_model)
    tb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    enc = T.encode(p, tb["frames"], cfg)
    jenc = JT.encode(jp, jnp.asarray(b["frames"]), jcfg)
    assert enc.dtype == L.dtype_of(dtype)
    compare(enc, jenc, dtype)
    logits, aux = T.forward(p, tb, cfg)
    jl, _ = JT.forward(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    assert logits.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    compare(logits, jl, dtype)


def test_forward_reads_the_frames():
    cfg, _, p, _ = model("float32")
    b = {k: torch.from_numpy(v[0].copy())
         for k, v in token_batches(cfg, 1, 1, 16)[0].items()}
    a, _ = T.forward(p, b, cfg)
    b["frames"] = b["frames"].flip(1)
    c, _ = T.forward(p, b, cfg)
    assert not torch.allclose(a, c, **F32)


def test_two_expsum_steps_match_jax():
    """Two FrODO exp-sum steps of 2 agents on batches with frames: every
    metric, the per-agent losses and the final parameters (encoder,
    cross attention and decoder leaves)."""
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


def test_sinusoid_at_one_position_per_row():
    """(B,) positions give (B, d): each row is the JAX package's sinusoid
    at that row's position, and the one-position form is a row of it."""
    d = 128
    pos = np.array([0, 1, 7, 63, 255, 4095])
    rows = L.sinusoid_at(torch.from_numpy(pos), d)
    assert rows.shape == (len(pos), d) and rows.dtype == torch.float32
    for i, q in enumerate(pos):
        ref = np.asarray(JL.sinusoid_at(jnp.asarray(q), d))
        np.testing.assert_allclose(rows[i].numpy(), ref, rtol=0, atol=1e-6)
        assert torch.equal(L.sinusoid_at(torch.tensor(q), d), rows[i])
    # the table the forward adds, to f32 rounding of the angles
    np.testing.assert_allclose(
        L.sinusoid_at(torch.arange(64), d).numpy(),
        L.sinusoidal_positions(64, d), rtol=0, atol=1e-5)
