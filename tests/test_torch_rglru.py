"""The RG-LRU block (models/rglru.py) against the JAX package's
``repro.models.rglru`` on recurrentgemma-9b's smoke widths (d 128, d_rnn
128, conv width 4), from the JAX initial weights (drawn under
``jax.threefry_partitionable(False)``) carried across with
convert.params_from_numpy.

Tolerances:

* the scan, f32: rtol 1e-5 / atol 1e-6 against the JAX
  ``associative_scan`` and against a float64 sequential recurrence (the
  log-depth scan rounds about log2 S times per element, ~1e-6);
* its gradient: rtol 1e-4 / atol 1e-6 against float64 autograd through the
  sequential recurrence (the backward's products are summed along the
  same log-depth tree);
* ``_gates``, ``rglru_block`` and ``rglru_decode`` in f32: rtol 1e-5 /
  atol 1e-5 (products of 128 terms summed in another order, ~1e-6 on
  outputs of magnitude ~1);
* the same in bf16: 1e-2 of the largest magnitude, absolute.  The block's
  projections round their outputs to bf16 (one ulp is 2^-8 relative) and
  the GeLU gate rounds once here, after each of its seven operations in
  ``jax.nn.gelu``: about one bf16 ulp on the block's output (0.35% of the
  largest magnitude on the CPU).  The gates run in f32 in both packages,
  from the same bf16 inputs, so the f32 tolerance applies to them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402

ARCH = "recurrentgemma-9b"
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1e-2
DECAYS = {"mild": 0.4, "steep": 8.0}


def configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def block_params(dtype="float32"):
    cfg, jcfg = configs(dtype)
    with jax.threefry_partitionable(False):
        jp = jax.tree.map(np.asarray, JR.rglru_init(jax.random.key(0), jcfg))
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def scan_inputs(S, decay, seed=0, width=16):
    rng = np.random.default_rng(seed)
    log_a = (-np.abs(rng.normal(size=(2, S, width))) * decay).astype(
        np.float32)
    b = rng.normal(size=(2, S, width)).astype(np.float32)
    return log_a, b


def sequential(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t, one position at a time."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def compare(mine, ref, dtype):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, **F32_TOL)
    else:
        np.testing.assert_allclose(mine, ref, rtol=0,
                                   atol=BF16_REL * float(np.abs(ref).max()))


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("S", [1, 12, 257])
def test_linear_scan_matches_jax_and_the_recurrence(S, decay):
    la, b = scan_inputs(S, DECAYS[decay])
    h = R._linear_scan(torch.from_numpy(la), torch.from_numpy(b))
    assert h.shape == b.shape and h.dtype == torch.float32
    np.testing.assert_allclose(
        h.numpy(), np.asarray(JR._linear_scan(jnp.asarray(la),
                                              jnp.asarray(b))), **SCAN_TOL)
    ref = sequential(torch.from_numpy(la).double(),
                     torch.from_numpy(b).double())
    np.testing.assert_allclose(h.numpy(), ref.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("decay", sorted(DECAYS))
def test_scan_gradient_matches_float64_autograd(decay):
    la, b = scan_inputs(100, DECAYS[decay], seed=1)
    cot = torch.from_numpy(np.random.default_rng(2).normal(
        size=b.shape).astype(np.float32))
    grads = []
    for fn, dt in ((R._linear_scan, torch.float32),
                   (sequential, torch.float64)):
        x = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in (la, b)]
        (fn(*x) * cot.to(dt)).sum().backward()
        grads.append([t.grad for t in x])
    for mine, ref in zip(*grads):
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_block_and_decode_match_jax(dtype):
    """``_gates`` on the same (bf16 or f32) input, ``rglru_block`` over 20
    positions, and 20 ``rglru_decode`` steps from an empty cache (output at
    every step, the state and conv window at the end)."""
    cfg, jcfg, p, jp = block_params(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    u = np.random.default_rng(3).normal(size=(2, 20, cfg.d_model)).astype(
        np.float32)
    ju, tu = jnp.asarray(u, jdt), torch.from_numpy(u).to(tdt)
    for mine, ref in zip(R._gates(p, tu @ p["in_x"]["w"]),
                         JR._gates(jp, ju @ jp["in_x"]["w"])):
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32_TOL)
    out = R.rglru_block(p, tu, cfg)
    assert out.dtype == tdt and out.shape == tu.shape
    compare(out, JR.rglru_block(jp, ju, jcfg), dtype)
    c = R.rglru_init_cache(cfg, 2, tdt)
    jc = JR.rglru_init_cache(jcfg, 2, jdt)
    for t in range(20):
        o, c = R.rglru_decode(p, tu[:, t:t + 1], c, cfg)
        jo, jc = JR.rglru_decode(jp, ju[:, t:t + 1], jc, jcfg)
        compare(o, jo, dtype)
    assert c.h.dtype == torch.float32 and c.conv.dtype == tdt
    compare(c.h, jc.h, dtype)
    compare(c.conv, jc.conv, dtype)


def test_decode_leaves_its_cache_as_it_was():
    cfg, _, p, _ = block_params()
    c = R.rglru_init_cache(cfg, 2, torch.float32)
    u = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, c1 = R.rglru_decode(p, u, c, cfg)
    assert float(c.h.abs().sum()) == float(c.conv.abs().sum()) == 0
    assert float(c1.h.abs().sum()) > 0 and float(c1.conv[:, -1].abs()
                                                 .sum()) > 0


def test_stability_gate():
    """|a_t| < 1 always: the recurrence cannot blow up."""
    cfg, _, p, _ = block_params()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 8, R._d_rnn(cfg))).astype(np.float32) * 10)
    log_a, _ = R._gates(p, x)
    assert float(log_a.max()) <= 0.0


def test_lambda_stays_f32_in_a_bf16_tree():
    """The port's own draw and the JAX tree: bf16 leaves beside an f32
    ``lambda``, same shapes; the drawn lambda gives a in [0.9, 0.999] at
    r = 1 (Griffin's appendix)."""
    cfg, jcfg = configs("bfloat16")
    mine = R.rglru_init(torch.Generator().manual_seed(0), cfg, (3,))
    ref = jax.eval_shape(lambda k: JR.rglru_init(k, jcfg),
                         jax.random.key(0))
    assert mine["lambda"].dtype == torch.float32
    assert str(ref["lambda"].dtype) == "float32"
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = mine
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == (3,) + tuple(leaf.shape)
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype)
    assert len(flat_ref) == 8
    a = torch.exp(-R._C * R.L.softplus(mine["lambda"]))
    assert float(a.min()) >= 0.9 * (1 - 1e-6)
    assert float(a.max()) <= 0.999 * (1 + 1e-6)
