"""The port's dense transformer (models/transformer.py) and its loss
(training/train_step.make_loss_fn) against the JAX package's, from the JAX
package's initial weights carried across with convert.params_from_numpy:
forward_features, the logits, and the loss, metrics and gradients of one
agent, on h2o-danube-1.8b's smoke config (2 layers, d 256).

Tolerances: f32 rtol 1e-4 / atol 1e-5 (two layers of f32 products summed
in another order by XLA and PyTorch, ~1e-6 relative, grown by the
backward); bf16 rtol 2e-2 with an absolute floor of 2e-2 of the leaf's
largest magnitude (bf16 keeps ~3 digits, and the two frameworks round at
different places: a value near 0 in a leaf carries its neighbours' absolute
error)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "h2o-danube-1.8b"
F32 = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 32


def configs(dtype, **kw):
    kw.update(param_dtype=dtype, compute_dtype=dtype)
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def compare(mine, ref, dtype):
    mine = mine.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, **F32)
    else:
        np.testing.assert_allclose(mine, ref, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(ref).max()))


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed), cfg))


def test_init_tree_matches_the_jax_tree():
    cfg, jcfg = configs("bfloat16")
    jp = jax.eval_shape(lambda k: JTS.init_train_state(
        k, jcfg, JTS.TrainConfig(), 2).params, jax.random.key(0))
    mine = TS.init_train_state(torch.Generator().manual_seed(0), cfg,
                               TS.TrainConfig(), 2).params
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        TR.tree_map(lambda a: (tuple(a.shape), "bfloat16"), mine)
    assert all(a.dtype == torch.bfloat16 for a in TR.leaves(mine))
    assert len(TR.leaves(mine)) == 12
    # the agents start at distinct states
    assert not torch.equal(mine["blocks"]["mlp"]["up"]["w"][0],
                           mine["blocks"]["mlp"]["up"]["w"][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    cfg, jcfg = configs(dtype)
    jp = jax_params(jcfg)
    b = batch(cfg)
    p = params_from_numpy(jp, "cpu")
    tb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    x, aux = T.forward_features(p, tb, cfg)
    jx, jaux = JT.forward_features(jax.tree.map(jnp.asarray, jp),
                                   {"tokens": jnp.asarray(b["tokens"])}, jcfg)
    assert x.dtype == T.L.dtype_of(dtype) and float(aux) == float(jaux) == 0
    compare(x, jx, dtype)
    logits, _ = T.forward(p, tb, cfg)
    jl, _ = JT.forward(jax.tree.map(jnp.asarray, jp),
                       {"tokens": jnp.asarray(b["tokens"])}, jcfg)
    assert logits.dtype == torch.float32
    compare(logits, jl, dtype)


@pytest.mark.parametrize("dtype,remat,blockwise", [
    ("float32", False, False), ("float32", True, True),
    ("bfloat16", False, False), ("float32", "dots", False)])
def test_loss_and_grads_match_jax(dtype, remat, blockwise):
    """make_loss_fn's value, metrics and gradient for one agent; the
    blockwise case sets attn_direct_max below the sequence."""
    kw = dict(attn_direct_max=16, attn_chunk=16) if blockwise else {}
    cfg, jcfg = configs(dtype, **kw)
    tc = TS.TrainConfig(remat=remat, ce_chunks=4)
    jtc = JTS.TrainConfig(remat=remat, ce_chunks=4)
    jp = jax_params(jcfg, seed=1)
    b = batch(cfg, seed=1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        JTS.make_loss_fn(jcfg, jtc), has_aux=True))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in b.items()})
    p = params_from_numpy(jp, "cpu")
    flat, treedef = TR.flatten(p)
    req = [a.detach().requires_grad_(True) for a in flat]
    loss, met = TS.make_loss_fn(cfg, tc)(
        TR.unflatten(treedef, req),
        {k: torch.from_numpy(v.copy()) for k, v in b.items()})
    grads = torch.autograd.grad(loss, req)
    compare(loss, jl, dtype)
    for k in ("ce", "accuracy"):
        compare(met[k], jmet[k], dtype)
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(grads) == 12
    for g, jgl in zip(grads, jflat):
        assert g.dtype == T.L.dtype_of(dtype)
        compare(g, jgl, dtype)


def test_other_families_raise_not_implemented():
    for arch in ("mamba2-780m", "qwen3-moe-30b-a3b", "minicpm3-4b"):
        cfg = REG.get_smoke_config(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.init_params(torch.Generator(), cfg)
