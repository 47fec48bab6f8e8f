"""The hybrid family (recurrentgemma-9b: groups of two RG-LRU sub-layers and
one local-attention sub-layer, each with a gated MLP, and a tail of
``n_layers % 3`` rec sub-layers) against the JAX package: the parameter
tree (paths, shapes, dtypes; at smoke widths and at full width), the
forward in f32 with and without remat, and two FrODO exp-sum train steps
of 2 agents, from the JAX initial weights (drawn under
``jax.threefry_partitionable(False)``) carried across with
convert.params_from_numpy.

Tolerances: the forward rtol 1e-5 / atol 1e-5 on logits of magnitude ~1
(five layers of f32 products summed in another order, and the log-depth
scan against XLA's associative scan, ~1e-6); the gradient of the logits'
sum rtol 1e-4 with an absolute floor of 1e-4 of each leaf's largest
element (sums over 96 positions x 512 logits that cancel: the embedding's
elements reach ~90 and differ by ~1e-5 of that); the train steps
test_torch_train_step.py's rtol 1e-4 / atol 1e-5 (the backward and two
updates grow the difference)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check  # noqa: E402

from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import synthetic as SYN  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "recurrentgemma-9b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4


def configs(**kw):
    return (REG.get_smoke_config(ARCH).replace(**kw),
            JREG.get_smoke_config(ARCH).replace(**kw))


def jax_params(jcfg, seed=0):
    with jax.threefry_partitionable(False):
        return jax.tree.map(np.asarray,
                            JT.init_params(jax.random.key(seed), jcfg))


def described(tree):
    """{key path: (shape, dtype)} of a JAX tree or the port's."""
    if isinstance(TR.leaves(tree)[0], torch.Tensor):
        tree = TR.tree_map(lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), str(t.dtype).replace("torch.", "")), tree)
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("n_layers", [5, 3, 4, 2])
def test_init_tree_matches_the_jax_tree(n_layers):
    """Paths, shapes and dtypes (bf16 leaves, each RG-LRU's f32 lambda):
    5 layers are one group and a 2-layer tail, 3 one group, 4 one group
    and a 1-layer tail, 2 no group (a zero-length stack) and the tail."""
    cfg, jcfg = configs(n_layers=n_layers)
    ref = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                         jax.random.key(0))
    mine = T.init_params(torch.Generator().manual_seed(0), cfg)
    assert described(mine) == described(ref)
    n_groups, tail = divmod(n_layers, 3)
    assert mine["groups"]["rec1"]["mix"]["lambda"].shape[0] == n_groups
    assert ("tail_blocks" in mine) == bool(tail)
    assert mine["groups"]["attn"]["mix"]["wq"]["w"].dtype == torch.bfloat16
    assert mine["groups"]["rec2"]["mix"]["lambda"].dtype == torch.float32


def test_full_width_tree_on_the_meta_device():
    """recurrentgemma-9b at full width and depth (38 layers: 12 groups and
    a 2-layer rec tail), agent-stacked, against jax.eval_shape."""
    cfg = REG.get_config(ARCH)
    jcfg = JREG.get_config(ARCH)
    mine = T.init_params(torch.Generator(), cfg, (2,), device="meta")
    ref = jax.eval_shape(lambda k: jax.vmap(
        lambda kk: JT.init_params(kk, jcfg))(jax.random.split(k, 2)),
        jax.random.key(0))
    assert described(mine) == described(ref)
    assert mine["groups"]["attn"]["mlp"]["up"]["w"].shape == (
        2, 12, 4096, 12288)
    assert mine["tail_blocks"]["mix"]["rg_wa"]["w"].shape == (2, 2, 4096,
                                                              4096)
    n = sum(t.numel() for t in TR.leaves(mine)) // 2
    assert 9.3e9 < n < 9.5e9


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = configs(**F32)
    jp = jax_params(jcfg)
    return cfg, jcfg, params_from_numpy(jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_jax(model, remat):
    """Logits over 48 positions (past the smoke local window of 32, so the
    window masks), and the gradient of their sum with remat on and off."""
    cfg, jcfg, p, jp = model
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 48))
    flat, treedef = TR.flatten(p)
    req = [a.detach().requires_grad_(True) for a in flat]
    logits, aux = T.forward(TR.unflatten(treedef, req),
                            {"tokens": torch.from_numpy(toks)}, cfg,
                            remat=remat)
    grads = torch.autograd.grad(logits.sum(), req)
    jl, _ =JT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, remat=remat)
    assert logits.shape == (2, 48, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               **FWD_TOL)
    jg = jax.grad(lambda q: JT.forward(q, {"tokens": jnp.asarray(toks)},
                                       jcfg, remat=remat)[0].sum())(jp)
    for g, jgl in zip(grads, jax.tree.leaves(jg)):
        jgl = np.asarray(jgl)
        np.testing.assert_allclose(g.numpy(), jgl, rtol=GRAD_REL,
                                   atol=GRAD_REL * float(np.abs(jgl).max()))
    # the local window masks: a window as long as the sequence differs
    wide = cfg.replace(hybrid=dataclasses.replace(cfg.hybrid,
                                                  local_window=48))
    full, _ = T.forward(p, {"tokens": torch.from_numpy(toks)}, wide)
    assert torch.equal(full[:, :32], logits[:, :32])
    assert not torch.allclose(full[:, 32:], logits[:, 32:], **FWD_TOL)


def test_two_expsum_steps_match_jax():
    """Two FrODO exp-sum steps of 2 agents: every metric, the per-agent
    losses and the final parameters (the f32 lambdas included)."""
    cfg, jcfg = configs(**F32)
    tc_kw = dict(memory_mode="expsum", T=8, K=4, grad_clip=1.0, remat=False,
                 collect_metrics=True, ce_chunks=4)
    jtc = JTS.TrainConfig(**tc_kw)
    with jax.threefry_partitionable(False):
        jstate = JTS.init_train_state(jax.random.key(0), jcfg, jtc, 2)
    init = jax.tree.map(np.asarray, jstate.params)
    pipe = SYN.TokenPipeline(vocab=cfg.vocab, seq_len=32, batch_per_agent=2,
                             n_agents=2, seed=0)
    data = [next(pipe) for _ in range(2)]
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
    assert state.params["groups"]["rec1"]["mix"]["lambda"].dtype == \
        torch.float32
