"""The port's optim package (schedules and transform chains over
``core.frodo``) against the JAX package's ``repro.optim``.

Tolerances: the schedules rtol 1e-6 (the same f32 formulas; a cosine of
f32 arguments may differ by an ulp between libraries); the transforms'
updates rtol 1e-6 / atol 1e-7 (elementwise f32 arithmetic in the same
order)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as JO  # noqa: E402
from repro.configs import registry as JREG  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core.frodo import FrodoConfig as JFrodoConfig  # noqa: E402
from repro.core.frodo import frodo as jax_frodo  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.core import baselines as B  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

# the module (``repro_torch.core.frodo`` is the function, as in the JAX
# package's ``repro.core``)
F = importlib.import_module("repro_torch.core.frodo")

WARMUP, TOTAL = 10, 50
STEPS = [0, 1, WARMUP - 1, WARMUP, TOTAL, TOTAL + 5]
SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "linear_warmup": lambda m: m.linear_warmup(WARMUP, base=0.5),
    "cosine_decay": lambda m: m.cosine_decay(TOTAL, base=0.8, floor=0.1),
    "warmup_cosine": lambda m: m.warmup_cosine(WARMUP, TOTAL, base=1.0,
                                               floor=0.1),
}
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """At an int step and at a tensor step: a float32 multiplier equal to
    the JAX package's."""
    mine, ref = SCHEDULES[name](O), SCHEDULES[name](JO)
    for s in STEPS:
        want = np.float32(ref(s))
        for step in (s, torch.tensor(s)):
            got = mine(step)
            assert isinstance(got, torch.Tensor) and \
                got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6)


def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"blocks": {"mlp": {"up": {"w": rng.normal(size=(3, 4))}},
                       "ln1": {"scale": rng.normal(size=4)}},
            "mix": {"lambda": rng.normal(size=4),
                    "conv": {"b": rng.normal(size=4),
                             "w": rng.normal(size=(2, 4))}},
            "embed": {"table": rng.normal(size=(5, 4))}}


def both(tree):
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return (TR.tree_map(lambda a: torch.from_numpy(a.copy()), f32),
            jax.tree.map(jnp.asarray, f32))


def run(opt, p, g, steps=1):
    state = opt.init(p)
    out = []
    for _ in range(steps):
        delta, state = opt.update(g, state, p)
        out.append(delta)
    return out


def assert_trees_close(mine, ref):
    flat = TR.leaves(mine)
    jflat = jax.tree.leaves(ref)
    assert len(flat) == len(jflat)
    for a, b in zip(flat, jflat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_weight_decay_one_step_matches_jax():
    """A FrODO exp-sum step with decoupled decay on the decay mask's
    leaves: the matmul weights and the embedding decay; the norm scale,
    the bias and lambda do not."""
    (p, jp), (g, jg) = both(small_tree(0)), both(small_tree(1))
    fc = dict(alpha=0.1, beta=0.05, lam=0.15, T=8, memory_mode="expsum",
              K=4)
    mine = run(O.add_decoupled_weight_decay(F.frodo(F.FrodoConfig(**fc)),
                                            0.05, O.default_decay_mask),
               p, g)[0]
    ref = run(JO.add_decoupled_weight_decay(jax_frodo(JFrodoConfig(**fc)),
                                            0.05, JO.default_decay_mask),
              jp, jg)[0]
    assert_trees_close(mine, ref)
    plain = run(F.frodo(F.FrodoConfig(**fc)), p, g)[0]
    assert torch.equal(mine["blocks"]["ln1"]["scale"],
                       plain["blocks"]["ln1"]["scale"])
    assert not torch.equal(mine["blocks"]["mlp"]["up"]["w"],
                           plain["blocks"]["mlp"]["up"]["w"])


def test_weight_decay_needs_params():
    opt = O.add_decoupled_weight_decay(B.no_memory(0.1), 0.1)
    p, _ = both(small_tree())
    with pytest.raises(ValueError, match="params"):
        opt.update(p, opt.init(p))


def test_chain_order_matches_jax():
    """chain = the schedule over the decayed update: three steps of
    no_memory through chain, against the JAX chain and against the two
    transforms composed by hand in that order (and not the other)."""
    (p, jp), (g, jg) = both(small_tree(0)), both(small_tree(1))
    sched = (O.warmup_cosine(2, 6, floor=0.2), JO.warmup_cosine(2, 6,
                                                                floor=0.2))
    mine = run(O.chain(B.no_memory(0.1), schedule=sched[0],
                       weight_decay=0.05), p, g, 3)
    ref = run(JO.chain(JB.no_memory(0.1), schedule=sched[1],
                       weight_decay=0.05), jp, jg, 3)
    for a, b in zip(mine, ref):
        assert_trees_close(a, b)
    by_hand = run(O.scale_by_schedule(O.add_decoupled_weight_decay(
        B.no_memory(0.1), 0.05, O.default_decay_mask), sched[0]), p, g, 3)
    for a, b in zip(mine, by_hand):
        assert all(torch.equal(x, y) for x, y in zip(TR.leaves(a),
                                                     TR.leaves(b)))
    # decay outside the schedule would decay at the full rate at step 0
    other = run(O.add_decoupled_weight_decay(O.scale_by_schedule(
        B.no_memory(0.1), sched[0]), 0.05, O.default_decay_mask), p, g)[0]
    assert not torch.equal(other["embed"]["table"],
                           mine[0]["embed"]["table"])
    assert run(O.chain(B.no_memory(0.1)), p, g)[0]["embed"]["table"] \
        .equal(run(B.no_memory(0.1), p, g)[0]["embed"]["table"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-780m",
                                  "h2o-danube-1.8b"])
def test_default_decay_mask_on_the_smoke_model_paths(arch):
    """The port's key path of every leaf is the JAX package's
    (``jax.tree_util.keystr``), so the mask picks the same leaves; norms,
    lambda and mamba2's A_log/D/dt_bias stay undecayed."""
    from repro_torch.optim.transforms import _paths
    mine = _paths(T.init_params(torch.Generator(),
                                REG.get_smoke_config(arch), device="meta"))
    ref = jax.eval_shape(lambda k: JT.init_params(
        k, JREG.get_smoke_config(arch)), jax.random.key(0))
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert mine == jpaths
    mask = [O.default_decay_mask(p) for p in mine]
    assert mask == [JO.default_decay_mask(p) for p in jpaths]
    assert any(mask) and not all(mask)
    for p, m in zip(mine, mask):
        if any(t in p for t in ("scale", "lambda", "A_log", "dt_bias")):
            assert not m, p
