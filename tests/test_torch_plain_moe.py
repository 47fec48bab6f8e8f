"""``chip_smoke.py``'s plain MoE reference (``plain_grouped_moe``, which
the card holds ``moe.moe_mlp`` to at kimi-k2-1t-a32b's full width) against
the JAX package's ``repro.models.moe.moe_mlp``, so the card's reference is
itself held to JAX: kimi-k2's smoke MoE layer (4 experts, top 2, a shared
expert) in f32 from the JAX package's initial weights, at a capacity
factor of 0.5 (tokens drop) and at the no-drop capacity.

The two faults the card plants in ``moe.py`` for that check (the shared
expert left out, the tokens routed to expert 0 dropped) fail it here too,
and the decode faults it plants for kimi-k2 move decode off the forward.

Tolerances: the plain version against JAX rtol 1e-5 / atol 1e-6 of the
largest magnitude (``test_torch_moe.py``'s: the same f32 arithmetic
summed in another order); the port against the plain version and the
planted faults, the card's own ``moe_close`` at ``DIST_MOE_TOL``."""
import importlib.util
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIMI = "kimi-k2-1t-a32b"
TOL = dict(rtol=1e-5, atol=1e-6)
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(capacity_factor):
    cfg = REG.get_smoke_config(KIMI).replace(**F32)
    jcfg = JREG.get_smoke_config(KIMI).replace(**F32)
    if capacity_factor is None:
        return M.no_drop(cfg), jcfg.replace(moe=jcfg.moe.__class__(**{
            **jcfg.moe.__dict__,
            "capacity_factor": jcfg.moe.n_experts / jcfg.moe.top_k}))
    return tuple(c.replace(moe=c.moe.__class__(**{
        **c.moe.__dict__, "capacity_factor": capacity_factor}))
        for c in (cfg, jcfg))


def layer_and_inputs(jcfg, shape=(2, 24), seed=0):
    jp = jax.tree.map(np.asarray, JM.moe_init(jax.random.key(seed), jcfg))
    x = np.random.default_rng(seed).normal(
        size=shape + (jcfg.d_model,)).astype(np.float32)
    return jp, params_from_numpy(jp, "cpu"), x


def dropped(p, x, cfg):
    n = x.shape[0] * x.shape[1]
    top_e = M.route(p, x.reshape(n, -1), cfg)[3]
    counts = M._expert_counts(top_e.reshape(-1), cfg.moe.n_experts)
    return int((counts - M._capacity(n, cfg.moe)).clamp(min=0).sum())


@pytest.mark.parametrize("capacity_factor", [0.5, None])
def test_plain_moe_with_its_shared_expert_matches_jax(cs, capacity_factor):
    cfg, jcfg = configs(capacity_factor)
    jp, p, x = layer_and_inputs(jcfg)
    assert "shared" in p
    xt = torch.from_numpy(x)
    n_dropped = dropped(p, xt, cfg)
    assert (n_dropped > 0) == (capacity_factor is not None)
    want, _ = JM.moe_mlp(jp, x, jcfg)
    want = np.asarray(want)
    plain = cs.plain_grouped_moe(p, xt, cfg)
    np.testing.assert_allclose(
        plain.numpy(), want, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))
    # the shared expert is in it: without it the plain version is off
    routed = cs.plain_grouped_moe({k: v for k, v in p.items()
                                   if k != "shared"}, xt, cfg)
    assert float((routed - plain).abs().max()) > 0.1 * float(
        np.abs(want).max())
    # and the port's moe_mlp passes the card's check against it
    got, _ = M.moe_mlp(p, xt, cfg)
    assert cs.moe_close(got, plain)[0]


@pytest.mark.parametrize("capacity_factor", [0.5, None])
@pytest.mark.parametrize("fault", ["moe_shared_expert_left_out",
                                   "moe_tokens_to_expert_0_dropped"])
def test_planted_moe_faults_fail_the_plain_check(cs, fault,
                                                 capacity_factor):
    cfg, jcfg = configs(capacity_factor)
    _, p, x = layer_and_inputs(jcfg)
    xt = torch.from_numpy(x)
    plain = cs.plain_grouped_moe(p, xt, cfg)
    bad_moe = cs.planted_module(M, *cs.MOE_BLOCK_PLANTED[fault])
    bad, _ = bad_moe.moe_mlp(p, xt, cfg)
    assert not cs.moe_close(bad, plain)[0]


@pytest.mark.parametrize("fault", ["moe_shared_expert_left_out",
                                   "moe_top_w_not_renormalised"])
def test_planted_decode_faults_move_decode_off_the_forward(cs, fault):
    """kimi-k2's decode faults (in decode's copy of moe only, so the
    forward keeps the real layer) on the smoke config at 2 layers, f32."""
    mod, run, old, new = cs.DVF_PLANTED[fault]
    assert (mod, run) == ("MOE", KIMI)
    cfg = REG.get_smoke_config(KIMI).replace(n_layers=2, **F32)
    p = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 16)))
    fwd, _ = T.forward(p, {"tokens": toks}, M.no_drop(cfg))

    def gap():
        dec, _ = D.prefill_cache(p, D.init_cache(cfg, 2, 16), toks, 0, cfg,
                                 all_logits=True)
        return float((dec - fwd).abs().max())

    assert gap() < 1e-4
    D.MOE = cs.planted_module(M, old, new)
    try:
        assert gap() > 1e-2
    finally:
        D.MOE = M
