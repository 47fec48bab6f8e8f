"""The port's analytic FLOP and byte accounting (repro_torch.utils.flops)
and its registry's input_specs against the JAX package's, on the ten
full-size configs; and the full-size parameter tree on the meta device.

* ``param_counts``, ``analytic`` for all three kinds and ``hbm_bytes``
  equal ``repro.utils.flops``'s on every (arch x shape) pair, rtol 1e-12:
  the same formulas on the same integers (the parameter counts come from
  the port's meta-device tree, the JAX ones from ``jax.eval_shape``).
* ``input_specs``: the same inputs, meta tensors against
  ``jax.ShapeDtypeStruct``, by shape and dtype.
* A full-size ``init_params(..., device="meta")`` of every architecture
  (nemotron-4-15b's 1.57 B-element and kimi-k2's 1.17 B-element embedding
  tables among them) finishes within INIT_SECONDS and counts the JAX
  package's parameters."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JREG  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.utils import flops as JFL  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.models import transformer as TM  # noqa: E402
from repro_torch.utils import flops as FL  # noqa: E402

RTOL = 1e-12
#: a full-size meta init of any architecture; it took 0.00-0.01 s on the
#: CPU after a first call (which loads torch's meta kernels once, ~1.5 s),
#: and did not finish in 100 s for nemotron-4-15b or kimi-k2 when leaves
#: past 2^30 elements were drawn a row at a time
INIT_SECONDS = 5.0
DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def jax_counts(monkeypatch):
    """The JAX package's param_counts, computed once per config (each call
    traces ``init_params`` under ``jax.eval_shape``)."""
    cache = {}
    real = JFL.param_counts

    def counts(cfg):
        if cfg.arch_id not in cache:
            cache[cfg.arch_id] = real(cfg)
        return cache[cfg.arch_id]
    monkeypatch.setattr(JFL, "param_counts", counts)
    return counts


def _close(mine: dict, ref: dict):
    assert set(mine) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(mine[k], v, rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_full_size_meta_init_is_quick_and_counts_the_jax_parameters(
        arch, jax_counts):
    TM.init_params(torch.Generator(), REG.get_smoke_config(arch),
                   device="meta")           # torch's meta kernels, once
    t0 = time.perf_counter()
    tree = TM.init_params(torch.Generator(), REG.get_config(arch),
                          device="meta")
    seconds = time.perf_counter() - t0
    assert seconds < INIT_SECONDS, seconds
    assert all(t.device.type == "meta" for t in TR.leaves(tree))
    assert sum(t.numel() for t in TR.leaves(tree)) == \
        jax_counts(JREG.get_config(arch))["total"]
    _close(FL.param_counts(REG.get_config(arch)),
           jax_counts(JREG.get_config(arch)))


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_analytic_and_hbm_bytes_equal_the_jax_package(arch, jax_counts):
    cfg, jcfg = REG.get_config(arch), JREG.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = JSHAPES[name]
        window = REG.decode_window(cfg, shape) or 0
        assert window == (JREG.decode_window(jcfg, jshape) or 0)
        for kind in ("train", "prefill", "decode"):
            for remat in (True, False):
                _close(FL.analytic(cfg, shape, kind, window, remat),
                       JFL.analytic(jcfg, jshape, kind, window, remat))
            for n_agents, K in ((1, 8), (2, 4)):
                mine = FL.hbm_bytes(cfg, shape, kind, n_agents, K, window)
                ref = JFL.hbm_bytes(jcfg, jshape, kind, n_agents, K, window)
                np.testing.assert_allclose(mine, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_input_specs_match_the_jax_package(arch):
    cfg, jcfg = REG.get_config(arch), JREG.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for n_agents in (1, 2):
            mine = REG.input_specs(cfg, shape, n_agents)
            ref = JREG.input_specs(jcfg, JSHAPES[name], n_agents)
            assert list(mine) == list(ref)
            for k, t in mine.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == ref[k].shape, (name, k)
                assert DTYPES[t.dtype] == ref[k].dtype, (name, k)


def test_input_specs_refuse_a_batch_the_agents_do_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        REG.input_specs(REG.get_config("h2o-danube-1.8b"),
                        INPUT_SHAPES["train_4k"], 3)
