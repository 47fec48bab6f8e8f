"""More of the port's train step against the JAX package's (see
test_torch_train_step.py for the set-up and the tolerance): a
fault-schedule step (stragglers and link drops) and a hierarchical step (4
agents in 2 pods), rtol 1e-4 / atol 1e-5; microbatches 2 against 1 in the
port (tests/test_archs_smoke.py's check, its rtol 2e-4 / atol 2e-5); and
one bf16 step through the kernel ops: contiguous bf16 grads per leaf and
agents equal after complete-graph mixing."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_train_step import (ARCH, F32, batches, check,  # noqa: E402
                                   run_both)
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402


def test_fault_step_matches_jax():
    tc_kw = dict(memory_mode="exact", T=4, remat=False, collect_metrics=True,
                 ce_chunks=2, fault_horizon=4,
                 fault_schedule=dict(link_drop=0.5, straggler_frac=0.5,
                                     seed=3))
    ref, jparams, out = run_both(tc_kw, agents=2, steps=2)
    mets, state = out[False]
    assert any(k.startswith("faults_") for k in ref[0])
    check(ref, jparams, mets, state)


def test_hierarchical_step_matches_jax():
    tc_kw = dict(memory_mode="expsum", T=8, K=4, remat=False,
                 topology="hierarchical", weights="metropolis",
                 cross_pod_period=2, ce_chunks=2, collect_metrics=True)
    ref, jparams, out = run_both(tc_kw, agents=4, steps=2, n_pods=2)
    check(ref, jparams, *out[False])


def test_microbatching_matches_full_batch():
    """mb=2 gradient accumulation == single big batch (same data)."""
    cfg = REG.get_smoke_config(ARCH).replace(**F32)
    gen = torch.Generator().manual_seed(0)
    b = batches(cfg, 1, 1, seq=32, bpa=4)[0]
    outs = []
    for mb in (1, 2):
        tc = TS.TrainConfig(T=4, memory_mode="exact", remat=False,
                            grad_clip=0, microbatches=mb)
        state = TS.init_train_state(gen.manual_seed(0), cfg, tc, 1)
        new, m = TS.make_train_step(cfg, tc, 1)(state, b)
        outs.append((new, m))
    (s1, m1), (s2, m2) = outs
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-4)
    for a, c in zip(TR.leaves(s1.params), TR.leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_consensus_equalizes_agents_and_grads_are_contiguous():
    """Complete graph with Xiao-Boyd weights: one step leaves every agent
    with the same parameters (the mean shortcut), and the optimizer saw one
    contiguous (A, ...) gradient per leaf."""
    cfg = REG.get_smoke_config(ARCH)                     # bf16
    tc = TS.TrainConfig(T=4, memory_mode="exact", remat=False,
                        use_kernel=True)
    state = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, 4)
    seen = []
    from repro_torch.kernels import ops
    orig = ops.frodo_update

    def spy(g, hist, *a, **k):
        seen.append((g.is_contiguous(), g.dtype, hist.dtype))
        return orig(g, hist, *a, **k)

    ops.frodo_update = spy
    try:
        state2, _ = TS.make_train_step(cfg, tc, 4)(
            state, batches(cfg, 4, 1)[0])
    finally:
        ops.frodo_update = orig
    assert seen == [(True, torch.bfloat16, torch.bfloat16)] * 12
    for leaf in TR.leaves(state2.params):
        assert torch.equal(leaf, leaf[:1].expand_as(leaf))
