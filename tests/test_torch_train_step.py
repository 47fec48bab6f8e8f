"""The port's agent-stacked FrODO step (training/train_step.py) against the
JAX package's, from the same JAX initial weights and the same token batches
(h2o-danube-1.8b smoke config at f32, 2 agents, seq 16): 3 steps in each
memory mode, clip on, collect_metrics on.  Every scalar metric, the
per-agent losses and the final parameters agree within rtol 1e-4 / atol
1e-5 (f32 on both sides; XLA and PyTorch sum in other orders, ~1e-6
relative per step).  The port runs its update both plainly and through
``kernels.ops`` (whose CPU path is the kernels' plain version).

``run_both`` and ``check`` are shared with test_torch_train_step_faults.py.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.core.faults import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.data.synthetic import TokenPipeline  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.faults import FaultSchedule  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "h2o-danube-1.8b"
TOL = dict(rtol=1e-4, atol=1e-5)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def batches(cfg, agents, n, seq=16, bpa=2, seed=0):
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, batch_per_agent=bpa,
                         n_agents=agents, seed=seed)
    return [next(pipe) for _ in range(n)]


def run_both(tc_kw, agents=2, steps=3, n_pods=1, use_kernel=(False,)):
    cfg = REG.get_smoke_config(ARCH).replace(**F32)
    jcfg = JREG.get_smoke_config(ARCH).replace(**F32)
    jkw = dict(tc_kw)
    if "fault_schedule" in jkw:
        jkw["fault_schedule"] = JFaultSchedule(**jkw["fault_schedule"])
    jtc = JTS.TrainConfig(**jkw)
    jstate = JTS.init_train_state(jax.random.key(0), jcfg, jtc, agents)
    init = jax.tree.map(np.asarray, jstate.params)
    data = batches(cfg, agents, steps)
    jstep = jax.jit(JTS.make_train_step(jcfg, jtc, agents, n_pods))
    ref = []
    for b in data:
        jstate, m = jstep(jstate, b)
        ref.append(jax.tree.map(np.asarray, m))
    jparams = jax.tree.map(np.asarray, jstate.params)
    out = {}
    for uk in use_kernel:
        kw = dict(tc_kw, use_kernel=uk)
        if "fault_schedule" in kw:
            kw["fault_schedule"] = FaultSchedule(**kw["fault_schedule"])
        tc = TS.TrainConfig(**kw)
        state = TS.train_state_from_params(params_from_numpy(init, "cpu"),
                                           tc)
        step = TS.make_train_step(cfg, tc, agents, n_pods)
        mets = []
        for b in data:
            state, m = step(state, b)
            mets.append(m)
        out[uk] = (mets, state)
    return ref, jparams, out


def check(ref, jparams, mets, state):
    assert state.step == len(ref)
    for r, m in zip(ref, mets):
        assert set(m) == set(r), (set(m) ^ set(r))
        for k in r:
            np.testing.assert_allclose(np.asarray(m[k], np.float64),
                                       np.asarray(r[k], np.float64), **TOL,
                                       err_msg=k)
    jflat = jax.tree.leaves(jparams)
    flat = TR.leaves(state.params)
    assert len(flat) == len(jflat)
    for a, b in zip(flat, jflat):
        assert a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("mode", ["exact", "expsum"])
def test_three_steps_match_jax(mode):
    tc_kw = dict(memory_mode=mode, T=8, K=4, grad_clip=1.0, remat=False,
                 collect_metrics=True, ce_chunks=4)
    ref, jparams, out = run_both(tc_kw, use_kernel=(False, True))
    assert {"memory_norm", "update_norm", "consensus_error",
            "consensus_error_pre_mix", "param_norm"} <= set(ref[0])
    for uk, (mets, state) in out.items():
        check(ref, jparams, mets, state)
        # memory starts empty, then fills
        assert float(mets[0]["memory_norm"]) == 0.0
        assert float(mets[-1]["memory_norm"]) > 0.0
