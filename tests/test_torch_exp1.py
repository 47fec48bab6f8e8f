"""The port's Exp 1 script (repro_torch.experiments.exp1_quadratic) against
the JAX script (benchmarks/exp1_quadratic.py) on the CPU.

* ``run_batch`` iteration counts to 1e-6 (f32 on both sides; the memory
  term and the mixing sum in another order): within 2 iterations for at
  least 90% of the runs, and the mean count within 1%.  The error
  oscillates as it decays; where a trough grazes 1e-6, rounding decides
  whether that trough or the next one, ~100 iterations later, is the first
  hit.  Over the paper's full protocol 27 of the 1,350 runs differ by more
  than 2; of the 36 here, 29 are equal, 6 differ by one and 1 by 129.
* The telemetry trace over 60 steps: rtol 1e-4 / atol 1e-6 (~1e-7 relative
  rounding per step).
* ``-m regression``: the 150-step trace against the committed golden
  baseline benchmarks/baselines/exp1.json, with repro.obs.regress's
  tolerances (rtol 0.05, violation budget 0.02), timing excluded.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import exp1_quadratic as J  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import loop  # noqa: E402
from repro_torch.core.frodo import FrodoConfig, frodo  # noqa: E402
from repro_torch.experiments import exp1_quadratic as E  # noqa: E402
from repro_torch.obs import regress as R  # noqa: E402

POINT = tuple(np.float32(v) for v in (0.8, 0.35, 0.15, 90.0))


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of rounds of tiny ops: one thread is fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_batch_matches_jax():
    alpha, beta, lam, T = J.sample_hparams(4, seed=5)
    cols = [[], [], [], [], []]
    for v in E.VARIANTS:
        for st in ((1.0, 0.0), (0.0, 1.0), (0.6, -0.8)):
            x0s = np.tile(np.asarray(st, np.float32), (4, 1))
            for c, x in zip(cols, (x0s,) + J.variant_params(v, alpha, beta,
                                                            lam, T)):
                c.append(x)
    args = [np.concatenate(c) for c in cols]
    ref = np.asarray(J.run_batch(*args))
    got = E.run_batch(*args, device="cpu")
    assert got.shape == ref.shape == (36,) and got.dtype.kind == "i"
    diff = np.abs(got - ref)
    assert np.mean(diff <= 2) >= 0.9, np.stack([ref, got])
    assert abs(got.mean() - ref.mean()) <= 0.01 * ref.mean()
    assert (got < E.K_MAX).all()


def test_telemetry_trace_matches_jax():
    trace = jax.jit(J._telemetry_trace, static_argnames=("steps",))
    for v in E.VARIANTS:
        p = E.variant_params(v, *POINT)
        ref = trace(jnp.asarray([1.0, 0.0]), *p, steps=60)
        got = E.telemetry_trace((1.0, 0.0), *p, 60, device="cpu")
        assert set(got) == set(ref) == set(E.TELEMETRY)
        for k in got:
            assert got[k].shape == (60,)
            np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_summary_matches_jax_schema(tmp_path):
    ref = J.run_experiment(n_sets=4, n_circle=8, seed=0, out=None)
    got = E.run_experiment(n_sets=4, n_circle=8, seed=0, device="cpu",
                           out=str(tmp_path / "s.json"),
                           metrics_out=str(tmp_path / "m.jsonl"),
                           metrics_steps=5)
    assert got.pop("device") == "cpu"

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}
    assert keys(got) == keys(ref)
    for v in E.VARIANTS:        # iteration means within one iteration
        assert abs(got[v]["circle_mean"] - ref[v]["circle_mean"]) <= 1
    rows = R.load_trajectories(str(tmp_path / "m.jsonl"))
    assert len(rows) == 3 and all(len(r["error"]) == 5 for r in rows.values())


def test_loop_with_the_kernel_tracks_the_inline_point():
    """The representative point through core.loop with FrODO exact memory at
    T = 90 padded to 100 slots (``use_kernel=True``: the kernel's plain
    version here) against the script's inline Algorithm 1: the update is
    rounded in another order (-(a g + b M) added vs a g and b M subtracted)
    and the gradients come from autograd, so rtol 1e-4 / atol 1e-6."""
    K = 200
    inline = E.telemetry_trace((1.0, 0.0), *POINT, K, device="cpu")["error"]
    opt = frodo(FrodoConfig(alpha=0.8, beta=0.35, lam=0.15, T=90, pad_T=100,
                            use_kernel=True))
    res = loop.run(E.objective, torch.tensor([[1.0, 0.0]] * 4), opt,
                   G.xiao_boyd_weights(G.complete(4)), K,
                   x_star=np.zeros(2, np.float32))
    np.testing.assert_allclose(res["errors"], inline, rtol=1e-4, atol=1e-6)


@pytest.mark.regression
def test_port_trace_tracks_golden_baseline(tmp_path):
    path = str(tmp_path / "exp1.jsonl")
    E.write_metrics_jsonl(path, steps=150, device="cpu")
    base = R.load_baseline(os.path.join(ROOT, "benchmarks", "baselines",
                                        "exp1.json"))
    tol = R.Tolerance(rtol=0.05, max_violation_frac=0.02)
    diffs = R.compare_to_baseline(base, path, tol, include_timing=False)
    assert diffs and all(d.passed for d in diffs), R.format_report(diffs)
