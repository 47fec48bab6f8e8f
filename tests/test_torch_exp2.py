"""The port's Exp 2 trainer (repro_torch.experiments.exp2_federated) against
the JAX script (benchmarks/exp2_federated.py), from the same JAX initial
weights exported to numpy, on the same data and batch order.

* A narrow MLP (784-64-32-10), every method, 6 steps: per-step loss, acc and
  telemetry within rtol 1e-4 / atol 1e-5 (f32 on both sides; XLA and
  PyTorch order the matmul sums differently, ~1e-6 relative after 6 steps).
* ``-m regression``: the full-width port (784-1024-128-10, 40 steps, seed 0)
  against the committed golden baseline benchmarks/baselines/exp2.json with
  repro.obs.regress's tolerances (rtol 0.05, violation budget 0.02)."""
import json
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

from benchmarks import exp2_federated as J  # noqa: E402
from repro.core import consensus as jc  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core.frodo import apply_updates as japply  # noqa: E402
from repro.data.synthetic import make_classification as jdata  # noqa: E402
from repro.obs import regress as R  # noqa: E402
from repro_torch.experiments import exp2_federated as E  # noqa: E402

NARROW = (784, 64, 32, 10)
TEL = ("consensus_error", "consensus_error_pre_mix", "grad_norm",
       "memory_norm")
TOL = dict(rtol=1e-4, atol=1e-5)


def jax_init(seed, sizes):
    """The JAX script's init_mlp draw (agent-stacked) at any widths."""
    def one(key):
        params = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            k1, key = jax.random.split(key)
            params[f"w{i}"] = jax.random.normal(k1, (a, b)) * np.sqrt(2.0 / a)
            params[f"b{i}"] = jnp.zeros((b,))
        return params
    keys = jax.random.split(jax.random.key(seed), J.N_AGENTS)
    return jax.tree.map(np.asarray, jax.vmap(one)(keys))


def jax_train(name, params, X, y, idx, W):
    """benchmarks/exp2_federated.py's step_fn, unrolled in Python."""
    opt = J.make_optimizer(name, telemetry=True)
    state = opt.init(params)
    per_agent = jax.vmap(jax.value_and_grad(J.mlp_loss, has_aux=True))

    @jax.jit
    def step(params, state, bi):
        xb = jnp.take_along_axis(X, bi[..., None], axis=1)
        yb = jnp.take_along_axis(y, bi, axis=1)
        (loss, acc), grads = per_agent(params, xb, yb)
        delta, state = opt.update(grads, state, params)
        params = japply(params, delta)
        params, caux = jc.mix_stacked(params, W, with_metrics=True)
        rec = {"loss": jnp.mean(loss), "acc": jnp.mean(acc),
               "consensus_error": caux["consensus_error_post"],
               "consensus_error_pre_mix": caux["consensus_error_pre"],
               "grad_norm": J.obs.global_norm(grads),
               "memory_norm": (state["metrics"]["memory_norm"]
                               if "metrics" in state else jnp.float32(0))}
        return params, state, rec

    out = {k: [] for k in ("loss", "acc") + TEL}
    for bi in idx:
        params, state, rec = step(params, state, bi)
        for k, v in rec.items():
            out[k].append(v)
    return {k: np.asarray(v, np.float64) for k, v in out.items()}, params


@pytest.mark.parametrize("method", E.METHODS)
def test_narrow_exp2_matches_jax_step_by_step(method):
    steps = 6
    X, y = jdata(n_per_class=20, n_agents=J.N_AGENTS, seed=0, noise=2.0)
    Xp, yp = E.make_classification(n_per_class=20, n_agents=E.N_AGENTS,
                                   seed=0, noise=2.0)
    np.testing.assert_array_equal(X, Xp)
    np.testing.assert_array_equal(y, yp)
    W = jg.xiao_boyd_weights(jg.complete(J.N_AGENTS))
    idx = E.batch_indices(0, steps, y.shape[1])
    init = jax_init(0, NARROW)
    ref, jparams = jax_train(method, init, jnp.asarray(X), jnp.asarray(y),
                             jnp.asarray(idx), W)
    res = E.train(E.make_optimizer(method, telemetry=True), init, X, y, idx,
                  W, telemetry=True, device="cpu")
    for k in ("loss", "acc") + TEL:
        np.testing.assert_allclose(res[k], ref[k], **TOL, err_msg=k)
    for name, p in res["params"].items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[name]),
                                   **TOL, err_msg=name)


def test_trainer_records_match_the_jax_schema(tmp_path):
    """Full width, 2 steps: the same JSONL record keys and summary keys as
    the JAX script, and the paper's 936,330 parameters per agent."""
    path = str(tmp_path / "m.jsonl")
    summary = E.run_experiment(steps=2, n_seeds=1, metrics_out=path,
                               device="cpu")
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == 2 * len(E.METHODS)
    assert set(rows[0]) == {"exp", "method", "seed", "step", "loss", "acc",
                            "step_time_ms"} | set(TEL)
    assert summary["n_params"] == 936330 == J.n_params(
        J.init_mlp(jax.random.key(0)))
    assert set(summary) - {"device"} == {
        "target_loss(gd_final)", "n_params", *E.METHODS,
        "speedup_vs_gd", "speedup_vs_nesterov", "speedup_vs_heavy_ball"}


def test_seeded_torch_init_is_deterministic():
    a = E.init_mlp(torch.Generator().manual_seed(3))
    b = E.init_mlp(torch.Generator().manual_seed(3))
    assert sorted(a) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert a["w0"].shape == (2, 784, 1024)
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.regression
def test_full_width_port_tracks_golden_baseline(tmp_path):
    """The committed baseline was recorded with JAX's non-partitionable
    threefry PRNG; the exported initial weights are drawn the same way."""
    def init_fn(seed):
        with jax.threefry_partitionable(False):
            return jax_init(seed, E.SIZES)

    path = str(tmp_path / "exp2.jsonl")
    E.run_experiment(steps=40, n_seeds=1, seed=0, metrics_out=path,
                     device="cpu", init_fn=init_fn)
    base = R.load_baseline(os.path.join(ROOT, "benchmarks", "baselines",
                                        "exp2.json"))
    tol = R.Tolerance(rtol=0.05, max_violation_frac=0.02)
    diffs = R.compare_to_baseline(base, path, tol, include_timing=False)
    assert diffs and all(d.passed for d in diffs), R.format_report(diffs)
