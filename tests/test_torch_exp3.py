"""The port's Exp 3 script (repro_torch.experiments.exp3_faults) against the
JAX script (benchmarks/exp3_faults.py) on the CPU, on the same compiled
fault schedules.

* Quadratic arm, 60 rounds at 30% drop, both drop modes: per-round error,
  objective and consensus errors within rtol 1e-4 / atol 1e-6 (f32 on both
  sides; the port's FrODO takes the kernel's plain version, which sums the
  90 slots in another order); fault counters equal.
* Federated arm, 8 steps from the JAX initial weights exported to numpy:
  loss, accuracy and consensus errors within rtol 1e-4 / atol 1e-5.
* ``-m regression``: the whole port at the baseline's scale against the
  committed golden baseline benchmarks/baselines/exp3.json with
  repro.obs.regress's tolerances (rtol 0.05, violation budget 0.02), timing
  excluded, and the >= 2x robustness headline.  The baseline was recorded
  with JAX's non-partitionable threefry PRNG, so the federated arm's JAX
  weights are drawn that way."""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import exp3_faults as J  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.experiments import exp3_faults as E  # noqa: E402
from repro_torch.obs import regress as R  # noqa: E402

BASELINE = os.path.join(ROOT, "benchmarks", "baselines", "exp3.json")


@pytest.fixture(autouse=True)
def one_thread():
    """Hundreds of rounds of tiny ops: one thread is fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_init(seed):
    """The JAX script's federated initial weights, exported to numpy."""
    keys = jax.random.split(jax.random.key(seed), E.N_AGENTS)
    return jax.tree.map(np.asarray, jax.vmap(J._fed_init)(keys))


@pytest.mark.parametrize("drop_mode", ["directed", "symmetric"])
@pytest.mark.parametrize("method", E.METHODS)
def test_quadratic_arm_matches_jax(method, drop_mode):
    K = 60
    ref = J.run_quadratic(method, 0.3, K, seed=0, collect_metrics=True,
                          drop_mode=drop_mode)
    got = E.run_quadratic(method, 0.3, K, seed=0, collect_metrics=True,
                          drop_mode=drop_mode, device="cpu")
    assert set(got) == set(ref)
    for k in ("errors", "f", "consensus_error", "consensus_error_pre_mix"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in tf.FAULT_COUNTER_NAMES + ("jitter_ms",):
        assert got[k].tobytes() == np.asarray(ref[k]).tobytes(), k


@pytest.mark.parametrize("method", E.METHODS)
def test_federated_arm_matches_jax(method):
    steps = 8
    ref = J.run_federated(method, 0.3, steps, seed=0)
    got = E.run_federated(method, 0.3, steps, seed=0, device="cpu",
                          init=jax_init(0))
    assert set(got) == set(ref)
    for k in ("loss", "acc", "consensus_error", "consensus_error_pre_mix"):
        assert got[k].shape == (steps,)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in tf.FAULT_COUNTER_NAMES + ("jitter_ms",):
        assert got[k].tobytes() == np.asarray(ref[k]).tobytes(), k


def test_kernel_path_matches_plain_path():
    """FrODO with ``use_kernel=True`` (here the kernel's plain version)
    against ``use_kernel=False``: the same update, the 90 slots summed in
    another order (rtol 1e-5 / atol 1e-6)."""
    a = E.run_quadratic("frodo", 0.3, 40, 0, device="cpu")
    b = E.run_quadratic("frodo", 0.3, 40, 0, device="cpu", use_kernel=False)
    np.testing.assert_allclose(a["errors"], b["errors"], rtol=1e-5,
                               atol=1e-6)
    a = E.run_federated("frodo", 0.3, 4, 0, device="cpu")
    b = E.run_federated("frodo", 0.3, 4, 0, device="cpu", use_kernel=False)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, atol=1e-6)


def test_records_and_summary_match_the_jax_schema(tmp_path):
    """A tiny sweep: the JSONL series and metric names of the committed
    baseline (recorded by the JAX script) and the JAX summary's keys."""
    path = str(tmp_path / "m.jsonl")
    summary = E.run_experiment(seed=0, quad_steps=6, fed_steps=3,
                               metrics_out=path, metrics_steps=4,
                               out=str(tmp_path / "s.json"), device="cpu",
                               drop_mode="symmetric")
    base = R.load_baseline(BASELINE)
    got = R.make_baseline(path)
    assert set(got["series"]) == set(base["series"])
    for label, entry in base["series"].items():
        assert set(got["series"][label]["metrics"]) == set(entry["metrics"])
        assert set(got["series"][label]["timing"]) == set(entry["timing"])
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == 4 * 3 * 4 + 4 * 3 * 3   # drops x methods x steps
    tags = ["drop0", "drop10", "drop30", "drop50"]
    assert summary.pop("device") == "cpu"
    assert summary.pop("drop_mode") == "symmetric"
    assert set(summary) == {"quadratic", "federated"}
    assert list(summary["quadratic"]) == tags
    for tag in tags:
        row = summary["quadratic"][tag]
        assert set(row) == set(E.METHODS) | {"dgd_over_frodo_iters"}
        for m in E.METHODS:
            assert set(row[m]) == {"iters_to_tol", "final_error", "final_f"}
            assert set(summary["federated"][tag][m]) == {
                "final_loss", "final_acc", "steps_to_target"}
    assert set(summary["federated"]) == set(tags) | {
        "target_loss(gd_healthy_final)"}


@pytest.mark.regression
def test_port_tracks_golden_baseline(tmp_path):
    def init_fn(seed):
        with jax.threefry_partitionable(False):
            return jax_init(seed)

    base = R.load_baseline(BASELINE)
    meta = base["meta"]
    steps = meta["steps"]
    path = str(tmp_path / "exp3.jsonl")
    summary = E.run_experiment(seed=meta["seed"], quad_steps=steps,
                               fed_steps=max(steps // 8, 10),
                               metrics_out=path,
                               metrics_steps=min(steps, 60), device="cpu",
                               init_fn=init_fn)
    tol = R.Tolerance(rtol=0.05, max_violation_frac=0.02)
    diffs = R.compare_to_baseline(base, path, tol, include_timing=False)
    assert diffs and all(d.passed for d in diffs), R.format_report(diffs)
    row = summary["quadratic"]["drop30"]
    assert row["frodo"]["iters_to_tol"] < steps
    assert row["dgd_over_frodo_iters"] >= 2.0, summary["quadratic"]
