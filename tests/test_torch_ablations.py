"""The port's ablations (repro_torch.experiments.ablations) against the
JAX script (benchmarks/ablations.py) on the CPU, at reduced round counts.

* Iterations to 1e-6, exact memory, on points of the λ arm (both condition
  numbers), of the K arm (exact T = 90 and exp-sum K = 4, 8, 12) and of the
  interval arm (H = 2, 8: the JAX scan with ``lax.cond`` against the
  port's Python loop), equal to the JAX script's; the port runs every arm
  through one loop with all agents' gradients in one autograd pass, where
  the JAX script runs ``core.loop.run`` at H = 1.
* The dtype arm: the same iteration counts to 1e-2 / 1e-3 in f32 and bf16
  accumulators, its JSONL columns, and the CLI writing every arm."""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import ablations as JA  # noqa: E402
from repro.core.frodo import FrodoConfig as JFrodoConfig  # noqa: E402
from repro.core.frodo import frodo as jfrodo  # noqa: E402
from repro_torch.experiments import ablations as A  # noqa: E402
from repro_torch.obs.metrics import read_jsonl  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """Hundreds of rounds of tiny ops: one thread is fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(cond, rounds, interval=1, **kw):
    mine = A._iters(A._frodo(CPU, **dict(kw)), cond, rounds, interval,
                    device="cpu")
    ref = JA._iters(jfrodo(JFrodoConfig(alpha=0.8, beta=0.35, T=90,
                                        **{"lam": 0.15, **kw})),
                    JA._objective(cond), K=rounds, interval=interval)
    return mine, ref


@pytest.mark.parametrize("cond,lam", [(10.0, 0.05), (10.0, 0.4),
                                      (100.0, 0.15), (100.0, 0.2)])
def test_lambda_points_match_the_jax_script(cond, lam):
    mine, ref = both(cond, 520, lam=lam)
    assert mine == ref < 520


@pytest.mark.parametrize("kw", [dict(memory_mode="exact"),
                                dict(memory_mode="expsum", K=4),
                                dict(memory_mode="expsum", K=8),
                                dict(memory_mode="expsum", K=12)],
                         ids=["exact_T90", "K=4", "K=8", "K=12"])
def test_expsum_K_points_match_the_jax_script(kw):
    mine, ref = both(100.0, 700, **kw)
    assert mine == ref < 700


@pytest.mark.parametrize("interval", [2, 8])
def test_interval_points_match_the_jax_script(interval):
    mine, ref = both(100.0, 450, interval=interval)
    assert mine == ref < 450


def test_dtype_arm_matches_the_jax_script(tmp_path):
    steps = 300
    path = str(tmp_path / "dtype.jsonl")
    mine = A.expsum_dtype(jsonl_path=path, steps=steps, device="cpu")
    ref = JA.expsum_dtype(jsonl_path=None, steps=steps)
    for dtype in ("float32", "bfloat16"):
        for k in ("iters_to_1e-2", "iters_to_1e-3", "acc_bytes_per_param"):
            assert mine[dtype][k] == ref[dtype][k], (dtype, k)
        assert mine[dtype]["final_error"] == pytest.approx(
            ref[dtype]["final_error"], rel=1e-3, abs=1e-6)
    rows = read_jsonl(path)
    assert len(rows) == 2 * steps
    for col in ("error", "memory_norm", "consensus_error",
                "consensus_error_pre_mix", "step_time_ms", "phase_update_ms",
                "phase_mix_ms", "phase_metrics_ms"):
        assert all(col in r for r in rows), col
    assert rows[0]["phase_update_ms"] < rows[1]["phase_update_ms"]


def test_cli_writes_every_arm(tmp_path, capsys):
    out = str(tmp_path / "abl.json")
    res = A.main(["--device", "cpu", "--rounds", "30", "--dtype-steps", "5",
                  "--out", out, "--dtype-jsonl", ""])
    assert json.load(open(out)) == res
    assert set(res) == {"lambda_sensitivity", "expsum_K",
                        "consensus_interval_H", "expsum_dtype"}
    assert res["lambda_sensitivity"]["cond10"]["lam=0.8"] == 30
    assert set(res["expsum_K"]) == {"exact_T90", "K=2", "K=4", "K=6",
                                    "K=8", "K=12"}
    assert json.loads(capsys.readouterr().out) == res
