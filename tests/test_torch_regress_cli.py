"""The port's golden-run regression CLI (repro_torch.experiments.regress)
and its serving bench (repro_torch.experiments.serve_bench) on the CPU.

* Tier 1: ``--check --exp exp1 --device cpu`` passes the committed
  baseline benchmarks/baselines/exp1.json (timing bands included); a
  ``--record`` then ``--check`` round trip into a temp dir passes; the
  ``keep`` predicate narrows both sides to the series it accepts;
  ``--record`` refuses the committed directory; the port's serve bench
  writes the JAX bench's golden stream (benchmarks/serve_bench.py) from
  the same JAX initial weights, every clock-free column equal.
* ``-m regression``: exp2, exp3, train and serve pass their committed
  baselines with the JAX initial weights passed in through ``init_fn``,
  drawn inside ``jax.threefry_partitionable(False)`` (the PRNG the
  baselines were recorded with)."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.experiments import regress as RG  # noqa: E402
from repro_torch.experiments import serve_bench as SB  # noqa: E402
from repro_torch.obs import regress as R  # noqa: E402
from repro_torch.obs.metrics import read_jsonl  # noqa: E402

COMMITTED = os.path.join(ROOT, "benchmarks", "baselines")


def test_exp1_check_passes_the_committed_baseline(capsys):
    assert RG.DEFAULT_BASELINE_DIR == COMMITTED
    assert RG.main(["--check", "--exp", "exp1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "-- 18 checks, 0 drifted" in out


def test_record_then_check_round_trips(tmp_path):
    d = str(tmp_path / "base")
    report = str(tmp_path / "report.json")
    assert RG.main(["--record", "--exp", "exp1", "--steps", "40",
                    "--baseline-dir", d, "--device", "cpu"]) == 0
    base = R.load_baseline(os.path.join(d, "exp1.json"))
    assert base["meta"] == {"exp": "exp1", "seed": 0, "steps": 40}
    assert RG.main(["--check", "--exp", "exp1", "--baseline-dir", d,
                    "--device", "cpu", "--report", report]) == 0
    rep = json.load(open(report))
    assert rep["passed"] and rep["n_checks"] == 18


def test_record_refuses_the_committed_baselines():
    with pytest.raises(SystemExit):
        RG.main(["--record", "--exp", "exp1", "--device", "cpu"])


def test_keep_narrows_the_check_to_its_series():
    tol = R.Tolerance()
    diffs = RG.check("exp1", COMMITTED, tol, None, None, False,
                     keep=lambda label: "fractional" in label, device="cpu")
    assert diffs and all(d.passed for d in diffs)
    assert {d.group for d in diffs} == {
        "exp=exp1_quadratic/variant=fractional"}
    assert diffs.summary is None          # the exp1 runner returns nothing
    missing = RG.check("exp1", str(os.path.dirname(COMMITTED)), tol, None,
                       None, False, device="cpu")
    assert len(missing) == 1 and not missing[0].passed


def jax_serve_init(arch, partitionable=True):
    cfg = JREG.get_smoke_config(arch)

    def init(seed):
        with jax.threefry_partitionable(partitionable):
            p = JT.init_params(jax.random.key(seed), cfg)
        return jax.tree.map(np.asarray, p)
    return init


def clock_free(rows):
    return [{k: v for k, v in r.items() if not k.endswith("_ms")}
            for r in rows]


def test_serve_bench_writes_the_jax_benchs_stream(tmp_path):
    from benchmarks import serve_bench as JSB
    assert SB.SERVE_VOLATILE_KEYS == JSB.SERVE_VOLATILE_KEYS
    assert SB.DEFAULT_ARCH == JSB.DEFAULT_ARCH
    jpath, path = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jsum = JSB.run_bench(jpath, seed=0, n_requests=6)
    psum = SB.run_bench(path, seed=0, n_requests=6, device="cpu",
                        init_fn=jax_serve_init(SB.DEFAULT_ARCH))
    ref, mine = read_jsonl(jpath), read_jsonl(path)
    assert len(mine) == len(ref) > 6
    assert clock_free(mine) == clock_free(ref)
    for k in ("n_requests", "total_steps", "total_new_tokens",
              "max_occupancy", "max_queue_depth", "mean_ttft_steps"):
        assert psum[k] == jsum[k], k
    assert not os.path.exists(path + ".raw")


def test_serve_bench_cli_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "s.jsonl")
    assert SB.main(["--device", "cpu", "--requests", "3", "--metrics-out",
                    path]) == 0
    rows = read_jsonl(path)
    assert {r["exp"] for r in rows} == {"serve"}
    assert {r["variant"] for r in rows} == {f"{SB.DEFAULT_ARCH}-smoke"}
    assert sum(r.get("name") == "serve.request" for r in rows) == 3
    assert not any(k in r for r in rows for k in SB.SERVE_VOLATILE_KEYS)
    assert f"metrics -> {path}" in capsys.readouterr().out


# ----------------------------------------------- -m regression: JAX weights

def _old_prng(fn):
    def init(seed):
        with jax.threefry_partitionable(False):
            return fn(seed)
    return init


def _exp2_init(seed):
    from benchmarks import exp2_federated as J
    keys = jax.random.split(jax.random.key(seed), J.N_AGENTS)
    return jax.tree.map(np.asarray, jax.vmap(J.init_mlp)(keys))


def _exp3_init(seed):
    from benchmarks import exp3_faults as J
    keys = jax.random.split(jax.random.key(seed), J.N_AGENTS)
    return jax.tree.map(np.asarray, jax.vmap(J._fed_init)(keys))


def _train_init(seed):
    cfg = JREG.get_smoke_config("h2o-danube-1.8b")
    return jax.tree.map(np.asarray, JTS.init_train_state(
        jax.random.key(seed), cfg, JTS.TrainConfig(), 2).params)


def _serve_init(seed):
    cfg = JREG.get_smoke_config(SB.DEFAULT_ARCH)
    return jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed), cfg))


INITS = {"exp2": _exp2_init, "exp3": _exp3_init, "train": _train_init,
         "serve": _serve_init}


@pytest.mark.regression
@pytest.mark.parametrize("exp", sorted(INITS))
def test_committed_baseline_passes_from_jax_weights(exp):
    diffs = RG.check(exp, COMMITTED, R.Tolerance(), None, None,
                     include_timing=False, device="cpu",
                     init_fn=_old_prng(INITS[exp]))
    assert diffs and all(d.passed for d in diffs), R.format_report(diffs)
