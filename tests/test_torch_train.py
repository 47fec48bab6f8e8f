"""The port's launcher (repro_torch.launch.train) against the JAX package's
(repro.launch.train), end to end on h2o-danube-1.8b's smoke config (bf16,
2 agents, FrODO exact memory T = 40), from the JAX initial weights.

* Tier 1: 3 steps at seq 16 through both launchers; the per-step sink
  records carry the same keys, and every metric agrees within rtol 2e-2 /
  atol 1e-4 (bf16 parameters and products: ~3 digits, rounded at other
  places by XLA and PyTorch); the CLI runs on the CPU when asked.
* ``-m regression``: the port's run_training(use_kernel=False,
  device="cpu") passes the committed golden baseline
  benchmarks/baselines/train.json under obs.regress's default tolerance
  (rtol 0.05, violation budget 0.02).  The baseline was recorded with
  JAX's non-partitionable threefry PRNG, so the JAX initial weights are
  drawn inside jax.threefry_partitionable(False)."""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.obs import regress as R  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "h2o-danube-1.8b"
#: wall-clock counters of the trainer's sink (benchmarks/regress.py's
#: TRAIN_VOLATILE_KEYS), dropped before comparing
VOLATILE = ("wall_s", "throughput_items_per_s",
            "throughput_items_per_s_instant")


def jax_init(seed, agents=2, partitionable=True):
    cfg = JREG.get_smoke_config(ARCH)
    with jax.threefry_partitionable(partitionable):
        params = JTS.init_train_state(jax.random.key(seed), cfg,
                                      JTS.TrainConfig(), agents).params
    return jax.tree.map(np.asarray, params)


def test_launcher_matches_the_jax_launcher(tmp_path):
    from repro.launch.train import run_training as jax_run
    kw = dict(arch=ARCH, smoke=True, steps=3, agents=2, seq=16,
              batch_per_agent=2, seed=0)
    jpath, path = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jax_run(metrics_out=jpath, **kw)
    LT.run_training(metrics_out=path, device="cpu", use_kernel=True,
                    init_fn=lambda s: jax_init(s), **kw)
    ref = [json.loads(line) for line in open(jpath)]
    mine = [json.loads(line) for line in open(path)]
    assert len(mine) == len(ref) == 3
    for r, m in zip(ref, mine):
        assert set(m) == set(r)
        for k, v in r.items():
            if k in VOLATILE or k.endswith("_ms"):
                continue
            np.testing.assert_allclose(m[k], v, rtol=2e-2, atol=1e-4,
                                       err_msg=k)


def test_cli_runs_on_the_cpu_when_asked(capsys):
    LT.main(["--device", "cpu", "--smoke", "--steps", "2", "--seq", "8",
             "--batch-per-agent", "1", "--memory-mode", "expsum",
             "--no-use-kernel"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in lines)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_cli_trains_the_moe_and_mla_archs(capsys, arch):
    LT.main(["--device", "cpu", "--smoke", "--arch", arch, "--steps", "2",
             "--seq", "16", "--batch-per-agent", "1", "--memory-mode",
             "expsum"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in lines)


@pytest.mark.regression
def test_port_launcher_tracks_golden_baseline(tmp_path):
    raw = str(tmp_path / "raw.jsonl")
    LT.run_training(arch=ARCH, smoke=True, steps=12, agents=2,
                    metrics_out=raw, collect_metrics=True, seed=0,
                    use_kernel=False, device="cpu",
                    init_fn=lambda s: jax_init(s, partitionable=False))
    path = str(tmp_path / "train.jsonl")
    with open(raw) as src, open(path, "w") as dst:
        for line in src:
            rec = json.loads(line)
            for k in VOLATILE:
                rec.pop(k, None)
            rec.update(exp="launch_train", name="h2o-danube-1.8b-smoke",
                       seed=0)
            dst.write(json.dumps(rec) + "\n")
    base = R.load_baseline(os.path.join(ROOT, "benchmarks", "baselines",
                                        "train.json"))
    diffs = R.compare_to_baseline(base, path, R.Tolerance(),
                                  include_timing=False)
    assert diffs and all(d.passed for d in diffs), R.format_report(diffs)
