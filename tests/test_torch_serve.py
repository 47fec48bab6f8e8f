"""The port's serving launcher (repro_torch.launch.serve) against the JAX
package's (repro.launch.serve), end to end on the smoke configs (bf16) of
mamba2-780m, h2o-danube-1.8b, qwen3-moe-30b-a3b and minicpm3-4b from the
JAX initial weights.

* Tier 1: the launcher's default trace (8 requests, Poisson rate 0.7 per
  step, seed 0) through both launchers: the same arrival trace, the same
  clock-free serve.step and serve.request columns (tokens by their
  checksums), the same summary; the CLI on the CPU in both modes and its
  flags.
* ``-m regression``: the port's serve bench
  (repro_torch.experiments.serve_bench over run_traffic(device="cpu"))
  passes the committed golden baseline benchmarks/baselines/serve.json
  (recorded on mamba2-780m) under obs.regress's default tolerance, timing
  excluded.
  The baseline was recorded with JAX's non-partitionable threefry PRNG, so
  the JAX initial weights are drawn inside
  jax.threefry_partitionable(False)."""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.obs import regress as R  # noqa: E402
from repro_torch.obs.metrics import read_jsonl  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: wall-clock columns, dropped before comparing (the request ones are
#: the serve bench's SERVE_VOLATILE_KEYS)
VOLATILE = ("ttft_ms", "e2e_ms", "decode_tokens_per_s")


def jax_init(arch, partitionable=True):
    cfg = JREG.get_smoke_config(arch)

    def init(seed):
        with jax.threefry_partitionable(partitionable):
            p = JT.init_params(jax.random.key(seed), cfg)
        return jax.tree.map(np.asarray, p)
    return init


def clock_free(path):
    return [{k: v for k, v in r.items()
             if not k.endswith("_ms") and k not in VOLATILE}
            for r in read_jsonl(path)]


@pytest.mark.parametrize("arch", ["mamba2-780m", "h2o-danube-1.8b",
                                  "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_launcher_matches_the_jax_launcher(tmp_path, arch):
    from repro.launch.serve import run_traffic as jax_run
    jpath, path = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jsum = jax_run(arch=arch, metrics_out=jpath, quiet=True)
    summary = LS.run_traffic(arch=arch, metrics_out=path, quiet=True,
                             device="cpu", init_fn=jax_init(arch))
    mine, ref = clock_free(path), clock_free(jpath)
    assert len(mine) == len(ref) > 8
    assert mine == ref
    for k, v in jsum.items():
        if k != "decode_tokens_per_s":
            assert summary[k] == v, k
    reqs = [r for r in read_jsonl(path) if r["name"] == "serve.request"]
    assert [int(np.sum(t)) for t in summary["tokens"]] == \
        [r["token_sum"] for r in sorted(reqs, key=lambda r: r["step"])]


def test_traffic_trace_is_seeded():
    a = LS.traffic(512, 8, 0.7, seed=0)
    b = LS.traffic(512, 8, 0.7, seed=0)
    assert sum(map(len, a)) == 8 and len(a) > 8       # idle rounds too
    assert [[(p.tolist(), n) for p, n in r] for r in a] == \
        [[(p.tolist(), n) for p, n in r] for r in b]
    lens = [len(p) for r in a for p, _ in r]
    assert min(lens) >= 4 and max(lens) <= 12
    assert LS.traffic(512, 8, 0.7, seed=1) != a


def test_load_model_takes_numpy_or_tensor_trees():
    cfg, p = LS.load_model("mamba2-780m", True, 0, "cpu",
                           param_dtype="float32")
    assert cfg.param_dtype == cfg.compute_dtype == "float32"
    assert all(t.dtype == torch.float32 for t in TR.leaves(p))
    cfg2, p2 = LS.load_model("mamba2-780m", True, 0, "cpu",
                             param_dtype="float32")
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(p),
                                                 TR.leaves(p2)))
    _, p3 = LS.load_model("mamba2-780m", True, 1, "cpu",
                          init_fn=lambda s: TR.tree_map(
                              lambda t: t.numpy(), p))
    _, p4 = LS.load_model("mamba2-780m", True, 1, "cpu",
                          init_fn=lambda s: p)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
        TR.leaves(p), TR.leaves(p3), TR.leaves(p4)))


def test_cli_runs_on_the_cpu_when_asked(capsys, tmp_path):
    spans = str(tmp_path / "spans.json")
    LS.main(["--device", "cpu", "--smoke", "--requests", "3",
             "--arch", "h2o-danube-1.8b", "--window-override", "8",
             "--spans-out", spans])
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in out[:3]] == ["req0", "req1",
                                                        "req2"]
    assert "'total_new_tokens'" in out[-1]
    names = {e["name"] for e in json.load(open(spans))["traceEvents"]
             if e.get("ph") == "X"}
    assert {"serve.step", "serve.admission", "serve.prefill",
            "serve.decode", "serve.telemetry"} <= names


def test_cli_static_batch_mode(capsys):
    LS.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
             "--new-tokens", "3", "--arch", "mamba2-780m"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and out[0].startswith("req0: [")
    assert len(json.loads(out[1].split(": ", 1)[1])) == 3


def test_cli_flags(monkeypatch):
    """--no-smoke reaches the full config (the JAX launcher's --smoke is a
    store_true that defaults to True); the traffic mode's flags reach
    run_traffic."""
    seen = {}
    monkeypatch.setattr(LS, "run_traffic", lambda **kw: seen.update(kw))
    LS.main(["--no-smoke", "--device", "cpu", "--window-override", "128",
             "--max-slots", "8", "--requests", "16"])
    assert seen["smoke"] is False and seen["window_override"] == 128
    assert seen["max_slots"] == 8 and seen["n_requests"] == 16
    assert seen["device"] == "cpu"
    LS.main([])
    assert seen["smoke"] is True and seen["device"] == "cuda"
    assert seen["window_override"] is None


@pytest.mark.regression
def test_port_launcher_passes_the_serve_baseline(tmp_path):
    """The port's serve bench (repro_torch.experiments.serve_bench, which
    drives this launcher) on the JAX initial weights."""
    from repro_torch.experiments import serve_bench as SB
    base = R.load_baseline(os.path.join(ROOT, "benchmarks", "baselines",
                                        "serve.json"))
    path = str(tmp_path / "serve.jsonl")
    SB.run_bench(path, seed=base["meta"]["seed"],
                 n_requests=base["meta"]["steps"], device="cpu",
                 init_fn=jax_init(SB.DEFAULT_ARCH, partitionable=False))
    diffs = R.compare_to_baseline(base, path, R.Tolerance(),
                                  include_timing=False)
    assert diffs and all(d.passed for d in diffs), R.format_report(diffs)
