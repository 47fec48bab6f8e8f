"""Serving the hybrid family (recurrentgemma-9b's smoke config): the
launcher's trace through the scheduler's slot pool, whose arena carries
every RG-LRU state, conv window and local-attention ring at the slot axis.

* The port's ``run_traffic(arch="recurrentgemma-9b", device="cpu")``
  against the JAX package's ``run_traffic`` in f32 (its smoke config made
  f32 for the run, both given the same JAX initial weights, drawn under
  ``jax.threefry_partitionable(False)``): equal tokens and clock-free
  serve.step / serve.request columns, the same summary.  f32, because in
  bf16 a one-ulp logit difference can flip a greedy near-tie (ROADMAP.md,
  section 3).
* The port against itself in bf16: each request alone, and through
  ``Engine.generate``, bit-equal to the packed run; the CLI's static
  ``--batch`` mode."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.obs.metrics import read_jsonl  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import (Scheduler,  # noqa: E402
                                           SchedulerConfig)

ARCH = "recurrentgemma-9b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
#: wall-clock columns, dropped before comparing
VOLATILE = ("ttft_ms", "e2e_ms", "decode_tokens_per_s")


def clock_free(path):
    return [{k: v for k, v in r.items()
             if not k.endswith("_ms") and k not in VOLATILE}
            for r in read_jsonl(path)]


def test_launcher_matches_the_jax_launcher_in_f32(tmp_path, monkeypatch):
    from repro.launch.serve import run_traffic as jax_run
    jcfg = JREG.get_smoke_config(ARCH).replace(**F32)
    smoke = JREG.get_smoke_config
    monkeypatch.setattr(JREG, "get_smoke_config",
                        lambda a: jcfg if a == ARCH else smoke(a))
    jpath, path = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    with jax.threefry_partitionable(False):
        jsum = jax_run(arch=ARCH, metrics_out=jpath, quiet=True)
        init = jax.tree.map(np.asarray,
                            JT.init_params(jax.random.key(0), jcfg))
    summary = LS.run_traffic(arch=ARCH, metrics_out=path, quiet=True,
                             device="cpu", param_dtype="float32",
                             init_fn=lambda seed: init)
    mine, ref = clock_free(path), clock_free(jpath)
    assert len(mine) == len(ref) > 8
    assert mine == ref
    for k, v in jsum.items():
        if k != "decode_tokens_per_s":
            assert summary[k] == v, k
    assert summary["max_occupancy"] > 1


def test_solo_and_engine_runs_are_the_packed_run_bit_for_bit():
    """Six requests whose prompts and generations reach past the smoke
    local window of 32 (the ring wraps) at max_len 96."""
    cfg, params = LS.load_model(ARCH, True, 0, "cpu")
    sc = dict(max_slots=4, max_len=96, prefill_chunk=8, token_budget=32)
    trace = [r for rd in LS.traffic(cfg.vocab, 6, 0.7, (20, 40), (8, 24),
                                    seed=0) for r in rd]
    assert max(len(p) + n for p, n in trace) > 32
    packed = Scheduler(cfg, params, SchedulerConfig(**sc))
    rids = [packed.submit(*r) for r in trace]
    packed.run()
    out = [packed.poll(r).tolist() for r in rids]
    for i in (0, 3, 5):
        s = Scheduler(cfg, params, SchedulerConfig(**sc))
        assert s.result(s.submit(*trace[i])).tolist() == out[i]
    prompt, n_new = trace[0]
    got = Engine(cfg, params, **sc).generate(np.stack([prompt, prompt]),
                                             n_new)
    assert all(row.tolist() == out[0] for row in got)


def test_cli_serves_the_hybrid(capsys):
    LS.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
             "--new-tokens", "3", "--arch", ARCH])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and out[1].startswith("req1: [")
    LS.main(["--device", "cpu", "--requests", "3", "--arch", ARCH])
    out = capsys.readouterr().out.strip().splitlines()
    assert [l[:5] for l in out[:3]] == ["req0:", "req1:", "req2:"]
    assert len(out) == 4 and "'total_new_tokens'" in out[3]
