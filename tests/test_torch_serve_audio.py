"""Serving the audio family (whisper-tiny's smoke config): the frames path
from the launcher's trace through the scheduler's admission (the encoder
writes the slot's cross K/V), the engine and the static ``--batch`` mode.

* The port's ``run_traffic(arch="whisper-tiny", device="cpu")`` against
  the JAX package's ``run_traffic`` in f32 (its smoke config made f32 for
  the run, the port given the same JAX initial weights): the same arrival
  trace with the same frames, equal tokens and clock-free serve.step /
  serve.request columns.  f32, because in bf16 a one-ulp logit difference
  can flip a greedy near-tie (ROADMAP.md, section 3).
* The port against itself in bf16: each request alone, and through
  ``Engine.generate``, bit-equal to the packed run.
* A request without frames to an audio model raises, as frames to any
  other model do."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs.metrics import read_jsonl  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import (Scheduler,  # noqa: E402
                                           SchedulerConfig)

ARCH = "whisper-tiny"
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
    jsum = jax_run(arch=ARCH, metrics_out=jpath, quiet=True)
    summary = LS.run_traffic(
        arch=ARCH, metrics_out=path, quiet=True, device="cpu",
        param_dtype="float32", init_fn=lambda seed: jax.tree.map(
            np.asarray, JT.init_params(jax.random.key(seed), jcfg)))
    mine, ref = clock_free(path), clock_free(jpath)
    assert len(mine) == len(ref) > 8
    assert mine == ref
    for k, v in jsum.items():
        if k != "decode_tokens_per_s":
            assert summary[k] == v, k
    assert summary["max_occupancy"] > 1


def test_the_trace_carries_frames_in_the_jax_order():
    """Audio arrivals are (prompt, max_new, frames), seeded; the first
    request's prompt and length are the trace's without frames (its frames
    are drawn after them)."""
    cfg = REG.get_smoke_config(ARCH)
    shape = LS.frames_shape(cfg)
    assert shape == (cfg.n_frames, cfg.d_model)
    assert LS.frames_shape(REG.get_smoke_config("h2o-danube-1.8b")) is None
    a = [r for rd in LS.traffic(512, 4, 0.7, seed=0, frames_shape=shape)
         for r in rd]
    b = [r for rd in LS.traffic(512, 4, 0.7, seed=0, frames_shape=shape)
         for r in rd]
    assert len(a) == 4 and all(len(r) == 3 for r in a)
    assert a[0][2].shape == shape and a[0][2].dtype == np.float32
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    plain = [r for rd in LS.traffic(512, 4, 0.7, seed=0) for r in rd]
    assert [(p.tolist(), n) for p, n in plain[:1]] == \
        [(p.tolist(), n) for p, n, _ in a[:1]]


def test_solo_and_engine_runs_are_the_packed_run_bit_for_bit():
    cfg, params = LS.load_model(ARCH, True, 0, "cpu")
    sc = dict(max_slots=4, max_len=64, prefill_chunk=8, token_budget=32)
    trace = [r for rd in LS.traffic(cfg.vocab, 6, 0.7, seed=0,
                                    frames_shape=LS.frames_shape(cfg))
             for r in rd]
    packed = Scheduler(cfg, params, SchedulerConfig(**sc))
    rids = [packed.submit(*r) for r in trace]
    packed.run()
    out = [packed.poll(r).tolist() for r in rids]
    for i in (0, 3):
        s = Scheduler(cfg, params, SchedulerConfig(**sc))
        assert s.result(s.submit(*trace[i])).tolist() == out[i]
    prompt, n_new, fr = trace[0]
    got = Engine(cfg, params, **sc).generate(np.stack([prompt, prompt]),
                                             n_new, np.stack([fr, fr]))
    assert all(row.tolist() == out[0] for row in got)


def test_requests_without_frames_or_with_them_wrongly_raise():
    cfg, params = LS.load_model(ARCH, True, 0, "cpu")
    sch = Scheduler(cfg, params, SchedulerConfig(max_slots=1, max_len=16))
    with pytest.raises(ValueError, match="frames"):
        sch.submit(np.array([1, 2], np.int32), 2)
    with pytest.raises(ValueError, match="frames"):
        Engine(cfg, params, max_len=16).generate(
            np.array([[1, 2]], np.int32), 2)
    dense = REG.get_smoke_config("h2o-danube-1.8b")
    s = Scheduler(dense, T.init_params(torch.Generator(), dense),
                  SchedulerConfig(max_slots=1, max_len=16))
    with pytest.raises(ValueError, match="frames"):
        s.submit(np.array([1, 2], np.int32), 2,
                 frames=np.zeros((4, dense.d_model), np.float32))


def test_cli_static_batch_mode_draws_frames(capsys):
    LS.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
             "--new-tokens", "3", "--arch", ARCH])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and out[1].startswith("req1: [")
