"""The port's continuous-batching scheduler and engine
(serving/scheduler.py, serving/engine.py) against the JAX package's, and
the properties the JAX package's serving tests pin: validation, mid-flight
admission bit-equal to solo runs, Engine.generate bit-equal to the
scheduler run alone, the record key sets, and phase columns that tile the
step.  Models: the smoke configs of h2o-danube-1.8b, mamba2-780m,
qwen3-moe-30b-a3b and kimi-k2-1t-a32b (MoE: the two-stack cache of a
dense prefix) and minicpm3-4b (MLA: the latent cache), from the JAX
package's initial weights.

The port against itself (solo against packed, the engine against the
scheduler): bit for bit, in the configs' bf16.  The port against the JAX
scheduler and engine: every request's greedy tokens and every serve.step
column that reads no clock must be equal, in f32.  In bf16 the two
packages' logits can differ by one bf16 ulp where their hidden states are
bit-equal (the unembedding's f32 sums run in another order before the
rounding), and a greedy argmax at such a near-tie flips: the two engines
on mamba2's bf16 smoke config, prompts [[5, 3, 1], [2, 4, 6]], part at the
fourth token of the second (ROADMAP.md, section 3)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.configs import registry as JREG  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import scheduler as JS  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import (Engine, make_prefill,  # noqa: E402
                                        make_serve_step)
from repro_torch.serving.scheduler import (  # noqa: E402
    REQUEST_RECORD_KEYS, STEP_RECORD_KEYS, Scheduler, SchedulerConfig,
    masked_decode)
from repro_torch.models import decode as D  # noqa: E402

ARCHS = ("h2o-danube-1.8b", "mamba2-780m", "qwen3-moe-30b-a3b",
         "kimi-k2-1t-a32b", "minicpm3-4b")


def models(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = JREG.get_smoke_config(arch).replace(**kw)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    return (REG.get_smoke_config(arch).replace(**kw),
            params_from_numpy(jp, "cpu"), jcfg, jp)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return models(request.param, "bfloat16")


@pytest.fixture(scope="module", params=ARCHS)
def smoke32(request):
    return models(request.param, "float32")


def prompts(cfg, lens, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]


def test_sched_config_validation():
    for kw in ({"max_slots": 0}, {"prefill_chunk": 0}, {"token_budget": 0}):
        with pytest.raises(ValueError):
            SchedulerConfig(**kw)


def test_submit_validation(smoke):
    cfg, params = smoke[:2]
    sch = Scheduler(cfg, params, SchedulerConfig(max_slots=1, max_len=16))
    with pytest.raises(ValueError):
        sch.submit(np.array([], np.int32), 2)
    with pytest.raises(ValueError):
        sch.submit(np.array([1, 2], np.int32), 0)
    with pytest.raises(ValueError):
        sch.submit(np.array([1] * 10, np.int32), 8)   # 10 + 8 > 16
    with pytest.raises(KeyError):
        sch.result(5)


def test_record_key_sets_are_the_jax_package_s():
    assert STEP_RECORD_KEYS == JS.STEP_RECORD_KEYS
    assert REQUEST_RECORD_KEYS == JS.REQUEST_RECORD_KEYS


def run_staggered(sch, ps, n_new, arrive):
    rids, k = [], 0
    while sch.has_work or k < len(ps):
        while k < len(ps) and arrive[k] <= sch.step_idx:
            rids.append(sch.submit(ps[k], n_new[k]))
            k += 1
        if sch.has_work:
            sch.step()
    return rids


def test_mid_flight_admission_matches_solo_runs(smoke):
    """Requests admitted into a half-busy pool at staggered times give
    greedy tokens bit-equal to solo runs, while the telemetry shows real
    batching (occupancy > 1), queueing, and the queue draining to 0."""
    cfg, params = smoke[:2]
    ps = prompts(cfg, (5, 3, 8))
    n_new = [4, 5, 3]
    sc = SchedulerConfig(max_slots=2, max_len=32, prefill_chunk=4,
                         token_budget=16)
    solo = []
    for p, n in zip(ps, n_new):
        s = Scheduler(cfg, params, sc)
        solo.append(s.result(s.submit(p, n)))
    sink = obs.MemorySink()
    s = Scheduler(cfg, params, sc, sink=sink)
    rids = run_staggered(s, ps, n_new, [0, 0, 1])
    for r, want in zip(rids, solo):
        np.testing.assert_array_equal(s.poll(r), want)
    steps = [r for r in sink.records if r["name"] == "serve.step"]
    assert max(r["occupancy"] for r in steps) > 1
    assert steps[-1]["queue_depth"] == 0 and steps[-1]["occupancy"] == 0
    reqs = [r for r in sink.records if r["name"] == "serve.request"]
    assert len(reqs) == len(ps)
    assert max(r["queue_steps"] for r in reqs) > 0


def test_scheduler_matches_the_jax_scheduler(smoke32):
    """The same staggered trace through both schedulers: equal tokens per
    request and equal clock-free serve.step / serve.request columns."""
    cfg, params, jcfg, jp = smoke32
    ps = prompts(cfg, (6, 3, 9, 4), seed=2)
    n_new, arrive = [5, 6, 3, 4], [0, 0, 1, 3]
    sc = dict(max_slots=2, max_len=32, prefill_chunk=4, token_budget=8)
    sink, jsink = obs.MemorySink(), jobs.MemorySink()
    s = Scheduler(cfg, params, SchedulerConfig(**sc), sink=sink)
    js = JS.Scheduler(jcfg, jax.tree.map(jax.numpy.asarray, jp),
                      JS.SchedulerConfig(**sc), sink=jsink)
    rids = run_staggered(s, ps, n_new, arrive)
    jrids = run_staggered(js, ps, n_new, arrive)
    assert [s.poll(r).tolist() for r in rids] == \
        [js.poll(r).tolist() for r in jrids]

    def clock_free(records):
        return [{k: v for k, v in r.items() if not k.endswith("_ms")
                 and k != "decode_tokens_per_s"} for r in records]

    assert clock_free(sink.records) == clock_free(jsink.records)
    assert len(sink.records) == len(jsink.records) > len(ps)


def test_engine_generate_matches_scheduler_solo(smoke):
    """Engine.generate over the scheduler: the same tokens as driving the
    scheduler directly, one request at a time."""
    cfg, params = smoke[:2]
    ps = np.array([[5, 3, 1], [2, 4, 6]], np.int32)
    out = Engine(cfg, params, max_len=32, max_slots=2).generate(ps, n_new=4)
    assert out.shape == (2, 4) and out.dtype == np.int32
    for b in range(2):
        s = Scheduler(cfg, params, SchedulerConfig(max_slots=2, max_len=32))
        np.testing.assert_array_equal(out[b], s.result(s.submit(ps[b], 4)))


def test_engine_matches_the_jax_engine(smoke32):
    cfg, params, jcfg, jp = smoke32
    ps = np.array([[5, 3, 1], [2, 4, 6]], np.int32)
    out = Engine(cfg, params, max_len=32, max_slots=2).generate(ps, n_new=6)
    jout = JEngine(jcfg, jax.tree.map(jax.numpy.asarray, jp), max_len=32,
                   max_slots=2).generate(ps, n_new=6)
    np.testing.assert_array_equal(out, jout)


def test_step_records_and_phases_tile_the_step(smoke):
    cfg, params = smoke[:2]
    sink = obs.MemorySink()
    eng = Engine(cfg, params, max_len=32, max_slots=2, sink=sink)
    eng.generate(np.array([[1, 2, 3, 4, 5]], np.int32), n_new=3)
    eng.generate(np.array([[6, 7, 8], [9, 10, 11]], np.int32), n_new=2)
    steps = [r for r in sink.records if r["name"] == "serve.step"]
    reqs = [r for r in sink.records if r["name"] == "serve.request"]
    gens = [r for r in sink.records if r["name"] == "serve.generate"]
    assert all(tuple(r) == STEP_RECORD_KEYS for r in steps)
    assert all(tuple(r) == REQUEST_RECORD_KEYS for r in reqs)
    assert len(reqs) == 3 and [g["step"] for g in gens] == [0, 1]
    assert set(eng.last_stats) == {
        "batch", "prompt_len", "new_tokens", "prefill_ms", "decode_ms",
        "decode_ms_per_token", "decode_tokens_per_s"}
    assert eng.last_stats["batch"] == 2
    for r in steps:
        phases = sum(r[k] for k in r if k.startswith("phase_"))
        assert abs(phases - r["step_time_ms"]) <= 0.01, r
    assert steps[0]["phase_telemetry_ms"] == 0.0


def test_masked_decode_keeps_inactive_slots(smoke):
    """Decode runs every row of the arena but writes back only the active
    slots: a mid-prefill slot's cache (the SSM state included) and a free
    slot's zeros keep their bytes."""
    cfg, params = smoke[:2]
    sch = Scheduler(cfg, params, SchedulerConfig(max_slots=3, max_len=32))
    for _ in range(2):
        sch.pool.alloc()
    for slot, n in ((0, 4), (1, 6)):
        _, c = D.prefill_cache(params, sch.pool.read_slot(slot),
                               torch.arange(1, n + 1)[None], 0, cfg)
        sch.pool.write_slot(slot, c)
    before = TR.tree_map(torch.clone, sch.pool.arena)
    masked_decode(params, sch.pool, torch.tensor([[3], [4], [5]]),
                  torch.tensor([4, 6, 0]), torch.tensor([0]), cfg, None)
    for new, old in zip(TR.leaves(sch.pool.arena), TR.leaves(before)):
        assert not torch.equal(new[:, 0], old[:, 0])
        assert torch.equal(new[:, 1:], old[:, 1:])


def test_serve_step_and_prefill_units(smoke):
    cfg, params = smoke[:2]
    toks = torch.tensor([[5, 6, 7], [1, 2, 3]])
    last, cache = D.prefill_cache(params, D.init_cache(cfg, 2, 16), toks, 0,
                                  cfg)
    nxt, _ = make_serve_step(cfg)(params, cache, toks[:, -1:], 3)
    assert nxt.shape == (2, 1)
    logits = make_prefill(cfg)(params, {"tokens": toks})
    assert logits.shape == (2, cfg.vocab)
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(),
                                  torch.argmax(last, -1).numpy())
