"""The port's obs.spans, obs.timing and obs.report (src/repro_torch/obs/)
against the JAX package's: the recorder's nesting and aggregation, the
Chrome-trace and JSONL exports (equal for the same span list), the report
CLI, the timing helpers, and the host spans of the port's loop.run, the
trainer and the launcher."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import report as JRPT  # noqa: E402
from repro.obs import spans as JS  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import report as RPT  # noqa: E402
from repro_torch.obs import spans as S  # noqa: E402
from repro_torch.obs import timing as TM  # noqa: E402


def _make_spans(mod, tree, t0=0):
    """A synthetic span list from [(name, dur_ns, children), ...]."""
    spans, clock = [], [t0]

    def emit(nodes, depth, parent):
        for name, dur, children in nodes:
            idx = len(spans)
            start = clock[0]
            spans.append(mod.Span(name=name, start_ns=start, dur_ns=dur,
                                  depth=depth, parent=parent, tid=1))
            emit(children, depth + 1, idx)
            clock[0] = start + dur
    emit(tree, 0, -1)
    return spans


MS = 1_000_000
TREE = [("step", 10 * MS, [("data", 2 * MS, []),
                           ("compute", 5 * MS, [("kernel", 4 * MS, [])])]),
        ("step", 20 * MS, [("data", 3 * MS, []),
                           ("compute", 12 * MS, [("kernel", 10 * MS, [])])]),
        ("open", -1, [])]


def test_recorder_records_nesting_and_durations():
    with S.SpanRecorder() as rec:
        with S.span("outer", step=3):
            with S.span("inner_a"):
                pass
            with S.span("inner_b"):
                pass
    assert [sp.name for sp in rec.spans] == ["outer", "inner_a", "inner_b"]
    outer, a, b = rec.spans
    assert (outer.parent, outer.depth, a.parent, a.depth) == (-1, 0, 0, 1)
    assert outer.args == {"step": 3}
    for child in (a, b):
        assert child.start_ns >= outer.start_ns
        assert (child.start_ns + child.dur_ns
                <= outer.start_ns + outer.dur_ns)
    assert b.start_ns >= a.start_ns + a.dur_ns
    assert S.span_paths(rec.spans) == ["outer", "outer/inner_a",
                                       "outer/inner_b"]


def test_recorder_install_restore_and_noop_when_absent():
    assert S.get_recorder() is None
    handle = S.span("anything", step=1)
    assert handle is S.span("other")              # one shared no-op
    with handle:
        pass
    assert handle.sync("tree") == "tree"
    outer = S.SpanRecorder()
    with outer:
        inner = S.SpanRecorder()
        with inner:
            assert S.get_recorder() is inner
            with S.span("x"):
                pass
        assert S.get_recorder() is outer          # restored, not cleared
    assert S.get_recorder() is None
    assert [sp.name for sp in inner.spans] == ["x"] and outer.spans == []


def test_end_tolerates_unclosed_children():
    rec = S.SpanRecorder()
    i_outer = rec.begin("outer")
    rec.begin("leaked")
    rec.end(i_outer)
    assert rec.spans[1].dur_ns >= 0 and rec._stack() == []
    i2 = rec.begin("next")
    rec.end(i2)
    assert rec.spans[-1].parent == -1


def test_aggregate_and_exports_equal_the_jax_package():
    """Same span list -> the same stats, Chrome trace and JSONL rows."""
    mine, ref = _make_spans(S, TREE), _make_spans(JS, TREE)
    agg, jagg = S.aggregate(mine), JS.aggregate(ref)
    assert set(agg) == set(jagg) == {"step", "step/data", "step/compute",
                                     "step/compute/kernel", "open"}
    for path in agg:
        a, b = agg[path].__dict__, jagg[path].__dict__
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12), (path, k)
    assert agg["step/compute"].pct_of_parent == pytest.approx(17 / 30)
    assert agg["open"].total_ms == 0.0
    assert S.to_chrome_trace(mine, "p") == JS.to_chrome_trace(ref, "p")
    assert S.to_records(mine) == JS.to_records(ref)


def test_report_matches_the_jax_report(tmp_path, capsys):
    rows = [{"name": "train.step", "step": i, "step_time_ms": 10.0 + i,
             "phase_data_ms": 1.0, "phase_step_ms": 8.0 + i,
             "phase_metrics_ms": 0.5} for i in range(6)]
    with S.SpanRecorder() as rec:
        with S.span("step", step=0):
            with S.span("phase"):
                pass
    rows += rec.to_records()
    path = tmp_path / "m.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    doc = RPT.report([str(path)], top=2, trace_out=str(tmp_path / "t.json"))
    jdoc = JRPT.report([str(path)], top=2,
                       trace_out=str(tmp_path / "j.json"))
    assert doc == jdoc
    grp = doc["groups"]["train.step"]
    assert grp["coverage"] == pytest.approx(sum(9.5 + i for i in range(6))
                                            / sum(10.0 + i for i in range(6)))
    tr = json.load(open(tmp_path / "t.json"))
    jtr = json.load(open(tmp_path / "j.json"))
    assert tr["traceEvents"][1:] == jtr["traceEvents"][1:]
    assert tr["traceEvents"][0]["args"]["name"] == "repro_torch.obs.report"
    capsys.readouterr()
    assert RPT.main([str(path), "--top", "1"]) == 0
    assert "phase coverage" in capsys.readouterr().out
    assert RPT.main([str(tmp_path / "missing.jsonl")]) == 2


def test_threaded_spans_attribute_to_own_stacks():
    import threading
    rec = S.SpanRecorder()
    prev = S.set_recorder(rec)
    gate = threading.Barrier(3)
    try:
        def work(tag):
            gate.wait(timeout=10)
            with S.span(f"outer-{tag}"):
                with S.span(f"inner-{tag}"):
                    pass
        ts = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
    finally:
        S.set_recorder(prev)
    inners = [p for p in S.span_paths(rec.spans) if "inner" in p]
    assert sorted(inners) == [f"outer-{i}/inner-{i}" for i in range(3)]
    assert len({sp.tid for sp in rec.spans}) == 3


def test_block_span_and_save(tmp_path):
    with S.SpanRecorder() as rec:
        with S.span("x", block=True) as sp:
            assert sp.sync(5) == 5
    doc = json.load(open(rec.save(str(tmp_path / "d" / "trace.json"))))
    assert doc["traceEvents"][0]["args"]["name"] == "repro_torch"
    assert doc["traceEvents"][1]["name"] == "x"


# ------------------------------------------------------------------ timing

def test_trace_scope_is_free_without_a_profiler_and_named_within_one():
    assert TM.trace_scope("a") is TM.trace_scope("b")      # shared no-op
    with TM.trace_scope("a"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TM.trace_scope("consensus.mix_uniform"):
            torch.ones(4).sum()
        with TM.annotate("checkpoint_save", step=2):
            pass
        with TM.step_annotation("train", 7):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"consensus.mix_uniform", "checkpoint_save[step=2]",
            "train#7"} <= names


def test_ops_and_consensus_carry_the_jax_scope_names():
    from repro_torch.core import consensus as C
    from repro_torch.core import graph as G
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.kernels import ops
    x = {"w": torch.ones(4, 3), "b": torch.zeros(4)}
    W = G.metropolis_weights(G.ring(4, directed=False))
    seq = FaultSchedule(link_drop=0.5).compile(G.complete(4), 2).W_seq
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        C.mix_stacked(x, G.uniform_weights(G.complete(4)))
        C.mix_stacked(x, W)
        C.mix_time_varying(x, torch.as_tensor(seq, dtype=torch.float32), 1)
        C.mix_hierarchical(x, G.uniform_weights(G.complete(2)),
                           G.uniform_weights(G.complete(2)), 0)
        ops.frodo_update(torch.ones(3), torch.zeros(4, 3), 0,
                         torch.ones(4), 0.1, 0.1)
        ops.frodo_expsum_update(torch.ones(3), torch.zeros(2, 3),
                                torch.ones(2), torch.ones(2), 0.1, 0.1)
    names = {e.key for e in prof.key_averages()}
    assert {"consensus.mix_uniform", "consensus.mix_general",
            "consensus.mix_time_varying", "consensus.mix_hierarchical",
            "pallas.frodo_exact_update",
            "pallas.frodo_expsum_update"} <= names


def test_step_timer_matches_the_jax_counters(monkeypatch):
    from repro.obs import timing as JTM
    ticks = []
    for mod in (TM, JTM):
        clock = iter([0.0, 0.010, 0.030])       # reset, tick, tick
        monkeypatch.setattr(mod.time, "perf_counter",
                            lambda clock=clock: next(clock))
        t = mod.StepTimer(items_per_step=100)
        t.tick()
        t.tick()
        ticks.append((t.counters(), t.ema_step_time_ms, t.steps))
        monkeypatch.undo()
    assert ticks[0] == ticks[1]
    assert ticks[0][0]["step_time_ms"] == pytest.approx(20.0)


def test_profile_window_writes_a_trace(tmp_path):
    win = TM.ProfileWindow(str(tmp_path / "prof"), start=1, stop=2)
    for i in range(4):
        win.maybe_start(i)
        torch.ones(8).sum()
        win.maybe_stop(i)
    win.close()
    trace = json.load(open(win.trace_path))
    assert "traceEvents" in trace
    assert win.profiler is not None
    assert TM.ProfileWindow(None).trace_path is None


# ------------------------------------------- loop, trainer and launcher

def test_loop_run_emits_host_spans():
    from repro_torch.core import graph as G, loop
    from repro_torch.core.frodo import FrodoConfig, frodo

    def obj(x, i):
        return 0.5 * torch.sum(x ** 2) * (1.0 + 0.0 * i)

    W = G.xiao_boyd_weights(G.complete(3))
    x0 = torch.ones((3, 2))
    opt = frodo(FrodoConfig(alpha=0.1, beta=0.05, lam=0.15, T=8))
    with S.SpanRecorder() as rec:
        plain = loop.run(obj, x0, opt, W, 3)
    assert S.span_paths(rec.spans) == ["loop.run", "loop.run/loop.execute",
                                       "loop.run/loop.drain"]
    assert rec.spans[0].args == {"agents": 3, "rounds": 3}
    agg = S.aggregate(rec.spans)
    assert agg["loop.run"].total_ms >= agg["loop.run/loop.execute"].total_ms
    # the spans change nothing the loop computes
    again = loop.run(obj, x0, frodo(FrodoConfig(alpha=0.1, beta=0.05,
                                                lam=0.15, T=8)), W, 3)
    np.testing.assert_array_equal(plain["errors"], again["errors"])
    np.testing.assert_array_equal(plain["f"], again["f"])


def test_launcher_spans_and_phase_columns(tmp_path):
    from repro_torch.launch.train import run_training
    spans, metrics = tmp_path / "spans.json", tmp_path / "m.jsonl"
    run_training(smoke=True, steps=2, seq=16, batch_per_agent=1,
                 device="cpu", spans_out=str(spans),
                 metrics_out=str(metrics))
    events = json.load(open(spans))["traceEvents"]
    names = [e["name"] for e in events[1:]]
    assert names == ["train.step", "train.data", "train.device_step",
                     "train.metrics"] * 2
    rows = obs.read_jsonl(str(metrics))
    assert len(rows) == 2
    for r in rows:
        phases = r["phase_data_ms"] + r["phase_step_ms"] + \
            r["phase_metrics_ms"]
        assert phases <= r["step_time_ms"] * 1.05 + 1.0
