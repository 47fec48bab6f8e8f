"""repro_torch.core.faults and the fault branch of repro_torch.core.loop.run
against the JAX package (repro.core.faults, repro.core.loop.run).

* Compiled schedules: every array bit-equal (plain numpy on both sides).
* ``loop.run(faults=...)``: the Exp 1 quadratic (4 agents), 40 rounds, every
  per-round trace within rtol 1e-5 / atol 1e-6 (f32 on both sides, the same
  masked W_t; sums in another order, ~1e-7 relative per round); fault
  counters equal.
* Equivalences on the port alone: identity mixing byte-exact, drop 1.0 is
  the local-only loop, drop 0 the healthy loop."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import loop as jl  # noqa: E402
from repro.core.frodo import FrodoConfig as JCfg  # noqa: E402
from repro.core.frodo import frodo as jfrodo  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import consensus as tc  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import loop as tl  # noqa: E402
from repro_torch.core.frodo import FrodoConfig as TCfg  # noqa: E402
from repro_torch.core.frodo import Optimizer  # noqa: E402
from repro_torch.core.frodo import frodo as tfrodo  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CENTERS = np.asarray([[2, 0], [-2, 0], [0, 2], [0, -2]], np.float32)
X0 = np.asarray([[1, 0], [0.86, 0.5], [0.5, 0.86], [0, 1]], np.float32)
_TC = torch.from_numpy(CENTERS)


def jobj(x, i):
    d = x - jnp.asarray(CENTERS)[i]
    return 0.5 * d[0] ** 2 + 0.005 * d[1] ** 2


def tobj(x, i):
    d = x - _TC[i]
    return 0.5 * d[0] ** 2 + 0.005 * d[1] ** 2


def _crashes(mod):
    return (mod.CrashWindow(agent=1, start=3, stop=9),
            mod.CrashWindow(agent=3, start=20, stop=24))


# name -> (schedule kwargs, adjacency, weight function name)
SCENARIOS = {
    "directed_drop30": (dict(link_drop=0.3, seed=4), "complete4",
                        "xiao_boyd_weights"),
    "symmetric_drop30": (dict(link_drop=0.3, seed=4, drop_mode="symmetric"),
                         "complete4", "xiao_boyd_weights"),
    "straggler_crash_jitter": (dict(link_drop=0.2, straggler_frac=0.25,
                                    jitter_ms=2.0, seed=9, crashes=True),
                               "complete4", "uniform_weights"),
    "symmetric_ring_crash": (dict(link_drop=0.4, straggler_frac=0.25,
                                  seed=1, drop_mode="symmetric",
                                  crashes=True),
                             "ring4", "metropolis_weights"),
}
ADJ = {"complete4": G.complete(4), "ring4": G.ring(4, directed=False)}


def _compile(mod, name, K):
    kw, adj, wfn = SCENARIOS[name]
    kw = dict(kw)
    if kw.pop("crashes", False):
        kw["crashes"] = _crashes(mod)
    graph = jg if mod is jf else G
    return mod.FaultSchedule(**kw).compile(ADJ[adj], K,
                                           weight_fn=getattr(graph, wfn))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_compiled_arrays_are_bit_equal(name):
    j, t = _compile(jf, name, 30), _compile(tf, name, 30)
    assert t.schedule == _compile(tf, name, 30).schedule
    for field in ("W_base", "W_seq", "update_mask", "links_dropped",
                  "agents_isolated", "jitter_ms", "staleness"):
        a, b = getattr(j, field), getattr(t, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert j.steps_degraded().tobytes() == t.steps_degraded().tobytes()
    ja, ta = j.counter_arrays(), t.counter_arrays()
    assert list(ja) == list(ta) == list(tf.FAULT_COUNTER_NAMES)
    for k in ja:
        assert ja[k].tobytes() == ta[k].tobytes(), k
    for k in (0, 5, 29):
        assert j.counters(k) == t.counters(k)
    assert (t.n_steps, t.n_agents) == (j.n_steps, j.n_agents)
    for B in (1, 3):
        assert t.validate(B) == j.validate(B)


def test_masking_functions_and_validation_match():
    rng = np.random.default_rng(0)
    W = G.metropolis_weights(G.complete(5))
    keep = (rng.random((5, 5)) > 0.4).astype(np.float64)
    keep = np.minimum(keep, keep.T)
    for fn in ("mask_and_renormalize", "mask_and_absorb"):
        (jw, ji), (tw, ti) = (getattr(m, fn)(W, keep) for m in (jf, tf))
        assert jw.tobytes() == tw.tobytes() and ji.tobytes() == ti.tobytes()
    for kw in (dict(link_drop=1.5), dict(straggler_frac=1.0),
               dict(jitter_ms=-1.0), dict(drop_mode="bogus")):
        with pytest.raises(ValueError):
            tf.FaultSchedule(**kw)
    with pytest.raises(ValueError, match="nonnegative"):
        tf.FaultSchedule(link_drop=0.1).compile(
            G.star(6), 4, weight_fn=G.xiao_boyd_weights)
    with pytest.raises(ValueError, match="symmetric base W"):
        tf.FaultSchedule(link_drop=0.2, drop_mode="symmetric").compile(
            G.ring(4, directed=True), 4)
    with pytest.raises(ValueError, match="crash window"):
        tf.CrashWindow(agent=0, start=3, stop=3)


FRODO = dict(alpha=0.8, beta=0.35, lam=0.15, T=20)
OPTS = {
    "gd": (lambda: jb.no_memory(0.8), lambda: tb.no_memory(0.8)),
    "heavy_ball": (lambda: jb.heavy_ball(0.8, 0.35),
                   lambda: tb.heavy_ball(0.8, 0.35)),
    "frodo": (lambda: jfrodo(JCfg(**FRODO)), lambda: tfrodo(TCfg(**FRODO))),
    "frodo_kernel": (lambda: jfrodo(JCfg(**FRODO)),
                     lambda: tfrodo(TCfg(**FRODO, use_kernel=True))),
}


@pytest.mark.parametrize("name", ["directed_drop30", "symmetric_drop30",
                                  "straggler_crash_jitter"])
@pytest.mark.parametrize("oname", list(OPTS))
def test_fault_loop_matches_jax(oname, name):
    """The same compiled schedule through both loops; the port's FrODO
    with ``use_kernel=True`` takes the kernel's plain version here."""
    K = 40
    jopt, topt = (f() for f in OPTS[oname])
    jr = jl.run(jobj, jnp.asarray(X0), jopt, None, K, x_star=jnp.zeros(2),
                faults=_compile(jf, name, 25), collect_metrics=True)
    tr = tl.run(tobj, torch.from_numpy(X0), topt, None, K,
                x_star=np.zeros(2, np.float32),
                faults=_compile(tf, name, 25), collect_metrics=True)
    assert set(tr) == set(jr)
    for k in ("errors", "f", "consensus_error", "consensus_error_pre_mix"):
        assert tr[k].shape == (K,)
        np.testing.assert_allclose(tr[k], jr[k], **TOL, err_msg=k)
    for k in tf.FAULT_COUNTER_NAMES:            # cycled past the horizon
        assert tr[k].tobytes() == jr[k].tobytes(), k
    np.testing.assert_allclose(tr["x"].numpy(), np.asarray(jr["x"]), **TOL)


def test_masked_gradient_lands_in_memory_as_zero():
    """A crashed agent pushes zeros into its exact-memory slots, kernel path
    and plain path alike, and its state does not move."""
    faults = tf.FaultSchedule(crashes=(tf.CrashWindow(1, 0, 50),)).compile(
        G.complete(4), 10)
    for use_kernel in (False, True):
        opt = tfrodo(TCfg(**FRODO, use_kernel=use_kernel))
        seen = {}

        def spy_init(p, _init=opt.init):
            seen["state"] = _init(p)
            return seen["state"]
        spy = Optimizer(spy_init, opt.update)
        out = tl.run(tobj, torch.from_numpy(X0), spy, None, 6,
                     faults=faults)
        hist = seen["state"]["hist"]
        assert torch.count_nonzero(hist[:, 1]) == 0
        assert torch.count_nonzero(hist[:5, 0]) > 0
        np.testing.assert_array_equal(out["x"][1].numpy(), X0[1])


def test_identity_mixing_is_byte_exact():
    c = tf.FaultSchedule(link_drop=1.0, seed=0).compile(G.complete(4), 6)
    x = {"w": torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 7)).astype(np.float32)), "b": torch.randn(4, 3)}
    W_seq = torch.as_tensor(c.W_seq, dtype=torch.float32)
    for k in range(9):                           # wraps past the horizon
        for seq in (c.W_seq, W_seq):
            out = tc.mix_time_varying(x, seq, k)
            for n in x:
                assert out[n].numpy().tobytes() == x[n].numpy().tobytes()


def _run_pair(method, sched, W_plain, K=15):
    """The same run with ``sched`` and with the fixed ``W_plain``."""
    x0 = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3)).astype(np.float32))

    def quad(x, i):
        return 0.5 * torch.sum((x - i) ** 2)

    def opt():
        if method == "frodo":
            return tfrodo(TCfg(alpha=0.3, beta=0.1, lam=0.15, T=5))
        return tb.no_memory(0.3)

    faulted = tl.run(quad, x0, opt(), None, K,
                     faults=sched.compile(G.complete(4), K))
    return faulted, tl.run(quad, x0, opt(), W_plain, K)


@pytest.mark.parametrize("method", ["gd", "frodo"])
def test_all_links_dropped_equals_local_only(method):
    """drop=1.0 masks every edge: the fault-aware loop is the local-only
    (identity-mixing) loop, bit for bit (the same ops on both sides)."""
    faulted, local = _run_pair(method, tf.FaultSchedule(link_drop=1.0),
                               np.eye(4))
    assert faulted["x"].numpy().tobytes() == local["x"].numpy().tobytes()
    assert faulted["f"].tobytes() == local["f"].tobytes()


def test_drop_zero_equals_healthy_loop():
    """The control arm: an empty schedule runs the healthy W every step.
    The healthy loop takes the mean shortcut, the faulted one the general
    contraction: 1e-6 covers the f32 rounding between the two."""
    faulted, healthy = _run_pair("frodo", tf.FaultSchedule(),
                                 G.uniform_weights(G.complete(4)), K=12)
    np.testing.assert_allclose(faulted["x"].numpy(), healthy["x"].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(faulted["f"], healthy["f"], rtol=1e-6)


def test_loop_reports_fault_counters():
    sched = tf.FaultSchedule(link_drop=0.3, seed=0)
    res = tl.run(tobj, torch.zeros(4, 2), tb.no_memory(0.1), None, 8,
                 faults=sched.compile(G.complete(4), 5),
                 collect_metrics=True)
    for name in tf.FAULT_COUNTER_NAMES:
        assert name in res and res[name].shape == (8,)
        assert res[name].dtype == np.float32
    assert "consensus_error" in res and "consensus_error_pre_mix" in res
