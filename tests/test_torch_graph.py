"""The port's own copies of numpy code (core.graph, data.synthetic), its
metrics layer (obs.metrics) and convert.py, against the JAX package.

The numpy copies must be bit-equal; the torch metrics use f32 rtol 1e-6."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.obs import metrics as jm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402

TOPOLOGIES = {
    "complete5": lambda m: m.complete(5),
    "ring6": lambda m: m.ring(6),
    "ring6_undirected": lambda m: m.ring(6, directed=False),
    "torus3x3": lambda m: m.torus2d(3, 3),
    "hypercube3": lambda m: m.hypercube(3),
    "star5": lambda m: m.star(5),
    "random7": lambda m: m.random_strongly_connected(7, 0.3, seed=4),
}


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_graph_copy_is_bit_equal(name):
    A, Aj = TOPOLOGIES[name](tg), TOPOLOGIES[name](jg)
    np.testing.assert_array_equal(A, Aj)
    assert tg.is_strongly_connected(A) == jg.is_strongly_connected(A)
    for fn in ("uniform_weights", "metropolis_weights"):
        Wt, Wj = getattr(tg, fn)(A), getattr(jg, fn)(A)
        np.testing.assert_array_equal(Wt, Wj)
        assert tg.sigma(Wt) == jg.sigma(Wj)
        assert tg.dobrushin(Wt) == jg.dobrushin(Wj)
    W = tg.metropolis_weights(A)
    seq = np.stack([W, tg.uniform_weights(A), W])
    np.testing.assert_array_equal(tg.window_product(seq, 0, 3),
                                  jg.window_product(seq, 0, 3))
    np.testing.assert_array_equal(tg.windowed_sigma(seq, 2),
                                  jg.windowed_sigma(seq, 2))
    assert tg.is_b_strongly_connected(seq, 2) \
        == jg.is_b_strongly_connected(seq, 2)
    np.testing.assert_array_equal(tg.xiao_boyd_weights(tg.complete(4)),
                                  jg.xiao_boyd_weights(jg.complete(4)))
    np.testing.assert_array_equal(
        tg.hierarchical_weights(W[:2, :2], W), jg.hierarchical_weights(
            W[:2, :2], W))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_copy_is_bit_equal(seed):
    for a, b in zip(tsyn.make_classification(5, 3, seed=seed, noise=2.0),
                    jsyn.make_classification(5, 3, seed=seed, noise=2.0)):
        np.testing.assert_array_equal(a, b)
    X, y = tsyn.make_classification(5, 2, seed=seed)
    for bt, bj, _ in zip(tsyn.minibatches(X, y, 4, seed),
                         jsyn.minibatches(X, y, 4, seed), range(3)):
        for k in ("x", "y"):
            np.testing.assert_array_equal(bt[k], bj[k])


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    jt = {"a": jnp.asarray(rng.normal(size=(3, 4)), jnp.float32),
          "b": {"c": jnp.asarray(rng.normal(size=(3, 2, 2)), jnp.bfloat16)}}
    tt = convert.params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    for fn in ("tree_sq_sum", "global_norm", "consensus_error"):
        np.testing.assert_allclose(float(getattr(tm, fn)(tt)),
                                   float(getattr(jm, fn)(jt)), rtol=1e-6)
    pack = tm.frodo_step_metrics(tt, tt, tt)
    assert set(pack) == set(jm.frodo_step_metrics(jt, jt, jt))
    zeros = tm.zeros_like_metrics(pack)
    assert all(v.dtype == torch.float32 and v.dim() == 0
               for v in zeros.values())
    assert float(tm.global_norm({})) == 0.0


def test_sinks_and_scalarize(tmp_path):
    path = str(tmp_path / "sub" / "m.jsonl")
    with tm.JsonlSink(path) as sink:
        sink.write({"step": 0, "loss": torch.tensor(1.5),
                    "vec": torch.ones(3), "n": np.int64(4), "s": "x"})
    with open(path, "a") as f:
        f.write('{"torn": \n')
    rows = tm.read_jsonl(path)
    assert rows == [{"step": 0, "loss": 1.5, "n": 4, "s": "x"}]
    assert rows.n_skipped == 1
    with pytest.raises(ValueError):
        tm.read_jsonl(path, strict=True)
    mem = tm.MemorySink()
    mem.write({"a": 1})
    assert mem.records == [{"a": 1}]
    for s in (mem, tm.NullSink(), tm.JsonlSink(str(tmp_path / "n.jsonl"))):
        assert isinstance(s, tm.MetricsSink)
        s.close()


def test_convert_is_bit_exact_for_bf16():
    j = jnp.asarray(np.random.default_rng(1).normal(size=(5, 3)),
                    jnp.bfloat16)
    t = convert.tensor_from_numpy(np.asarray(j), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))
    st = convert.frodo_state_from_numpy(
        {"step": np.int32(3), "acc": {"w": np.asarray(j)}}, "cpu")
    assert st["step"] == 3 and isinstance(st["step"], int)
    assert torch.equal(st["acc"]["w"], t)
