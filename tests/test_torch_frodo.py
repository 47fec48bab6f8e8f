"""repro_torch.core.frodo / baselines against repro.core.frodo / baselines,
step by step on the same numpy gradient stream.

Tolerances: f32 rtol 1e-5 / atol 1e-6 per step (same arithmetic, sums in
another order); bf16 2e-2 (one bf16 rounding is ~4e-3 relative, and XLA and
PyTorch round bf16 intermediates at different places)."""
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro_torch import convert, tree as TR  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import frodo as tf  # noqa: E402

# repro.core re-exports the function ``frodo`` under the module's name
jf = importlib.import_module("repro.core.frodo")

SHAPES = {"a": (3,), "b": {"w": (2, 2)}, "c": (4, 5)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-6)


def _jtree(rng, dtype):
    def mk(s):
        return {k: mk(v) for k, v in s.items()} if isinstance(s, dict) \
            else jnp.asarray(rng.normal(size=s), dtype)
    return mk(SHAPES)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(jtree, ttree, tol):
    jl, tl = jax.tree.leaves(jtree), TR.leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **tol)


def _run_both(jopt, topt, n_steps, dtype="float32", seed=0,
              jstate=None, tstate=None, params=None):
    """Apply both optimizers to the same gradients for n_steps; compare
    every delta, the metrics if any, and the final parameters."""
    rng = np.random.default_rng(seed)
    jp = params if params is not None else _jtree(rng, JDT[dtype])
    tp = convert.params_from_numpy(_np(jp), "cpu")
    js = jstate if jstate is not None else jopt.init(jp)
    ts = tstate if tstate is not None else topt.init(tp)
    for _ in range(n_steps):
        jg = _jtree(rng, JDT[dtype])
        tg = convert.params_from_numpy(_np(jg), "cpu")
        jd, js = jopt.update(jg, js, jp)
        td, ts = topt.update(tg, ts, tp)
        _assert_close(jd, td, _tol(dtype))
        if "metrics" in js:
            for k in tf.METRIC_NAMES:
                np.testing.assert_allclose(float(ts["metrics"][k]),
                                           float(js["metrics"][k]),
                                           **_tol(dtype))
        jp = jf.apply_updates(jp, jd)
        tp = tf.apply_updates(tp, td)
        assert ts["step"] == int(js["step"])
    _assert_close(jp, tp, _tol(dtype))
    return jp, js, tp, ts


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_matches_jax(dtype, use_kernel, collect):
    cfg = dict(alpha=0.3, beta=0.1, lam=0.2, T=5, use_kernel=use_kernel,
               collect_metrics=collect)
    _, _, _, ts = _run_both(jf.frodo(jf.FrodoConfig(**cfg)),
                            tf.frodo(tf.FrodoConfig(**cfg)), 8, dtype)
    assert ("metrics" in ts) == collect


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_expsum_matches_jax(acc_dtype, use_kernel, collect):
    cfg = dict(alpha=0.3, beta=0.1, lam=0.2, T=20, memory_mode="expsum",
               K=6, acc_dtype=acc_dtype, use_kernel=use_kernel,
               collect_metrics=collect)
    _, _, _, ts = _run_both(jf.frodo(jf.FrodoConfig(**cfg)),
                            tf.frodo(tf.FrodoConfig(**cfg)), 6,
                            dtype=acc_dtype)
    assert TR.leaves(ts["acc"])[0].dtype == getattr(torch, acc_dtype)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pad_T_matches_jax(use_kernel):
    """Buffer of 8 slots, weights zero beyond T=5: the cursor wraps at 8."""
    cfg = dict(alpha=0.3, beta=0.1, lam=0.2, T=5, pad_T=8,
               use_kernel=use_kernel)
    _, _, _, ts = _run_both(jf.frodo(jf.FrodoConfig(**cfg)),
                            tf.frodo(tf.FrodoConfig(**cfg)), 11)
    assert TR.leaves(ts["hist"])[0].shape[0] == 8


@pytest.mark.parametrize("name,args", [
    ("no_memory", (0.4,)), ("heavy_ball", (0.3, 0.2)),
    ("nesterov", (0.05,)), ("adam", (1e-2,))])
def test_baselines_match_jax(name, args):
    _run_both(getattr(jb, name)(*args), getattr(tb, name)(*args), 7)
    assert set(tb.REGISTRY) == set(jb.REGISTRY)


@pytest.mark.parametrize("mode,use_kernel,acc_dtype", [
    ("exact", False, "float32"), ("exact", True, "float32"),
    ("expsum", True, "bfloat16")])
def test_continues_from_a_jax_mid_run_state(mode, use_kernel, acc_dtype):
    """JAX runs 7 steps; its state and parameters, carried across by
    convert.py, let the port continue step for step."""
    cfg = dict(alpha=0.3, beta=0.1, lam=0.2, T=5, memory_mode=mode, K=6,
               acc_dtype=acc_dtype, use_kernel=use_kernel)
    jopt = jf.frodo(jf.FrodoConfig(**cfg))
    topt = tf.frodo(tf.FrodoConfig(**cfg))
    jp, js, _, _ = _run_both(jopt, topt, 7, seed=1)
    tstate = convert.frodo_state_from_numpy(_np(js), "cpu")
    assert tstate["step"] == 7
    key = "hist" if mode == "exact" else "acc"
    for j, t in zip(jax.tree.leaves(js[key]), TR.leaves(tstate[key])):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    _run_both(jopt, topt, 5, seed=2, jstate=js, tstate=tstate, params=jp)


def test_first_step_is_pure_gradient():
    opt = tf.frodo(tf.FrodoConfig(alpha=0.5, beta=10.0, lam=0.2, T=4,
                                  use_kernel=True))
    p = {"x": torch.ones(3)}
    delta, _ = opt.update({"x": torch.ones(3)}, opt.init(p), p)
    torch.testing.assert_close(delta["x"], torch.full((3,), -0.5))


def test_memory_bytes_and_config_checks():
    p = convert.params_from_numpy(_np(_jtree(np.random.default_rng(0),
                                             jnp.float32)), "cpu")
    jp = _jtree(np.random.default_rng(0), jnp.float32)
    for cfg in (dict(T=90), dict(T=90, memory_mode="expsum", K=8)):
        assert tf.memory_bytes(p, tf.FrodoConfig(**cfg)) \
            == jf.memory_bytes(jp, jf.FrodoConfig(**cfg))
    for bad in (dict(memory_mode="window"), dict(lam=1.0),
                dict(acc_dtype="float16")):
        with pytest.raises(ValueError):
            tf.FrodoConfig(**bad)
