"""repro_torch.kernels.ops on the CPU (the kernels' plain versions) against
the JAX package's repro.kernels.ops (the Pallas kernels, in interpret mode
on the CPU, as tests/test_kernels.py runs them).

Tolerances are tests/test_kernels.py's: delta f32 rtol 1e-5 / atol 1e-6,
bf16 2e-2; the pushed exact history bit-equal; new exp-sum accumulators
rtol/atol 1e-5 in f32 and 2e-2 in bf16.  The CUDA kernels themselves are
held against the same plain versions on the card by chip_smoke.py."""
import ctypes
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import memory as jmem  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import frodo_update as KU  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(128,), (1000,), (64, 33), (7,), (3, 5, 11), (2048,), (1,)]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-6)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(j):
    return tensor_from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_exact_update_matches_pallas(shape, name):
    rng = np.random.default_rng(sum(shape) * 3 + len(name))
    T = 9
    g = jnp.asarray(rng.normal(size=shape), DTYPES[name])
    hist = jnp.asarray(rng.normal(size=(T,) + shape), DTYPES[name])
    w = jmem.mu_weights(T, 0.15)
    jw, tw = jnp.asarray(w, jnp.float32), torch.tensor(w, dtype=torch.float32)
    before = dict(tops.LAUNCHES)
    for cursor in (0, 3, T - 1):
        d1, h1 = jops.frodo_update(g, hist, jnp.int32(cursor), jw, 0.8, 0.35)
        th = _t(hist)
        d2, h2 = tops.frodo_update(_t(g), th, cursor, tw, 0.8, 0.35)
        assert h2 is th and d2.dtype == th.dtype
        np.testing.assert_allclose(_f32(d2), _f32(d1), **_tol(name))
        np.testing.assert_array_equal(_f32(h2), _f32(h1))
    assert tops.LAUNCHES == before          # the CPU takes the plain version


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("acc_name", list(DTYPES))
@pytest.mark.parametrize("g_name", list(DTYPES))
def test_expsum_update_matches_pallas(shape, g_name, acc_name):
    rng = np.random.default_rng(sum(shape) + 11 * len(g_name)
                                + 13 * len(acc_name))
    K = 6
    g = jnp.asarray(rng.normal(size=shape), DTYPES[g_name])
    acc = jnp.asarray(rng.normal(size=(K,) + shape), DTYPES[acc_name])
    r, c = jmem.fit_expsum(40, 0.15, K)
    before = dict(tops.LAUNCHES)
    d1, a1 = jops.frodo_expsum_update(g, acc, jnp.asarray(r, jnp.float32),
                                      jnp.asarray(c, jnp.float32), 0.8, 0.35)
    ta = _t(acc)
    d2, a2 = tops.frodo_expsum_update(
        _t(g), ta, torch.tensor(r, dtype=torch.float32),
        torch.tensor(c, dtype=torch.float32), 0.8, 0.35)
    assert a2 is ta and a2.dtype == ta.dtype and d2.dtype == _t(g).dtype
    np.testing.assert_allclose(_f32(d2), _f32(d1), **_tol(g_name))
    acc_tol = _tol("bfloat16") if acc_name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(a2), _f32(a1), **acc_tol)
    assert tops.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors only; ops routes by the
    tensor's device and refuses devices that are neither."""
    g, h = torch.zeros(4), torch.zeros((3, 4))
    w = torch.ones(3)
    with pytest.raises(ValueError, match="not CUDA"):
        KU.exact_update(g, h, 0, w, 0.1, 0.1)
    with pytest.raises(ValueError, match="not CUDA"):
        KU.expsum_update(g, h, torch.ones(3), torch.ones(3), 0.1, 0.1)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.frodo_update(meta, torch.zeros((3, 4), device="meta"), 0, w,
                          0.1, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.frodo_expsum_update(meta, torch.zeros((3, 4), device="meta"),
                                 w, w, 0.1, 0.1)


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel modules compiles and loads nothing."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import repro_torch.kernels.ops as o, "
            "repro_torch.kernels.frodo_update as k; "
            "assert k._lib is None; print(sorted(o.LAUNCHES))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "frodo_exact_update" in out.stdout


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(KU.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(KU, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KU.build()


def test_library_name_is_keyed_by_source_hash():
    p = KU.library_path()
    assert p.parent == KU.BUILD_DIR and p.name.startswith("libfrodo_update_")
    assert KU.BUILD_DIR.relative_to(ROOT).parts == ("build", "repro_torch")


@pytest.mark.parametrize("acc_name", list(DTYPES))
@pytest.mark.parametrize("shape", [(7,), (64, 33)])
@pytest.mark.parametrize("K", [1, 4, 8, 16])
def test_expsum_update_matches_pallas_at_every_k(K, shape, acc_name):
    """The plain exp-sum version (what the CUDA kernel is held to on the
    card) at the K the kernel instantiates at its ends and in between, at a
    tail shape (7,: the kernel's scalar path) and at (64, 33)."""
    rng = np.random.default_rng(100 * K + sum(shape) + len(acc_name))
    g = jnp.asarray(rng.normal(size=shape), jnp.float32)
    acc = jnp.asarray(rng.normal(size=(K,) + shape), DTYPES[acc_name])
    r, c = jmem.fit_expsum(90, 0.15, K)
    d1, a1 = jops.frodo_expsum_update(g, acc, jnp.asarray(r, jnp.float32),
                                      jnp.asarray(c, jnp.float32), 0.02, 0.008)
    d2, a2 = tops.frodo_expsum_update(
        _t(g), _t(acc), torch.tensor(r, dtype=torch.float32),
        torch.tensor(c, dtype=torch.float32), 0.02, 0.008)
    np.testing.assert_allclose(_f32(d2), _f32(d1), **_tol("float32"))
    acc_tol = _tol("bfloat16") if acc_name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(a2), _f32(a1), **acc_tol)


@pytest.mark.parametrize("K", [1, 3, 16])
def test_expsum_weights_are_packed_as_the_kernel_takes_them(K):
    rates = torch.linspace(0.5, 0.9, K)
    coeffs = torch.linspace(-1.0, 2.0, K, dtype=torch.float64)
    w = KU.pack_expsum_weights(rates, coeffs)
    assert ctypes.sizeof(w) == 2 * 16 * 4          # float r[16], c[16]
    assert list(w.r) == rates.tolist() + [0.0] * (16 - K)
    assert list(w.c) == coeffs.float().tolist() + [0.0] * (16 - K)


@pytest.mark.parametrize("K", [0, 17])
def test_expsum_weights_refuse_k_out_of_range(K):
    with pytest.raises(ValueError, match=f"K={K} not in 1..16"):
        KU.pack_expsum_weights(torch.ones(K), torch.ones(K))


def test_expsum_weights_are_packed_once_per_pair_of_tensors():
    rates, coeffs = torch.full((4,), 0.5), torch.ones(4)
    first = KU._packed(rates, coeffs)
    assert KU._packed(rates, coeffs) is first       # cached: same struct
    rates[0] = 0.25                                  # a new version
    again = KU._packed(rates, coeffs)
    assert again.r[0] == 0.25


@pytest.mark.parametrize("acc_name", list(DTYPES))
@pytest.mark.parametrize("g_name", list(DTYPES))
def test_expsum_entry_for_each_dtype_pair(g_name, acc_name):
    tag = {"float32": "f32", "bfloat16": "bf16"}
    g_dt, acc_dt = getattr(torch, g_name), getattr(torch, acc_name)
    assert KU.expsum_entry(g_dt, acc_dt) == \
        f"frodo_expsum_update_{tag[g_name]}_{tag[acc_name]}"
    with pytest.raises(ValueError, match="not f32/bf16"):
        KU.expsum_entry(g_dt, torch.float16)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__ac22f7fe_15_frodo_update_cu_c63301c920expsum_update_kernelI13__nv_bfloat16S1_Li15EEEvPKT_PT0_PS2_NS_13ExpsumWeightsExxff' for 'sm_90a'
    16 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__ac22f7fe_15_frodo_update_cu_c63301c920expsum_update_kernelI13__nv_bfloat16fLi1EEEvPKT_PT0_PS2_NS_13ExpsumWeightsExxff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 36 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__ac22f7fe_15_frodo_update_cu_c63301c919exact_update_kernelIfEEvPKT_PS1_S4_PKfixiffi' for 'sm_90a'
ptxas info    : Used 42 registers, used 1 barriers
"""


def test_ptxas_registers_name_each_instantiation():
    regs, spills = KU.ptxas_registers(PTXAS_LOG)
    assert regs == {"expsum<bf16,bf16,K=15>": 128, "expsum<bf16,f32,K=1>": 36,
                    "exact<f32>": 42}
    assert spills == {"expsum<bf16,bf16,K=15>": 20}
