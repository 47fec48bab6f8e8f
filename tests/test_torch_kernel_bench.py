"""The port's kernel bench (repro_torch.experiments.kernel_bench) on the
CPU, where it runs the plain versions alone at small n: its rows, their
names against the JAX bench's (benchmarks/kernel_bench.py), the bytes each
kernel must move, and the JAX bench's traffic model, equal to the JAX
function's.  The kernel columns stay empty here: they are measured only on
the card (``chip_smoke.py`` prints the card's rows)."""
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.experiments import kernel_bench as B  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_bench", os.path.join(ROOT, "benchmarks",
                                         "kernel_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cpu_rows():
    rows = B.rows("cpu", reps=2)
    assert [r["name"] for r in rows] == [
        f"frodo_{k}_n{n}" for n in B.CPU_N for k in ("exact", "expsum")]
    for r in rows:
        n = r["n"]
        assert r["device"] == "cpu" and r["us_plain_host"] > 0
        assert r["us_events"] is r["us_device"] is r["us_plain"] is None
        assert "gb_per_s" not in r
        if r["kernel"] == "exact":
            assert r["kernel_bytes"] == (r["T"] + 3) * n * 4
        else:
            assert r["kernel_bytes"] == 2 * n * 4 + 2 * r["K"] * n * 4
        assert r["jax_rows"] == [f"frodo_{r['kernel']}_jnp_n{n}",
                                 f"frodo_{r['kernel']}_pallas_n{n}(interp)"]


def test_traffic_model_and_sizes_are_the_jax_bench_s():
    J = jax_bench()
    for n in B.SMALL_N + B.CPU_N:
        assert B.traffic_model(n, T=32) == J.traffic_model(n, T=32)
        assert B.traffic_model(n, K=8) == J.traffic_model(n, K=8)
    assert B.SMALL_N == (1 << 14, 1 << 17)
    assert B.expsum_bytes(10, 8, 2, 4) == 2 * 10 * 2 + 2 * 8 * 10 * 4
    assert B.full_width_shape("qwen3-moe-30b-a3b") == (2, 1, 128, 2048, 768)
    assert B.full_width_shape("h2o-danube-1.8b") == (2, 8, 2560, 6912)


def test_cli_on_the_cpu(capsys):
    B.main(["--device", "cpu", "--reps", "1"])
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(rows) == 2 * len(B.CPU_N)


def _vs_plain_case(kernel, dtype, fault=None):
    """``B.vs_plain`` on the CPU with the plain version in the kernel's
    place, or that stand-in with a fault: one delta element 50% off at the
    largest |delta|, or one bit of the new state flipped."""
    from repro_torch.core import memory as fmem
    from repro_torch.kernels import ref

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    g = torch.randn(3000, generator=gen).to(dt)
    if kernel == "exact":
        state = torch.randn((B.T_SLOTS, 3000), generator=gen).to(dt)
        coef = (torch.tensor(fmem.mu_weights(B.T_SLOTS, 0.15),
                             dtype=torch.float32), 3)

        def plain(st):
            return ref.frodo_update_ref(g, st, coef[1], coef[0], B.ALPHA,
                                        B.BETA)
    else:
        state = torch.randn((B.K_ACC, 3000), generator=gen).to(dt)
        rates, coeffs = fmem.fit_expsum(90, 0.15, B.K_ACC)
        coef = (torch.tensor(rates, dtype=torch.float32),
                torch.tensor(coeffs, dtype=torch.float32))

        def plain(st):
            return ref.frodo_expsum_update_ref(g, st, coef[0], coef[1],
                                               B.ALPHA, B.BETA)

    def kern():
        d, st = plain(state)
        if fault == "delta":
            d.view(-1)[d.float().abs().argmax()] *= 1.5
        elif fault == "state":
            bits = st.view({2: torch.int16, 4: torch.int32}[st.element_size()])
            bits.view(-1)[7] ^= 1
        return d

    return B.vs_plain(kernel, g, state, coef, plain, kern)


@pytest.mark.parametrize("kernel", ["exact", "expsum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vs_plain_passes_the_plain_version_and_fails_its_faults(kernel,
                                                                dtype):
    """The check the bench makes on the card, each kernel against its plain
    version: the plain version passes it (delta equal, state bit-equal),
    and every planted fault (M 10% high, c_0 10% high or the slot weights
    off by one, and in bf16 truncation for rounding) fails the delta
    tolerance on its own."""
    out = _vs_plain_case(kernel, dtype)
    assert out["state"] == "bit-equal" and out["delta_max_abs_err"] == 0.0
    want = {"beta_M_x1.1", "c0_x1.1" if kernel == "expsum"
            else "slot_weights_off_by_one"}
    if dtype == "bfloat16":
        want.add("truncation")
    assert set(out["planted"]) == want
    tol = B.DELTA_TOL[dtype]
    for r in out["planted"].values():
        assert (r["elements_past_tol"] > 0
                or r["share_differing"] > tol["max_share_differing"])


@pytest.mark.parametrize("fault", ["delta", "state"])
@pytest.mark.parametrize("kernel,dtype", [("exact", "bfloat16"),
                                          ("expsum", "float32")])
def test_vs_plain_raises_on_a_wrong_kernel(kernel, dtype, fault):
    with pytest.raises(RuntimeError, match="kernel vs plain version"):
        _vs_plain_case(kernel, dtype, fault)


def test_delta_diff_counts_in_chunks(monkeypatch):
    """The chunked count equals one pass over the whole tensor."""
    a = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    b = a.clone()
    b[::10] *= 1.01
    whole = B.delta_diff(a, b, B.DELTA_TOL["float32"])
    monkeypatch.setattr(B, "CHECK_CHUNK", 64)
    assert B.delta_diff(a, b, B.DELTA_TOL["float32"]) == whole
    assert whole["elements_past_tol"] == 100 and not whole["passes"]
    assert B.bit_equal(a, a.clone()) and not B.bit_equal(a, b)
