"""The port's one-card dry-run (repro_torch.launch.dryrun) and roofline
(repro_torch.experiments.roofline) on the CPU.

* ``--all --device cpu`` writes a record for every (arch x shape) pair:
  ``ok`` where the JAX dry-run lowers the pair, ``skipped`` with the JAX
  package's reason where ``shape_supported`` refuses it; the records'
  analytic FLOPs and bytes are the JAX package's formulas.
* The argument bytes counted on meta trees equal the bytes of the same
  inputs allocated for real (smoke configs, both memory modes).
* ``--probe`` on the CPU runs steps at trip counts 2 and 3 and records
  host ms, never a device number; the extrapolation is the JAX dry-run's
  algebra.
* The roofline divides by the H100's constants (no TPU constant left),
  names the card and power limit, and keeps a row per ``ok`` record."""
import inspect
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.launch import dryrun as JDR  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.experiments import roofline as RF  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of tiny ops: one thread is fastest, and keeps the test's
    time when other processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_torch"))
    assert DR.main(["--all", "--device", "cpu", "--out", out]) == 0
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"])] = r
    return out, recs


def test_sweep_statuses_and_skip_reasons_are_the_jax_packages(sweep):
    _, recs = sweep
    assert len(recs) == len(REG.ARCH_IDS) * len(INPUT_SHAPES) == 40
    for arch in REG.ARCH_IDS:
        for name in INPUT_SHAPES:
            r = recs[(arch, name)]
            ok, reason = JREG.shape_supported(JREG.get_config(arch),
                                              JSHAPES[name])
            assert r["status"] == ("ok" if ok else "skipped"), (arch, name)
            assert r.get("reason", "") == reason
            assert r["mesh"] == DR.MESH and r["kind"] == JSHAPES[name].kind
            if not ok:
                continue
            mem = r["memory"]
            assert mem["argument_size_in_bytes"] == sum(
                v for k, v in mem.items() if k != "argument_size_in_bytes")
            assert r["fits"] == (mem["argument_size_in_bytes"] <= 80e9)
            assert "probe" not in r and "device" not in r


def test_records_carry_the_jax_analytic_counts(sweep):
    from repro.utils import flops as JFL
    _, recs = sweep
    for arch, name in (("h2o-danube-1.8b", "train_4k"),
                       ("qwen3-32b", "long_500k"),
                       ("recurrentgemma-9b", "decode_32k")):
        jcfg, jshape = JREG.get_config(arch), JSHAPES[name]
        window = JREG.decode_window(jcfg, jshape) or 0
        ref = JFL.analytic(jcfg, jshape, jshape.kind, window)
        n_agents = DR.N_AGENTS if jshape.kind == "train" else 1
        ref["hbm_bytes"] = JFL.hbm_bytes(jcfg, jshape, jshape.kind,
                                         n_agents, 8, window)
        got = recs[(arch, name)]["analytic"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0)


def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in TR.leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "phi-3-vision-4.2b",
                                  "whisper-tiny", "recurrentgemma-9b"])
@pytest.mark.parametrize("mode", ["expsum", "exact"])
def test_argument_bytes_equal_the_allocated_inputs(arch, mode):
    cfg = REG.get_smoke_config(arch)
    tc = TS.TrainConfig(memory_mode=mode, T=6, K=3, acc_dtype="bfloat16")
    train = InputShape("t", 16, 4, "train")
    got = DR.argument_bytes(cfg, train, tc, 2, None)
    state = TS.init_train_state(torch.Generator().manual_seed(0), cfg, tc, 2,
                                "cpu")
    batch = REG.input_specs(cfg, train, 2)
    assert got["params_bytes"] == got["grads_bytes"] == _bytes(state.params)
    assert got["opt_state_bytes"] == _bytes(state.opt_state)
    assert got["batch_bytes"] == _bytes(batch)
    dec = InputShape("d", 24, 3, "decode")
    got = DR.argument_bytes(cfg, dec, tc, 1, 8)
    assert got["cache_bytes"] == _bytes(D.init_cache(cfg, 3, 24, 8,
                                                     device="cpu"))
    assert got["argument_size_in_bytes"] == (
        got["params_bytes"] + got["cache_bytes"] + got["batch_bytes"])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_on_the_cpu_records_host_time_only(kind, tmp_path):
    shape = InputShape(f"tiny_{kind}", 16, 4 if kind == "train" else 2, kind)
    cfg = REG.get_smoke_config("h2o-danube-1.8b").replace(n_layers=4)
    rec = DR.run_one("h2o-danube-1.8b", shape, str(tmp_path), probes=True,
                     cfg_override=cfg, device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    trips = rec["probe"]["trip_counts"]
    assert set(trips) == {"2", "3"}
    for t in trips.values():
        assert set(t) == {"host_ms"} and t["host_ms"] > 0
    ext = rec["extrapolated"]
    assert set(ext) == {"trip_count", "host_ms"} and ext["trip_count"] == 4
    assert rec["device"] == "cpu"
    assert rec["probe"]["reduced"]["global_batch"] == \
        f"{shape.global_batch} -> {DR.PROBE_BATCH[kind]}"
    assert os.path.exists(tmp_path / f"h2o-danube-1.8b_tiny_{kind}_1xH100"
                                     ".json")


def test_affine_extrapolation_is_the_jax_algebra():
    p2 = {"peak_bytes": 10.0e9, "device_ms": 300.0}
    p3 = {"peak_bytes": 12.5e9, "device_ms": 410.0}
    mine = DR._affine_extrapolate(p2, p3, 24)
    jp = {k: {"cost": {"flops": p["device_ms"],
                       "bytes_accessed": p["peak_bytes"]},
              "collectives": {"bytes_by_kind": {}}} for k, p in
          ((2, p2), (3, p3))}
    ref = JDR._affine_extrapolate(jp[2], jp[3], 24)
    assert mine["device_ms"] == ref["flops"]
    assert mine["peak_bytes"] == ref["bytes_accessed"]
    assert mine["trip_count"] == 24


def test_roofline_uses_the_h100_and_names_the_card(sweep, tmp_path):
    out, recs = sweep
    src = inspect.getsource(RF)
    for tpu in ("197e12", "819e9", "16 * 2 ** 30", "v5e", "ICI", "TPU"):
        assert tpu not in src
    assert (RF.PEAK_FLOPS, RF.HBM_BW, RF.HBM_PER_CARD) == (989.4e12, 3.35e12,
                                                          80e9)
    path = str(tmp_path / "roofline.md")
    text = RF.main(["--dir", out, "--out", path])
    assert open(path).read() == text
    assert text.startswith("Card: NVIDIA H100 80GB HBM3, 700.00 W")
    rows = [l for l in text.splitlines() if l.startswith("| ") and
            "1xH100" in l]
    assert len(rows) == 39
    assert "SKIPPED whisper-tiny x long_500k" in text
    r = recs[("h2o-danube-1.8b", "train_4k")]
    t = RF.roofline_terms(r)
    assert t["t_link_s"] == 0.0
    assert t["t_compute_s"] == r["analytic"]["exec_flops"] / 989.4e12
    assert t["t_memory_s"] == r["analytic"]["hbm_bytes"] / 3.35e12
    assert t["fits_hbm"] is False and t["dominant"] == "compute"
    assert re.search(r"\| h2o-danube-1\.8b \| train_4k \| 1xH100 .*\| N \|",
                     text)


def test_roofline_reads_a_probe_peak():
    rec = {"status": "ok", "arch": "a", "shape": "s", "mesh": "1xH100",
           "kind": "train", "memory": {"argument_size_in_bytes": 60e9},
           "analytic": {"exec_flops": 1e15, "model_flops": 5e14,
                        "hbm_bytes": 1e12},
           "extrapolated": {"peak_bytes": 90e9, "device_ms": 2000.0}}
    t = RF.roofline_terms(rec)
    assert t["mem_per_dev_gib"] == 90e9 / 2 ** 30 and not t["fits_hbm"]
    assert t["probe_device_ms"] == 2000.0
    assert t["mfu_bound"] == pytest.approx(0.5)


@pytest.mark.slow
@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_probe_sweep_over_every_smoke_config(arch, tmp_path):
    """The probe path of every family and kind, on the CPU at the smoke
    configs and tiny shapes."""
    cfg = REG.get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = InputShape(f"tiny_{kind}", 16, 4 if kind == "train" else 2,
                           kind)
        rec = DR.run_one(arch, shape, str(tmp_path), probes=True,
                         cfg_override=cfg, device="cpu")
        assert rec["status"] == "ok", (kind, rec.get("traceback"))
        assert rec["extrapolated"]["host_ms"] > 0
