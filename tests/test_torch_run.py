"""The port's CSV harness (repro_torch.experiments.run) on the CPU, against
the JAX harness (benchmarks/run.py): the same row names, the exp1 rows'
numbers from the same sweep, rows mirrored into the JSONL sink, the
roofline rows read from the port's dry-run records, and every row saying
which clock timed it."""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.experiments import run as RUN  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of tiny ops: one thread is fastest, and keeps the test's
    time when other processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_rows(capsys, monkeypatch, which):
    from benchmarks import run as JRUN
    monkeypatch.setattr(sys, "argv", ["run.py", *which])
    capsys.readouterr()
    JRUN.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    return [tuple(l.split(",", 2)) for l in lines[1:]]


def test_consensus_rows_are_the_jax_harness_rows(capsys, monkeypatch,
                                                 tmp_path):
    ref = jax_rows(capsys, monkeypatch, ["consensus"])
    path = str(tmp_path / "bench.jsonl")
    mine = RUN.main(["consensus", "--device", "cpu", "--metrics-out", path])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "name,us_per_call,derived" and len(out) == 5
    assert [r[0] for r in mine] == [r[0] for r in ref]
    for (_, _, d), (_, _, jd) in zip(mine, ref):
        assert d == jd + ",clock=host"
    sink = [json.loads(l) for l in open(path)]
    assert [(r["name"], r["value"], r["derived"]) for r in sink] == mine
    assert all(us > 0 for _, us, _ in mine)


def test_exp1_rows_are_the_jax_harness_rows(capsys, monkeypatch):
    ref = jax_rows(capsys, monkeypatch, ["exp1"])
    mine = RUN.main(["exp1", "--device", "cpu"])
    assert [r[0] for r in mine] == [r[0] for r in ref]
    for (_, _, d), (_, _, jd) in zip(mine, ref):
        assert d.replace(",clock=host", "") == jd


def test_ablations_and_roofline_rows(capsys, tmp_path):
    dr = str(tmp_path / "dryrun_torch")
    for shape in ("train_4k", "long_500k"):
        DR.run_one("whisper-tiny", shape, dr, device="cpu")
    mine = RUN.main(["ablations", "roofline", "--device", "cpu",
                     "--ablation-rounds", "40", "--dryrun-dir", dr])
    names = [r[0] for r in mine]
    assert names == ["ablation_exact_T90_iters",
                     *(f"ablation_expsum_K={k}" for k in (2, 4, 6, 8, 12)),
                     "roofline_whisper-tiny_train_4k_1xH100",
                     "roofline_pairs_analyzed"]
    assert mine[0][2] == "iters=40"                  # 40 rounds: not reached
    assert mine[-1][2] == "count=1"
    assert mine[-2][2].startswith("dom=compute,mfu_bound=")
    none = RUN.main(["roofline", "--device", "cpu", "--dryrun-dir",
                     str(tmp_path / "absent")])
    assert none == [("roofline", 0.0, "no dryrun records; run "
                     "repro_torch.launch.dryrun")]


def test_kernel_rows_on_the_cpu_time_the_plain_versions():
    rows = RUN.main(["kernels", "--device", "cpu"])
    assert [r[0] for r in rows] == ["frodo_exact_n1024", "frodo_expsum_n1024",
                                    "frodo_exact_n4096", "frodo_expsum_n4096"]
    assert all(d.endswith(",plain,clock=host") for _, _, d in rows)
