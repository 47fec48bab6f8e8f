"""The port stands alone: no file of src/repro_torch/ or chip_smoke.py
imports jax or the JAX package, and its entry points refuse to fall back to
the CPU when no device was asked for and there is no CUDA."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.experiments import exp1_quadratic as E1  # noqa: E402
from repro_torch.experiments import exp2_federated as E  # noqa: E402
from repro_torch.experiments import exp3_faults as E3  # noqa: E402
from repro_torch.experiments import ablations as AB  # noqa: E402
from repro_torch.experiments import kernel_bench as KB  # noqa: E402
from repro_torch.experiments import regress as RG  # noqa: E402
from repro_torch.experiments import run as RUN  # noqa: E402
from repro_torch.experiments import serve_bench as SB  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "repro", "benchmarks"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                            & FORBIDDEN) for f in files}
    assert not {f: r for f, r in bad.items() if r}


def test_port_runs_in_a_process_without_jax():
    """Importing every module of the port loads no jax."""
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))], 'jax loaded'\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_distributed_layer_is_covered_and_starts_no_group():
    """The distributed layer and the mesh builders are among the checked
    files, import without jax, and importing them starts no process
    group."""
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    for name in ("distributed/__init__.py", "distributed/sharding.py",
                 "distributed/comm.py", "launch/mesh.py"):
        assert os.path.join("src", "repro_torch", name) in files
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.distributed.sharding, "
            "repro_torch.distributed.comm, repro_torch.launch.mesh\n"
            "assert not dist.is_initialized()\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))], 'jax loaded'\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.main(["--steps", "1", "--seeds", "1", "--out", "",
                "--metrics-out", ""])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.run_one("frodo", 0, 1)
    for main, run in ((E1.main, lambda: E1.run_experiment(n_sets=1,
                                                          n_circle=1)),
                      (E3.main, lambda: E3.run_experiment(quad_steps=1,
                                                          fed_steps=1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--out", "", "--metrics-out", ""])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    for call in (lambda: KB.rows(), lambda: KB.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.run_training(steps=1, seq=8, batch_per_agent=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--smoke", "--steps", "1", "--seq", "8"])
    for call in (lambda: LS.run_traffic(n_requests=1),
                 lambda: LS.main(["--requests", "1"]),
                 lambda: LS.main(["--batch", "1"]),
                 lambda: LS.load_model("mamba2-780m", True, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in (lambda: DR.main(["--arch", "mamba2-780m", "--shape",
                                  "train_4k", "--out", ""]),
                 lambda: DR.main(["--both-meshes", "--arch", "mamba2-780m",
                                  "--out", ""]),
                 lambda: DR.run_one("mamba2-780m", "train_4k"),
                 lambda: RG.main(["--check", "--exp", "exp1"]),
                 lambda: RG.check("exp1", RG.DEFAULT_BASELINE_DIR, None,
                                  None, None, False),
                 lambda: SB.main(["--metrics-out", "unused.jsonl"]),
                 lambda: SB.run_bench("unused.jsonl", n_requests=1),
                 lambda: AB.main(["--rounds", "2", "--out", ""]),
                 lambda: AB.expsum_K(rounds=2),
                 lambda: AB.expsum_dtype(steps=2),
                 lambda: RUN.main(["consensus"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in (lambda: E1.run_batch([[1.0, 0.0]], [0.8], [0.3], [0.15],
                                      [90.0]),
                 lambda: E3.run_quadratic("gd", 0.1, 2, 0),
                 lambda: E3.run_federated("gd", 0.1, 1, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and
    also when it is alone in a directory without the repo."""
    runs = [(os.path.join(ROOT, "chip_smoke.py"), ROOT)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    runs.append((str(alone), str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""           # no card, even on a GPU host
    for script, cwd in runs:
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
