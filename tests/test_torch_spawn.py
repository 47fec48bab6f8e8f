"""``repro_torch.distributed.comm.spawn``: a world in which a rank lost a
connection in gloo's rendezvous is spawned again (at most ``INIT_RETRIES``
times, said on stderr); any other failure to join, and a failure inside
the rank function, is never retried.

The rank functions and the test backends are module-level in this file,
which the spawned ranks import by name (registering the backends there),
so it imports no JAX.  A test backend counts its calls, one line a rank
and world, in the file named by ``REPRO_TEST_SPAWN_INITS``."""
import os

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import comm  # noqa: E402


def _failing_backend(text):
    def create(store, rank, world_size, timeout):
        with open(os.environ["REPRO_TEST_SPAWN_INITS"], "a") as f:
            f.write(f"{rank}\n")
        raise RuntimeError(text)
    return create


dist.Backend.register_backend(
    "test_rendezvous_drop", _failing_backend(
        "Gloo connectFullMesh failed with ... Connection closed by peer "
        "[127.0.0.1]:1"), devices=["cpu"])
dist.Backend.register_backend(
    "test_bad_config", _failing_backend("no such interface"),
    devices=["cpu"])


def _count_and_fail(rank, world, path):
    with open(f"{path}.{rank}", "a") as f:
        f.write("run\n")
    dist.barrier()
    if rank == 0:
        raise RuntimeError("planted failure inside fn")


def _count(rank, world, path):
    with open(f"{path}.{rank}", "a") as f:
        f.write("run\n")


def _runs(path, world):
    out = []
    for r in range(world):
        with open(f"{path}.{r}") as f:
            out.append(len(f.read().splitlines()))
    return out


def _inits(tmp_path):
    with open(tmp_path / "inits") as f:
        return len(f.read().splitlines())


def test_a_rank_raising_inside_fn_is_not_retried(tmp_path, capfd):
    path = str(tmp_path / "runs")
    with pytest.raises(Exception, match="planted failure inside fn"):
        comm.spawn(_count_and_fail, 2, path, store_dir=str(tmp_path),
                   threads=1)
    assert _runs(path, 2) == [1, 1]
    assert "respawning" not in capfd.readouterr().err


def test_a_world_whose_init_failed_is_respawned_at_most_twice(
        tmp_path, capfd, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_SPAWN_INITS", str(tmp_path / "inits"))
    path = str(tmp_path / "runs")
    with pytest.raises(Exception, match="connectFullMesh"):
        comm.spawn(_count, 1, path, backend="test_rendezvous_drop",
                   store_dir=str(tmp_path), threads=1)
    err = capfd.readouterr().err
    assert err.count("respawning the world") == comm.INIT_RETRIES == 2
    assert "retry 2 of 2" in err
    assert _inits(tmp_path) == 3
    assert not any(n.startswith("runs.") for n in os.listdir(tmp_path))


def test_another_failure_to_join_is_raised_after_one_world(
        tmp_path, capfd, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_SPAWN_INITS", str(tmp_path / "inits"))
    path = str(tmp_path / "runs")
    with pytest.raises(Exception, match="no such interface"):
        comm.spawn(_count, 1, path, backend="test_bad_config",
                   store_dir=str(tmp_path), threads=1)
    assert _inits(tmp_path) == 1
    assert "respawning" not in capfd.readouterr().err


def test_a_healthy_world_runs_fn_once_per_rank(tmp_path, capfd):
    path = str(tmp_path / "runs")
    comm.spawn(_count, 2, path, store_dir=str(tmp_path), threads=1)
    assert _runs(path, 2) == [1, 1]
    assert "respawning" not in capfd.readouterr().err
