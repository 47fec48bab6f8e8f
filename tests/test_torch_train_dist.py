"""The agent-sharded trainer (repro_torch.training.trainer.Trainer with a
process group, and ``launch.train --force-devices``) against the
one-process stacked run, on gloo ranks on the CPU.

h2o-danube-1.8b's smoke config in f32, 4 agents on 2 ranks (2 agents a
rank), seq 16, 1 sequence an agent, 4 steps of seed 0, a gradient clip
that binds at every step (0.05·sqrt(A), under every step's norm): the
complete graph (the all-reduce consensus) with exp-sum memory and the
in-step metrics, the ring (the all-gather consensus) with exact memory, a
fault schedule (stragglers and dropped links: per-step W_t and agent
masks), and the hierarchical schedule (2 pods, cross-pod every 2nd step:
Kronecker factors).  Each rank's per-step losses (global means over the
gathered agents), its agents' parameters after step 4 and the metrics
equal the stacked run's to rtol 1e-5 (the same f32 arithmetic; only the
sums across ranks run in another order).  A clip norm left unreduced on
each rank (the planted fault) must miss the same limit.  All cases run in
one spawned world.  ``--force-devices 2`` through ``launch.train.main``
gives the loss trajectory of the run without it (f32, rtol 1e-5), and so
does a ``torchrun`` environment at one rank."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as TR  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.core.faults import FaultSchedule  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

AGENTS, RANKS, STEPS, SEQ = 4, 2, 4, 16
TOL = dict(rtol=1e-5, atol=1e-6)
CLIP = 0.05
CASES = {
    "complete_expsum": (dict(memory_mode="expsum", K=4,
                             collect_metrics=True), 1),
    "ring_exact": (dict(topology="ring", memory_mode="exact", T=6), 1),
    "faults": (dict(memory_mode="expsum", K=4, fault_schedule=FaultSchedule(
        link_drop=0.3, straggler_frac=0.25, seed=3), fault_horizon=8), 1),
    "hierarchical": (dict(topology="hierarchical", cross_pod_period=2,
                          weights="metropolis", memory_mode="exact", T=6),
                     2),
}
KEYS = ("loss", "grad_norm", "ce", "accuracy", "consensus_error_pre_mix",
        "consensus_error", "param_norm", "memory_norm", "update_norm")


def run(case, group=None):
    """History rows and final parameters (this rank's agents) of a case."""
    kw, n_pods = CASES[case]
    cfg = REG.get_smoke_config("h2o-danube-1.8b").replace(
        param_dtype="float32", compute_dtype="float32")
    tc = TS.TrainConfig(**{"remat": False, "grad_clip": CLIP, "T": 8, **kw})
    tr = Trainer(cfg, tc, n_agents=AGENTS, n_pods=n_pods, log_every=1,
                 device="cpu", group=group)
    data = TokenPipeline(vocab=cfg.vocab, seq_len=SEQ, batch_per_agent=1,
                         n_agents=AGENTS, seed=0)
    state = tr.run(tr.init(seed=0), iter(data), STEPS)
    hist = [{k: r[k] for k in KEYS if k in r} for r in tr.history]
    return hist, {k: v.numpy() for k, v in
                  zip(sorted_paths(state.params), TR.leaves(state.params))}


def sorted_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in sorted_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _unreduced_norm(tree, group=None):
    return torch.sqrt(obs_metrics.tree_sq_sum(tree))


def _rank_cases(rank, world, out_dir):
    res = {case: run(case, torch.distributed.group.WORLD)
           for case in CASES}
    real, TS._global_norm = TS._global_norm, _unreduced_norm
    try:
        res["planted_unreduced_clip"] = run(
            "complete_expsum", torch.distributed.group.WORLD)
    finally:
        TS._global_norm = real
    for case, (hist, params) in res.items():
        with open(os.path.join(out_dir, f"{case}{rank}.json"), "w") as f:
            json.dump(hist, f)
        np.savez(os.path.join(out_dir, f"{case}{rank}.npz"), **params)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the ranks (``comm.spawn`` splits this
    process's): the tests run beside other workers, and an oversubscribed
    CPU makes thousands of tiny ops crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_dist"))
    comm.spawn(_rank_cases, RANKS, d, store_dir=d)
    out = []
    for r in range(RANKS):
        res = {}
        for case in list(CASES) + ["planted_unreduced_clip"]:
            with open(os.path.join(d, f"{case}{r}.json")) as f:
                hist = json.load(f)
            with np.load(os.path.join(d, f"{case}{r}.npz")) as z:
                res[case] = hist, {k: z[k] for k in z.files}
        out.append(res)
    return out


@pytest.fixture(scope="module")
def stacked():
    return {case: run(case) for case in CASES}


def mismatch(hist, params, ref_hist, ref_params, rank):
    """The largest violation of TOL over losses, metrics and this rank's
    agents' parameters (<= 0 when within it)."""
    worst = -1.0
    lo = rank * AGENTS // RANKS
    pairs = [(np.asarray([h[k] for h in hist]),
              np.asarray([h[k] for h in ref_hist])) for k in ref_hist[0]]
    pairs += [(params[k], ref_params[k][lo:lo + AGENTS // RANKS])
              for k in ref_params]
    for got, ref in pairs:
        assert got.shape == ref.shape
        excess = np.abs(got - ref) - (TOL["atol"] + TOL["rtol"] * np.abs(ref))
        worst = max(worst, float(excess.max()))
    return worst


@pytest.mark.parametrize("case", CASES)
def test_sharded_trainer_equals_the_stacked_run(case, sharded, stacked):
    ref_hist, ref_params = stacked[case]
    assert len(ref_hist) == STEPS
    # the clip binds at every step: the pre-clip norm is over the limit
    assert all(h["grad_norm"] > CLIP * np.sqrt(AGENTS) for h in ref_hist)
    if case == "complete_expsum":
        assert set(ref_hist[0]) == set(KEYS)
    for rank in range(RANKS):
        hist, params = sharded[rank][case]
        assert set(hist[0]) == set(ref_hist[0])
        assert mismatch(hist, params, ref_hist, ref_params, rank) <= 0, \
            (case, rank)


def test_unreduced_clip_norm_fails_the_check(sharded, stacked):
    """The planted fault: each rank clips by its own agents' norm."""
    ref_hist, ref_params = stacked["complete_expsum"]
    for rank in range(RANKS):
        hist, params = sharded[rank]["planted_unreduced_clip"]
        assert mismatch(hist, params, ref_hist, ref_params, rank) > 0


#: f32: in bf16 the CPU's matmuls round differently with the thread count
#: (a rank has a share of the cores), ~4e-5 of the loss
ARGS = ["--smoke", "--steps", "3", "--seq", "16", "--batch-per-agent", "1",
        "--agents", "4", "--param-dtype", "float32"]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The launcher's rows without a flag or a group."""
    d = tmp_path_factory.mktemp("one_process")
    out = str(d / "one.jsonl")
    LT.main(ARGS + ["--device", "cpu", "--ckpt-dir", str(d),
                    "--metrics-out", out])
    rows = obs_metrics.read_jsonl(out)
    assert len(rows) == 3
    return rows


def same_trajectory(rows, ref):
    assert len(rows) == len(ref)
    for key in ("loss", "grad_norm", "consensus_error", "param_norm"):
        np.testing.assert_allclose([r[key] for r in rows],
                                   [r[key] for r in ref], **TOL)


def test_a_torchrun_environment_starts_the_default_group(
        one_process, tmp_path, monkeypatch):
    """``WORLD_SIZE`` in the environment: ``main`` starts a gloo group
    (``--device cpu``) from it, runs on it and ends it; at one rank the
    trajectory is the one-process run's."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:          # a free port, not a fixed one
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen = []
    real = LT.run_training

    def spy(**kw):
        seen.append((dist.is_initialized(), dist.get_backend()))
        return real(**kw)

    monkeypatch.setattr(LT, "run_training", spy)
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    out = str(tmp_path / "env.jsonl")
    LT.main(ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                    "--metrics-out", out])
    assert seen == [(True, "gloo")] and not dist.is_initialized()
    same_trajectory(obs_metrics.read_jsonl(out), one_process)


def test_force_devices_gives_the_trajectory_without_it(one_process,
                                                       tmp_path):
    args = ARGS + ["--ckpt-dir", str(tmp_path)]
    out = str(tmp_path / "two.jsonl")
    LT.main(args + ["--force-devices", "2", "--metrics-out", out])
    same_trajectory(obs_metrics.read_jsonl(out), one_process)
    with pytest.raises(ValueError, match="must divide"):
        LT.main(args + ["--force-devices", "3"])
    with pytest.raises(ValueError, match="CPU ranks"):
        LT.main(args + ["--force-devices", "2", "--device", "cuda"])
