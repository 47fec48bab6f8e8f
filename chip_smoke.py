#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both FrODO update kernels compiled from ``src/repro_torch/kernels/
   csrc/frodo_update.cu``;
3. kernels: each kernel against its plain version (``kernels/ref.py``) at the
   Exp 2 leaf shapes and at tail sizes, f32 and bf16;
4. exp2_exact: the Exp 2 trainer at full width (2 agents, 784-1024-128-10,
   batch 64, FrODO exact memory T=80 through the exact kernel) for 40 steps;
   its launch count, a falling loss, and the per-step loss against the plain
   (``use_kernel=False``) path;
5. exp2_expsum: the same loop with exp-sum memory (K=8) through the exp-sum
   kernel, with f32 and bf16 accumulators, against the plain path;
6. faults: with every link dropped, ``mix_time_varying`` returns the states
   bit for bit; under symmetric drops the network mean holds to f32
   rounding; ``mix_hierarchical`` (period 1) equals ``mix_stacked`` with the
   Kronecker product;
7. exp1: Exp 1 at the paper's full protocol (100 sets, 50 circle starts,
   5000 rounds, 3 variants, one batch) on the card, with iteration counts
   equal to the same sweep on the CPU; the paper's headline claims; the
   150-step telemetry trace against ``benchmarks/baselines/exp1.json``; the
   representative point through ``core.loop`` with the exact kernel at
   T = 90 padded to 100 slots (one launch per round after the first),
   against the inline trace;
8. exp3: Exp 3 at the regression scale (seed 0, 400 quadratic and 50
   federated rounds): its quadratic series against
   ``benchmarks/baselines/exp3.json``, the exact-kernel launches of the
   FrODO arms, kernel vs plain path per round, the >= 2x robustness
   headline at 30% drop; ms per round; then the default scale (2000 / 150),
   timed, in both drop modes;
9. llm_train: the LLM trainer (``repro_torch.launch.train.run_training``)
   on h2o-danube-1.8b at full width, depth cut to 8 layers, seq 4096, 2
   agents x 2 sequences, FrODO exp-sum memory (K = 8, f32 accumulators)
   through the exp-sum kernel on bf16 leaves: 20 steps, a falling loss,
   240 launches, ms/step, tokens/s, peak memory, and a 3-step
   torch.profiler window (the kernel's device time per step and at
   ``blocks/mlp/up/w``, the top kernels, the busy share); then the
   exact-memory sub-run (2 layers, T = 40, through the exact kernel),
   kernel vs plain path in both memory modes (1 layer, seq 512; planted
   faults must fail the same limit), the card
   against the card machine's CPU (smoke config, f32, 12 steps), exp-sum
   with bf16 accumulators (5 steps), and both kernels against their plain
   versions on one full leaf each, past 2^31 elements of state (delta
   within one bf16 ulp at few elements, state bit-equal; planted faults in
   the plain version must fail the same check);
10. timing: CUDA-event medians of each kernel, its plain version and (exact)
   one library call, beside the memory bound; the Exp 2 ms/step;
11. profile: torch.profiler device time per launch of each kernel at each
    Exp 2 leaf, and an Exp 2 step's device time, busy share and top kernels.

Then the ``{"kernels": [...]}`` summary line (launches per path: exp2,
exp1_point, exp3, llm_train, llm_train_exact, llm_train_expsum_bf16acc,
each counted from 0 just before the path runs), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

STEPS = 40
T = 80
K = 8
ALPHA, BETA = 0.05, 0.02                    # Exp 2's FrODO step sizes
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM
F32_FLOPS_PER_S = 67e12                     # H100 SXM, f32 outside tensor cores
EXP2_LEAVES = {"b0": (2, 1024), "b1": (2, 128), "b2": (2, 10),
               "w0": (2, 784, 1024), "w1": (2, 1024, 128), "w2": (2, 128, 10)}
TAIL_SHAPES = [(1,), (7,), (1000,)]
# kernel vs plain version: tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2e-2,
                                                               atol=2e-2)}
ACC_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Exp 2 per-step loss, kernel path vs plain path.  Exact memory: the two sum
# the 80 slots in another order (f32 FMA chain vs a contraction in the
# history dtype), ~1e-7 relative per step, which 40 steps of training carry
# through; 1e-3 leaves a wide margin over that.  Exp-sum with bf16
# accumulators: the kernel rounds once from f32 while the plain path rounds
# after every bf16 operation (bf16 holds ~3 digits), so the trajectories
# differ by up to a few per cent.
LOSS_TOL = {"exact": dict(rtol=1e-3, atol=1e-5),
            "expsum_float32": dict(rtol=1e-3, atol=1e-5),
            "expsum_bfloat16": dict(rtol=5e-2, atol=1e-3)}
# trajectories against benchmarks/baselines/*.json: benchmarks/regress.py's
# defaults (timing excluded: the baselines' step times are JAX's on a CPU)
REGRESS_TOL = dict(rtol=0.05, atol=1e-6, max_violation_frac=0.02)
# mix_hierarchical (two contractions) vs one contraction with the Kronecker
# product: f32 sums of <= 4 terms in another order
MIX_TOL = dict(rtol=1e-5, atol=1e-6)
# the Exp 1 point through core.loop (autograd gradients, the kernel's fused
# -(a g + b M) added) vs the inline trace (analytic gradients, a g and b M
# subtracted): ~1e-7 relative rounding per round of states of size ~2, on
# an error that decays from 1 to below 1e-6, so an absolute floor of ~20 f32
# ulps of those states (the two differ by 7.5e-7 at an error of 1e-5 on the
# CPU)
EXP1_POINT_ROUNDS = 600
POINT_TOL = dict(rtol=1e-4, atol=5e-6)
# Exp 3 quadratic error, kernel vs plain path (the 90 slots summed in
# another order), 400 rounds
EXP3_QUAD_TOL = dict(rtol=1e-4, atol=1e-6)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernel_us(fn) -> dict:
    """Device time of each kernel (and copy) that ``fn`` runs, from
    torch.profiler (CUPTI): ``{name: (launches, total_us)}``.  Empty if the
    profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # the trace_scope ranges (consensus.*, pallas.*) show on the device
        # timeline as annotations spanning kernels: not kernels themselves
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        out[e.key] = (e.count, float(us))
    return out


def close_np(a, b, tol) -> tuple:
    """(every |a - b| <= atol + rtol |b|, the largest |a - b|)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b)
    return (bool((err <= tol["atol"] + tol["rtol"] * np.abs(b)).all()),
            float(err.max()) if err.size else 0.0)


def baseline_check(name: str, rows, keep) -> dict:
    """Hold the series of ``rows`` whose label passes ``keep`` against the
    committed golden baseline ``benchmarks/baselines/<name>.json`` with the
    regression gate's tolerances (timing excluded).  Raises on drift."""
    from repro_torch.obs import regress as R
    base = R.load_baseline(os.path.join(ROOT, "benchmarks", "baselines",
                                        f"{name}.json"))
    base["series"] = {k: v for k, v in base["series"].items() if keep(k)}
    rows = [r for r in rows if keep(R.group_label(r))]
    diffs = R.compare_to_baseline(base, rows, R.Tolerance(**REGRESS_TOL),
                                  include_timing=False)
    check(bool(diffs) and all(d.passed for d in diffs),
          f"{name} against its baseline:\n{R.format_report(diffs)}")
    return {"series": len(base["series"]), "checks": len(diffs),
            "worst_violation_frac": max(d.violation_frac for d in diffs)}


def faults_phase(dev) -> None:
    """Fault-aware consensus on the card: identity mixing bit-exact, the
    network mean conserved under symmetric drops, hierarchical mixing equal
    to its Kronecker product."""
    import numpy as np
    import torch
    from repro_torch import tree as TR
    from repro_torch.core import consensus as C
    from repro_torch.core import faults as F
    from repro_torch.core import graph as G

    gen = torch.Generator(device=dev).manual_seed(1)

    def state(A):        # the Exp 3 federated leaves, A agents
        return {k: torch.randn((A,) + s, generator=gen, device=dev)
                for k, s in {"w0": (784, 64), "b0": (64,), "w1": (64, 10),
                             "b1": (10,)}.items()}

    def seq(c):
        return torch.as_tensor(c.W_seq, dtype=torch.float32, device=dev)

    x = state(4)
    dark = F.FaultSchedule(link_drop=1.0).compile(
        G.complete(4), 8, weight_fn=G.xiao_boyd_weights)
    W_seq = seq(dark)
    for k in range(12):                        # wraps past the horizon
        out = C.mix_time_varying(x, W_seq, k)
        for n in x:
            check(torch.equal(out[n].view(torch.int32),
                              x[n].view(torch.int32)),
                  f"drop 1.0 mixing not bit-exact at step {k}, leaf {n}")

    steps = 100
    sym = F.FaultSchedule(link_drop=0.3, seed=0, drop_mode="symmetric")
    W_seq = seq(sym.compile(G.complete(4), steps,
                            weight_fn=G.xiao_boyd_weights))
    mean0 = {n: v.double().mean(0) for n, v in x.items()}
    scale = max(float(v.abs().max()) for v in x.values())
    # each step's 4-term dot products round at most 4 times per entry
    mean_tol = steps * 4 * float(np.finfo(np.float32).eps) * scale
    y, drift = x, torch.zeros((), dtype=torch.float64, device=dev)
    for k in range(steps):
        y = C.mix_time_varying(y, W_seq, k)
        for n in y:
            drift = torch.maximum(drift, (y[n].double().mean(0)
                                          - mean0[n]).abs().max())
    drift = float(drift)
    check(drift <= mean_tol, f"symmetric drops moved the network mean by "
          f"{drift} > {mean_tol}")

    hier = {}
    for label, W_pod, W_intra in (
            ("uniform", G.uniform_weights(G.complete(2)),
             G.uniform_weights(G.complete(4))),
            ("metropolis", G.metropolis_weights(G.ring(3, directed=False)),
             G.metropolis_weights(G.ring(4, directed=False)))):
        x = state(W_pod.shape[0] * W_intra.shape[0])
        got = C.mix_hierarchical(x, W_intra, W_pod, step=0, period=1)
        ref = C.mix_stacked(x, torch.as_tensor(
            np.kron(W_pod, W_intra), dtype=torch.float32, device=dev))
        worst = 0.0
        for a, b in zip(TR.leaves(got), TR.leaves(ref)):
            ok, err = close_np(a.cpu(), b.cpu(), MIX_TOL)
            check(ok, f"mix_hierarchical ({label}) vs kron: {err}")
            worst = max(worst, err)
        hier[label] = worst
    emit("faults", identity_mixing="bit-equal over 12 steps (drop 1.0)",
         symmetric_mean_drift=drift, symmetric_mean_tol=mean_tol,
         symmetric_steps=steps, hierarchical_vs_kron_max_abs_err=hier,
         hierarchical_tol=MIX_TOL)


def exp1_phase(dev) -> dict:
    """Exp 1 at the paper's full protocol on the card, against the same
    sweep on the CPU; its headline claims; its telemetry trace against the
    committed baseline; the representative point through core.loop with
    the exact kernel at T = 90 padded to 100 slots."""
    import tempfile
    import time

    import numpy as np
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core import loop
    from repro_torch.core.frodo import FrodoConfig, frodo
    from repro_torch.experiments import exp1_quadratic as E1
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import read_jsonl

    t0 = time.perf_counter()
    card = E1.sweep(n_sets=100, n_circle=50, seed=0, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = E1.sweep(n_sets=100, n_circle=50, seed=0, device="cpu")
    cpu_s = time.perf_counter() - t0
    n_runs = n_diff = 0
    for v in E1.VARIANTS:
        for a, b in [(card[v]["named"][k], host[v]["named"][k])
                     for k in E1.NAMED_STARTS] + [(card[v]["circle"],
                                                   host[v]["circle"])]:
            n_runs += a.size
            n_diff += int((a != b).sum())
    check(n_diff == 0, f"Exp 1 iteration counts: {n_diff} of {n_runs} runs "
          "differ between the card and the CPU")
    s = E1.summarize(card)
    frac, hb, nm = (s[v]["circle_mean"] for v in E1.VARIANTS)
    r = s["steep_flat_ratio"]
    ks = s["ks_tests"]["one_sided_fractional<no_memory"]["p"]
    check(frac < hb < nm, f"circle means out of order: {frac} {hb} {nm}")
    check(nm / frac > 2.0, f"no memory / fractional = {nm / frac} <= 2")
    check(r["fractional"] < r["heavy_ball"] < r["no_memory"],
          f"steep/flat ratios out of order: {r}")
    check(ks < 1e-3, f"one-sided KS p = {ks} >= 1e-3")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exp1.jsonl")
        E1.write_metrics_jsonl(path, steps=150, device=dev)
        rows = read_jsonl(path)
    base = baseline_check("exp1", rows, lambda label: True)

    K = EXP1_POINT_ROUNDS
    point = (0.8, 0.35, 0.15, 90.0)
    KU.reset_launches()
    res = loop.run(E1.objective, torch.tensor([[1.0, 0.0]] * 4, device=dev),
                   frodo(FrodoConfig(alpha=0.8, beta=0.35, lam=0.15, T=90,
                                     pad_T=100, use_kernel=True)),
                   G.xiao_boyd_weights(G.complete(4)), K,
                   x_star=np.zeros(2, np.float32))
    launches = dict(ops.LAUNCHES)
    check(launches == {"frodo_exact_update": K - 1, "frodo_expsum_update": 0},
          f"exact launches on the Exp 1 point: {launches}")
    inline = E1.telemetry_trace((1.0, 0.0), *(np.float32(v) for v in point),
                                K, device=dev)["error"]
    ok, err = close_np(res["errors"], inline, POINT_TOL)
    check(ok, f"Exp 1 point through the kernel vs the inline trace: {err}")
    emit("exp1", sets=100, circle=50, k_max=E1.K_MAX, seed=0, runs=n_runs,
         sweep_seconds_card=card_s, sweep_seconds_cpu=cpu_s,
         runs_differing_card_vs_cpu=n_diff, tol_iterations=0,
         circle_mean={v: s[v]["circle_mean"] for v in E1.VARIANTS},
         no_memory_over_fractional=nm / frac, steep_flat_ratio=r,
         ks_one_sided_p={k: v["p"] for k, v in s["ks_tests"].items()
                         if k.startswith("one_sided")},
         telemetry_vs_baseline=base,
         point={"alpha": 0.8, "beta": 0.35, "lam": 0.15, "T": 90,
                "pad_T": 100, "rounds": K, "launches": launches,
                "max_abs_err_vs_inline": err, "tol": POINT_TOL,
                "iters_to_1e-6": loop.iterations_to_tol(res["errors"])})
    return launches


def exp3_phase(dev) -> dict:
    """Exp 3 at the regression scale on the card: the quadratic series
    against the committed baseline, exact-kernel launches, kernel vs plain
    path, the robustness headline; then the default scale, timed, in both
    drop modes."""
    import tempfile
    import time

    from repro_torch.experiments import exp3_faults as E3
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import read_jsonl

    n_leaves = 4                                   # w0, b0, w1, b1
    quad, fed = 400, 50                            # benchmarks/regress.py
    n_drops = 1 + len(E3.DROP_RATES)

    def expected(q, f):                            # FrODO arms only
        return {"frodo_exact_update": n_drops * ((q - 1) + n_leaves * f),
                "frodo_expsum_update": 0}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exp3.jsonl")
        KU.reset_launches()
        t0 = time.perf_counter()
        summary = E3.run_experiment(seed=0, quad_steps=quad, fed_steps=fed,
                                    metrics_out=path, metrics_steps=60,
                                    device=dev)
        reg_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        rows = read_jsonl(path)
    check(launches == expected(quad, fed),
          f"exact launches on Exp 3: {launches} != {expected(quad, fed)}")
    base = baseline_check("exp3", rows, lambda label: "quadratic-" in label)
    row = summary["quadratic"]["drop30"]
    check(row["frodo"]["iters_to_tol"] < quad,
          f"FrODO at 30% drop did not reach {E3.QUAD_TOL}: {row}")
    check(row["dgd_over_frodo_iters"] >= 2.0,
          f"DGD / FrODO iterations at 30% drop < 2: {row}")

    vs_plain = {}
    for drop in (0.0,) + E3.DROP_RATES:
        k = E3.run_quadratic("frodo", drop, quad, 0, device=dev)["errors"]
        p = E3.run_quadratic("frodo", drop, quad, 0, device=dev,
                             use_kernel=False)["errors"]
        ok, err_q = close_np(k, p, EXP3_QUAD_TOL)
        check(ok, f"Exp 3 quadratic errors, kernel vs plain, drop {drop}: "
              f"{err_q}")
        k = E3.run_federated("frodo", drop, fed, 0, device=dev)["loss"]
        p = E3.run_federated("frodo", drop, fed, 0, device=dev,
                             use_kernel=False)["loss"]
        ok, err_f = close_np(k, p, LOSS_TOL["exact"])
        check(ok, f"Exp 3 federated loss, kernel vs plain, drop {drop}: "
              f"{err_f}")
        vs_plain[E3._drop_tag(drop)] = {"quadratic_errors": err_q,
                                        "federated_loss": err_f}

    def timed(fn):        # host clock; a run ends by copying to the host
        fn()                                        # warm-up
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    ms_per_round = {
        f"{arm}_{path}": timed(lambda arm=arm, uk=uk: (
            E3.run_quadratic("frodo", 0.3, 2000, 0, device=dev,
                             use_kernel=uk) if arm == "quadratic" else
            E3.run_federated("frodo", 0.3, 150, 0, device=dev,
                             use_kernel=uk))) / (2000 if arm == "quadratic"
                                                 else 150)
        for arm in ("quadratic", "federated")
        for path, uk in (("kernel", True), ("plain", False))}

    default = {}
    for mode in ("directed", "symmetric"):
        KU.reset_launches()
        t0 = time.perf_counter()
        s = E3.run_experiment(seed=0, quad_steps=2000, fed_steps=150,
                              device=dev, drop_mode=mode)
        secs = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        check(got == expected(2000, 150),
              f"exact launches on Exp 3 ({mode}, default scale): {got}")
        check(s["quadratic"]["drop30"]["dgd_over_frodo_iters"] >= 2.0,
              f"robustness headline ({mode}, default scale): "
              f"{s['quadratic']['drop30']}")
        default[mode] = {
            "seconds": secs, "launches": got["frodo_exact_update"],
            "dgd_over_frodo_iters": {t: r["dgd_over_frodo_iters"]
                                     for t, r in s["quadratic"].items()},
            "frodo_iters_to_tol": {t: r["frodo"]["iters_to_tol"]
                                   for t, r in s["quadratic"].items()},
            "federated_final_loss_frodo": {
                t: r["frodo"]["final_loss"] for t, r in s["federated"].items()
                if isinstance(r, dict)}}
    emit("exp3", seed=0, quad_steps=quad, fed_steps=fed, metrics_steps=60,
         seconds=reg_s, launches=launches,
         quadratic_vs_baseline=base,
         federated_vs_baseline="not checked: the baseline's federated "
         "initial weights come from JAX's non-partitionable threefry draw, "
         "and there is no JAX on the card",
         drop30=row, kernel_vs_plain_max_abs_err=vs_plain,
         tol={"quadratic_errors": EXP3_QUAD_TOL,
              "federated_loss": LOSS_TOL["exact"]},
         ms_per_round_drop30=ms_per_round, default_scale=default)
    return launches


def slice_profile(dev) -> dict:
    """Host ms and device ms per round of this slice's paths, and the
    device's busy share: a warm-up call, a timed call (host clock; each
    call ends by copying its result to the host), a profiled call."""
    import time

    import numpy as np
    from repro_torch.experiments import exp1_quadratic as E1
    from repro_torch.experiments import exp3_faults as E3

    B, rounds = 1350, 50           # the full protocol's batch, 50 rounds
    a, b, lam, T = E1.sample_hparams(B, 0)
    x0s = np.tile(np.asarray([1.0, 0.0], np.float32), (B, 1))
    paths = {
        "exp1_sweep_round": (lambda: E1._algorithm1(
            x0s, a, b, lam, T, rounds, dev).cpu(), rounds),
        "exp3_quadratic_round": (lambda: E3.run_quadratic(
            "frodo", 0.3, rounds, 0, device=dev), rounds),
        "exp3_federated_round": (lambda: E3.run_federated(
            "frodo", 0.3, 10, 0, device=dev), 10)}
    out = {}
    for label, (fn, n) in paths.items():
        fn()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        rows = device_kernel_us(fn)
        dev_ms = sum(us for _, us in rows.values()) / n / 1e3
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:5]
        out[label] = {
            "host_ms": host_ms, "device_ms": dev_ms if rows else None,
            "device_busy_share": dev_ms / host_ms if rows else None,
            "kernels": sum(c for c, _ in rows.values()) / n,
            "top_kernels": [{"name": k[:90], "us": us / n}
                            for k, (_, us) in top]}
    return out


# ----------------------------------------------------------- LLM trainer
#: the llm_train phase: h2o-danube-1.8b at full width through the port's
#: launcher (repro_torch.launch.train.run_training)
LLM_ARCH = "h2o-danube-1.8b"
#: ms/step is the median of steps 6-19: the window's steps run under the
#: profiler, and step 5, the one after it, also times the trace's export.
LLM = dict(n_layers=8, seq=4096, batch_per_agent=2, agents=2, steps=20,
           T=90, profile=(2, 4), timed_from=6)
LLM_REDUCED = {
    "n_layers": "24 -> 8: two agents' exp-sum state (K = 8 f32 "
                "accumulators, 46 GB) fits one 80 GB card",
    "global_batch": "256 -> 4 (2 agents x 2 sequences of train_4k's 4096)"}
#: the exact-memory sub-run (the launcher's default mode).  A sub-run's
#: profile window comes last: the step after a window also times the
#: trace's export, so ms/step is read from the steps before it.
LLM_EXACT = dict(n_layers=2, T=40, steps=5, profile=(3, 4))
#: kernel vs plain path, same settings otherwise: 1 layer, seq 512, 3 steps
LLM_VS_PLAIN = dict(n_layers=1, seq=512, steps=3)
#: exp-sum with bf16 accumulators
LLM_BF16_ACC = dict(n_layers=8, steps=5, profile=(3, 4))
#: card against the card machine's CPU: the smoke config in f32
LLM_CARD_CPU = dict(steps=12)
# Per-step loss, kernel path vs plain path, bf16 leaves, 3 steps at 1 layer.
# The kernel forms -(a g + b M) in f32 and rounds once to bf16; the plain
# path rounds a g, b M and their sum in bf16 (and, exact mode, M itself),
# so the two parameter sets part by about a bf16 ulp where they part at all.
# On an H100 the losses read 1.9e-6 (exact) and 8.2e-5 (exp-sum) apart, the
# same in every run; the limit, 1e-4 of a loss of ~10.5, is 13 times the
# larger.  The phase also runs the plain path with alpha or beta 10% high
# (LLM_PLANTED; on an H100 2.0e-2 and 1.9e-3 from the kernel path) and
# checks that this limit catches both.
LLM_LOSS_TOL = dict(rtol=1e-4, atol=0.0)
LLM_PLANTED = {"alpha_x1.1": dict(alpha=0.022), "beta_x1.1": dict(beta=0.0088)}
# A bf16 delta on an LLM leaf, kernel vs plain version.  Both form
# -(a g + b M) in f32 and round once to bf16, so an element can differ only
# where the two f32 results (sums in another order, FMA) fall on either side
# of a bf16 rounding boundary: by one bf16 ulp (at most 2^-7 of the value),
# at few elements.  atol covers elements where a g and b M cancel.  The
# phase plants faults into the plain version on a slab of the same inputs
# (M weighted 10% high, one coefficient or the slot weights off, truncation
# in place of rounding) and checks that each fails this.  On an H100 4.0e-5
# (exp-sum) and 4.7e-5 (exact) of the elements differ, each by one ulp; the
# planted faults make 0.50 to 0.99 of them differ.
BF16_DELTA_TOL = dict(rtol=2.0 ** -7, atol=1e-6, max_share_differing=1e-3)
# Card vs CPU at f32 (TF32 off): the same arithmetic in other sum orders
# (~1e-6 relative per step), carried over 12 steps of training.
CARD_CPU_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_FLOPS_PER_S = 989e12                   # H100 SXM, dense bf16


def llm_leaf_shapes(cfg, agents: int) -> dict:
    """The dense model's parameter leaves, agent-stacked, in the port's
    (sorted) leaf order: the order the optimizer launches one kernel per
    leaf."""
    d, H, G, hd, ff, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd(), cfg.d_ff, cfg.n_layers, cfg.vocab)
    A = agents
    shapes = {
        "blocks/attn/wk/w": (A, L, d, G, hd), "blocks/attn/wo/w": (A, L, H,
                                                                   hd, d),
        "blocks/attn/wq/w": (A, L, d, H, hd), "blocks/attn/wv/w": (A, L, d,
                                                                   G, hd),
        "blocks/ln1/scale": (A, L, d), "blocks/ln2/scale": (A, L, d),
        "blocks/mlp/down/w": (A, L, ff, d), "blocks/mlp/gate/w": (A, L, d,
                                                                  ff),
        "blocks/mlp/up/w": (A, L, d, ff), "embed/table": (A, V, d),
        "lm_head/w": (A, d, V), "ln_f/scale": (A, d)}
    return shapes


def trace_kernels(path: str) -> list:
    """Device kernels of a torch.profiler Chrome trace, in launch order:
    [(name, start_us, dur_us)]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ks = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
          if e.get("cat") == "kernel" and "dur" in e]
    return sorted(ks, key=lambda k: k[1])


def window_profile(path: str, n_steps: int, step_ms: list, kernel: str,
                   leaf_index: int, n_leaves: int) -> dict:
    """From a profile window's trace: the named FrODO kernel's device time
    per step and per launch at one leaf (its place in each step's
    ``n_leaves`` launches), the top device kernels, and the busy share
    (device kernel time over the window's host-clock step time)."""
    ks = trace_kernels(path)
    mine = [d for n, _, d in ks if kernel in n]
    check(len(mine) == n_steps * n_leaves,
          f"{kernel}: {len(mine)} launches in a {n_steps}-step profile "
          f"window, want {n_steps * n_leaves}")
    per_name: dict = {}
    for n, _, d in ks:
        c, t = per_name.get(n, (0, 0.0))
        per_name[n] = (c + 1, t + d)
    busy_us = sum(d for _, _, d in ks)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "kernel_ms_per_step": sum(mine) / n_steps / 1e3,
        "kernel_ms_at_leaf": statistics.mean(
            mine[leaf_index::n_leaves]) / 1e3,
        "device_ms_per_step": busy_us / n_steps / 1e3,
        "device_busy_share": busy_us / 1e3 / sum(step_ms),
        "kernels_per_step": len(ks) / n_steps,
        "top_kernels": [{"name": n[:90], "launches_per_step": c / n_steps,
                         "ms_per_step": t / n_steps / 1e3}
                        for n, (c, t) in top]}


def llm_train_phase(dev) -> dict:
    """The LLM trainer on the card: h2o-danube-1.8b at full width with cut
    depth, FrODO exp-sum memory through the exp-sum kernel on bf16 leaves
    (20 steps, profiled); the exact-memory sub-run through the exact
    kernel; kernel vs plain path in both modes; card vs the card machine's
    CPU at the f32 smoke config; exp-sum with bf16 accumulators; and both
    kernels against their plain versions at the largest leaves.  Returns
    the launches of the trainer's paths and the kernels' numbers at the
    LLM leaves."""
    import tempfile
    import time

    import numpy as np
    import torch
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.core import memory as fmem
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import run_training
    from repro_torch.obs.metrics import read_jsonl
    from repro_torch.training import train_step as TS

    tmp = tempfile.mkdtemp(prefix="llm_train_")
    runs = [0]

    def train(**kw):
        """One run_training call on ``kw``'s settings; returns its sink
        rows, its launches (counted from 0 just before), its seconds, its
        peak device memory (0 for a run on the CPU) and its profile trace
        path (or None)."""
        runs[0] += 1
        tag = f"run{runs[0]}"
        prof = kw.pop("profile", None)
        args = dict(arch=LLM_ARCH, smoke=False, agents=LLM["agents"],
                    seq=LLM["seq"], batch_per_agent=LLM["batch_per_agent"],
                    seed=0, device=dev, use_kernel=True,
                    metrics_out=os.path.join(tmp, f"{tag}.jsonl"))
        if prof is not None:
            args.update(profile_dir=os.path.join(tmp, tag),
                        profile_start=prof[0], profile_stop=prof[1])
        args.update(kw)
        on_card = torch.device(args["device"]).type == "cuda"
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        KU.reset_launches()
        t0 = time.perf_counter()
        run_training(**args)
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        rows = read_jsonl(args["metrics_out"])
        trace = (os.path.join(args["profile_dir"], "trace.json")
                 if prof is not None else None)
        return rows, launches, secs, peak, trace

    cfg = REG.get_config(LLM_ARCH).replace(n_layers=LLM["n_layers"])
    shapes = llm_leaf_shapes(cfg, LLM["agents"])
    names = list(shapes)
    n = sum(int(np.prod(s)) for s in shapes.values())
    n_leaves = len(shapes)
    up = names.index("blocks/mlp/up/w")
    tokens = LLM["agents"] * LLM["batch_per_agent"] * LLM["seq"]

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    # ------------------------------------------------ the main run: exp-sum
    steps = LLM["steps"]
    rows, launches, secs, peak, trace = train(
        n_layers=LLM["n_layers"], memory_mode="expsum", T=LLM["T"],
        steps=steps, profile=LLM["profile"])
    check(launches == {"frodo_exact_update": 0,
                       "frodo_expsum_update": n_leaves * steps},
          f"exp-sum launches on the LLM path: {launches}")
    loss = [r["loss"] for r in rows]
    check(len(loss) == steps and bool(np.isfinite(loss).all()),
          f"LLM loss not finite: {loss}")
    check(loss[-1] < loss[0], f"LLM loss did not fall: {loss}")
    check(peak < 80e9, f"peak device memory {peak}")
    step_ms = [r["step_time_ms"] for r in rows]
    ms = statistics.median(step_ms[LLM["timed_from"]:])
    per_agent = n // LLM["agents"]
    matmul_params = per_agent - int(np.prod(shapes["embed/table"][1:]))
    S, B, H, hd = LLM["seq"], LLM["batch_per_agent"], cfg.n_heads, cfg.hd()
    nblk = S // cfg.attn_chunk
    computed = (nblk * (nblk + 1) // 2) / nblk ** 2    # causal block skip
    attn = (3 * 4 * B * S * S * H * hd * computed * cfg.n_layers
            * LLM["agents"])
    flops = 6 * matmul_params * tokens + attn
    p0, p1 = LLM["profile"]
    prof_main = window_profile(trace, p1 - p0 + 1, step_ms[p0:p1 + 1],
                               "expsum_update_kernel", up, n_leaves)
    K = TS.TrainConfig().K
    main = {
        "arch": LLM_ARCH, "width": {
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd(),
            "d_ff": cfg.d_ff, "vocab": cfg.vocab, "window": cfg.window,
            "param_dtype": cfg.param_dtype},
        "n_layers": cfg.n_layers, "reduced": LLM_REDUCED,
        "agents": LLM["agents"], "seq": S, "batch_per_agent": B,
        "tokens_per_step": tokens, "params_per_agent": per_agent,
        "n_total": n, "memory_mode": "expsum", "K": K, "T": LLM["T"],
        "acc_dtype": "float32", "steps": steps, "seconds": secs,
        "loss_first": loss[0], "loss_last": loss[-1], "loss": loss,
        "launches": launches,
        "ms_per_step": ms, "ms_per_step_steps": [LLM["timed_from"],
                                                 steps - 1],
        "tokens_per_s": tokens / (ms / 1e3),
        "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak": flops / (ms / 1e3)
        / BF16_FLOPS_PER_S,
        "peak_memory_bytes": peak, "profile_steps": [p0, p1],
        "profile": prof_main,
        "expsum_bound_ms_per_step": bound(68 * n),
        "expsum_bound_ms_at_up": bound(68 * int(np.prod(shapes[
            "blocks/mlp/up/w"])))}
    emit("llm_train", **main)

    # ---------------------------------------------- exact memory (default)
    ex = LLM_EXACT
    cfg_x = cfg.replace(n_layers=ex["n_layers"])
    shapes_x = llm_leaf_shapes(cfg_x, LLM["agents"])
    n_x = sum(int(np.prod(s)) for s in shapes_x.values())
    rows, launches_x, secs, peak_x, trace = train(
        n_layers=ex["n_layers"], memory_mode="exact", T=ex["T"],
        steps=ex["steps"], profile=ex["profile"])
    check(launches_x == {"frodo_exact_update": n_leaves * ex["steps"],
                         "frodo_expsum_update": 0},
          f"exact launches on the LLM path: {launches_x}")
    loss_x = [r["loss"] for r in rows]
    check(bool(np.isfinite(loss_x).all()), f"exact loss: {loss_x}")
    step_ms = [r["step_time_ms"] for r in rows]
    q0, q1 = ex["profile"]
    emb = list(shapes_x).index("embed/table")
    n_emb = int(np.prod(shapes_x["embed/table"]))
    exact = {
        "n_layers": ex["n_layers"], "T": ex["T"], "steps": ex["steps"],
        "n_total": n_x, "seconds": secs, "loss": loss_x,
        "launches": launches_x,
        "ms_per_step": statistics.median(step_ms[1:q0]),
        "ms_per_step_steps": [1, q0 - 1], "peak_memory_bytes": peak_x,
        "profile_steps": [q0, q1],
        "profile": window_profile(trace, q1 - q0 + 1, step_ms[q0:q1 + 1],
                                  "exact_update_kernel", emb, n_leaves),
        "exact_bound_ms_per_step": bound((ex["T"] + 3) * n_x * 2),
        "exact_bound_ms_at_embed": bound((ex["T"] + 3) * n_emb * 2)}

    # ------------------------------------- kernel vs plain, both memory modes
    def vs_loss(mode, T_, **kw):
        rows, *_ = train(n_layers=LLM_VS_PLAIN["n_layers"],
                         seq=LLM_VS_PLAIN["seq"], memory_mode=mode, T=T_,
                         steps=LLM_VS_PLAIN["steps"], **kw)
        return [r["loss"] for r in rows]

    vs = {}
    for mode, T_ in (("exact", LLM_EXACT["T"]), ("expsum", LLM["T"])):
        kern = vs_loss(mode, T_, use_kernel=True)
        plain = vs_loss(mode, T_, use_kernel=False)
        ok, err = close_np(kern, plain, LLM_LOSS_TOL)
        check(ok, f"LLM {mode}: kernel vs plain loss {kern} {plain}")
        planted = {}
        for name, kw in LLM_PLANTED.items():
            passes, e = close_np(kern, vs_loss(mode, T_, use_kernel=False,
                                               **kw), LLM_LOSS_TOL)
            check(not passes, f"LLM {mode}: planted fault {name} passes the "
                  f"loss check ({e})")
            planted[name] = {"max_abs_err": e}
        vs[mode] = {"loss_kernel": kern, "loss_plain": plain,
                    "max_abs_err": err, "planted_faults": planted}

    # ----------------------------------------- card vs CPU, f32 smoke config
    smoke = REG.get_smoke_config(LLM_ARCH).replace(
        param_dtype="float32", compute_dtype="float32")
    init = TS.init_train_state(torch.Generator().manual_seed(0), smoke,
                               TS.TrainConfig(), LLM["agents"]).params
    init_np = TR.tree_map(lambda t: t.numpy(), init)
    card_cpu = {}
    for where in (dev, "cpu"):
        rows, *_ = train(smoke=True, seq=128, param_dtype="float32",
                         steps=LLM_CARD_CPU["steps"], device=where,
                         init_fn=lambda seed: init_np)
        card_cpu["cpu" if where == "cpu" else "card"] = {
            k: [r[k] for r in rows] for k in ("loss", "grad_norm")}
    cc = {}
    for k in ("loss", "grad_norm"):
        ok, err = close_np(card_cpu["card"][k], card_cpu["cpu"][k],
                           CARD_CPU_TOL)
        check(ok, f"LLM smoke f32 {k}, card vs CPU: {card_cpu}")
        cc[k] = err

    # ------------------------------------------ exp-sum, bf16 accumulators
    bf = LLM_BF16_ACC
    rows, launches_b, secs, peak_b, trace = train(
        n_layers=bf["n_layers"], memory_mode="expsum", T=LLM["T"],
        acc_dtype="bfloat16", steps=bf["steps"], profile=bf["profile"])
    check(launches_b == {"frodo_exact_update": 0,
                         "frodo_expsum_update": n_leaves * bf["steps"]},
          f"exp-sum (bf16 acc) launches: {launches_b}")
    loss_b = [r["loss"] for r in rows]
    check(bool(np.isfinite(loss_b).all()), f"bf16-acc loss: {loss_b}")
    step_ms = [r["step_time_ms"] for r in rows]
    b0, b1 = bf["profile"]
    bf16acc = {
        "steps": bf["steps"], "loss": loss_b, "launches": launches_b,
        "seconds": secs, "peak_memory_bytes": peak_b,
        "ms_per_step": statistics.median(step_ms[1:b0]),
        "ms_per_step_steps": [1, b0 - 1],
        "profile_steps": [b0, b1],
        "profile": window_profile(trace, b1 - b0 + 1, step_ms[b0:b1 + 1],
                                  "expsum_update_kernel", up, n_leaves),
        "expsum_bound_ms_per_step": bound(36 * n),
        "expsum_bound_ms_at_up": bound(36 * int(np.prod(shapes[
            "blocks/mlp/up/w"])))}
    emit("llm_train.sub_runs", exact=exact, kernel_vs_plain=vs,
         kernel_vs_plain_tol=LLM_LOSS_TOL, card_vs_cpu_max_abs_err=cc,
         card_vs_cpu_tol=CARD_CPU_TOL, card_vs_cpu=card_cpu,
         card_vs_cpu_steps=LLM_CARD_CPU["steps"], expsum_bf16_acc=bf16acc)

    # ------------------------- both kernels at the largest leaves, > 2^31
    gen = torch.Generator(device=dev).manual_seed(7)

    def bf16_diff(a, b) -> dict:
        """A bf16 delta against its plain version under BF16_DELTA_TOL, one
        slice of the leading dim at a time (keeps the f32 temporaries
        small): the largest |a - b|, the elements past rtol/atol, the share
        of elements that differ at all, and whether that passes."""
        tol = BF16_DELTA_TOL
        worst, n_past, n_diff = 0.0, 0, 0
        for i in range(a.shape[0]):
            x, y = a[i].float(), b[i].float()
            e = (x - y).abs()
            n_past += int((e > tol["atol"] + tol["rtol"] * y.abs()).sum())
            n_diff += int((e > 0).sum())
            worst = max(worst, float(e.max()))
        share = n_diff / a.numel()
        return {"max_abs_err": worst, "elements_past_tol": n_past,
                "share_differing": share,
                "passes": n_past == 0 and share <= tol["max_share_differing"]}

    def truncated(d32):
        """An f32 delta cut to bf16 by truncation instead of rounding."""
        return (d32.view(torch.int32) & -65536).view(torch.float32).to(
            torch.bfloat16)

    def planted(faults: dict, d_ref) -> dict:
        """Each planted fault's delta on a slab against the plain delta
        ``d_ref`` of the same slab: each must fail BF16_DELTA_TOL."""
        out = {}
        for name, d in faults.items():
            r = bf16_diff(d[None], d_ref[None])
            check(not r["passes"], f"planted fault {name} passes the bf16 "
                  f"delta check: {r}")
            out[name] = {k: r[k] for k in ("max_abs_err", "elements_past_tol",
                                           "share_differing")}
        return out

    def bit_equal(a, b) -> bool:
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return all(torch.equal(x.view(view), y.view(view))
                   for x, y in zip(a, b))

    up_shape = shapes["blocks/mlp/up/w"]
    g = torch.randn(up_shape, generator=gen, device=dev).to(torch.bfloat16)
    acc = torch.randn((K,) + up_shape, generator=gen, device=dev)
    rates_np, coeffs_np = fmem.fit_expsum(LLM["T"], 0.15, K)
    rates = torch.tensor(rates_np, dtype=torch.float32)
    coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
    g_s, acc_s = g[0, 0], acc[:, 0, 0].clone()   # a slab, before the update
    a_k = acc.clone()
    d_k = KU.expsum_update(g, a_k, rates, coeffs, 0.02, 0.008)
    d_p, a_p = ref.frodo_expsum_update_ref(g, acc, rates, coeffs, 0.02,
                                           0.008)
    torch.cuda.synchronize(dev)
    d_err = bf16_diff(d_k, d_p)
    check(d_err["passes"], f"exp-sum delta at blocks/mlp/up/w: {d_err}")
    check(bit_equal(a_k, a_p), "exp-sum new accumulators at "
          "blocks/mlp/up/w not bit-equal")
    c0 = coeffs.clone()
    c0[0] *= 1.1
    es_big = {"shape": [K] + list(up_shape), "elements": acc.numel(),
              "delta_max_abs_err": d_err["max_abs_err"],
              "delta_share_differing": d_err["share_differing"],
              "new_acc": "bit-equal",
              "planted_faults_on_slab": planted({
                  "beta_M_x1.1": ref.frodo_expsum_update_ref(
                      g_s, acc_s.clone(), rates, coeffs, 0.02, 0.0088)[0],
                  "c0_x1.1": ref.frodo_expsum_update_ref(
                      g_s, acc_s.clone(), rates, c0, 0.02, 0.008)[0],
                  "truncation": truncated(ref.frodo_expsum_update_ref(
                      g_s.float(), acc_s.clone(), rates, coeffs, 0.02,
                      0.008)[0])}, d_p[0, 0])}
    del a_k, d_k, d_p, a_p, acc_s
    es_big.update(
        ms=cuda_ms(lambda: KU.expsum_update(g, acc, rates, coeffs, 0.02,
                                            0.008), reps=10),
        plain_ms=cuda_ms(lambda: ref.frodo_expsum_update_ref(
            g, acc, rates, coeffs, 0.02, 0.008), reps=3, warmup=1),
        bound_ms=bound(68 * g.numel()), bound_by="bytes", library_ms=None)
    del g, acc

    T_x = LLM_EXACT["T"]
    emb_shape = shapes_x["embed/table"]
    g = torch.randn(emb_shape, generator=gen, device=dev).to(torch.bfloat16)
    hist = torch.randn((T_x,) + emb_shape, generator=gen,
                       device=dev).to(torch.bfloat16)
    mu = torch.tensor(fmem.mu_weights(T_x, 0.15), dtype=torch.float32,
                      device=dev)
    cursor = T_x - 1                           # the push at the top slot
    g_s, h_s = g[0, :4000], hist[:, 0, :4000].clone()
    h_k = hist.clone()
    d_k = KU.exact_update(g, h_k, cursor, mu, 0.02, 0.008)
    d_p, h_p = ref.frodo_update_ref(g, hist, cursor, mu, 0.02, 0.008)
    torch.cuda.synchronize(dev)
    d_err = bf16_diff(d_k, d_p)
    check(d_err["passes"], f"exact delta at embed/table: {d_err}")
    check(bit_equal(h_k, h_p), "exact pushed history at embed/table not "
          "bit-equal")
    ex_big = {"shape": [T_x] + list(emb_shape), "elements": hist.numel(),
              "delta_max_abs_err": d_err["max_abs_err"],
              "delta_share_differing": d_err["share_differing"],
              "pushed_history": "bit-equal",
              "planted_faults_on_slab": planted({
                  "beta_M_x1.1": ref.frodo_update_ref(
                      g_s, h_s.clone(), cursor, mu, 0.02, 0.0088)[0],
                  "slot_weights_off_by_one": ref.frodo_update_ref(
                      g_s, h_s.clone(), cursor - 1, mu, 0.02, 0.008)[0],
                  "truncation": truncated(ref.frodo_update_ref(
                      g_s.float(), h_s.clone(), cursor, mu, 0.02,
                      0.008)[0])}, d_p[0, :4000])}
    del h_k, d_k, d_p, h_p, h_s
    w_slot = fmem.slot_weights(mu, cursor).to(torch.bfloat16)
    ex_big.update(
        ms=cuda_ms(lambda: KU.exact_update(g, hist, cursor, mu, 0.02, 0.008),
                   reps=10),
        plain_ms=cuda_ms(lambda: ref.frodo_update_ref(
            g, hist, cursor, mu, 0.02, 0.008), reps=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.addmv(
            g.view(-1), hist.view(T_x, -1).t(), w_slot, beta=-0.02,
            alpha=-0.008), reps=10),
        bound_ms=bound((T_x + 3) * g.numel() * 2 + T_x * 4),
        bound_by="bytes")
    del g, hist
    torch.cuda.empty_cache()
    emit("llm_train.kernels", nvidia_smi=nvidia_smi(),
         expsum_bf16g_f32acc_at_mlp_up=es_big, exact_bf16_at_embed=ex_big,
         tol={"delta": BF16_DELTA_TOL, "new_acc": "bit-equal",
              "pushed_history": "bit-equal"},
         note="kernel vs plain version on one full leaf each, past 2^31 "
              "elements of state; planted faults in the plain version on a "
              "slab of the same inputs, each failing the delta check; ms by "
              "CUDA events around one wrapper "
              "call; the library call is torch.addmv (exact; no one "
              "PyTorch call does the exp-sum update)")
    return {"launches": {"llm_train": launches,
                         "llm_train_exact": launches_x,
                         "llm_train_expsum_bf16acc": launches_b},
            "expsum": dict(
                es_big, device_ms_at_up=prof_main["kernel_ms_at_leaf"],
                device_ms_per_step=prof_main["kernel_ms_per_step"],
                bound_ms_per_step=main["expsum_bound_ms_per_step"],
                bf16acc_device_ms_at_up=bf16acc["profile"][
                    "kernel_ms_at_leaf"],
                bf16acc_bound_ms_at_up=bf16acc["expsum_bound_ms_at_up"],
                bf16acc_device_ms_per_step=bf16acc["profile"][
                    "kernel_ms_per_step"],
                bf16acc_bound_ms_per_step=bf16acc[
                    "expsum_bound_ms_per_step"]),
            "exact": dict(
                ex_big, device_ms_at_embed=exact["profile"][
                    "kernel_ms_at_leaf"],
                device_ms_per_step=exact["profile"]["kernel_ms_per_step"],
                bound_ms_per_step=exact["exact_bound_ms_per_step"])}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from repro_torch.core import graph as G
    from repro_torch.core import memory as fmem
    from repro_torch.core.frodo import FrodoConfig, frodo
    from repro_torch.data.synthetic import make_classification
    from repro_torch.device import set_full_precision
    from repro_torch.experiments import exp2_federated as E
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops, ref

    set_full_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---------------------------------------------------------------- build
    info = KU.build()
    ptxas = [l.strip() for l in info["log"].splitlines()
             if "registers" in l or "Compiling entry" in l]
    emit("build", seconds=round(info["seconds"], 3), cached=info["cached"],
         library=os.path.relpath(info["path"], ROOT), flags=KU.NVCC_FLAGS,
         ptxas=ptxas)

    gen = torch.Generator(device=dev).manual_seed(0)
    mu = torch.tensor(fmem.mu_weights(T, 0.15), dtype=torch.float32,
                      device=dev)
    rates_np, coeffs_np = fmem.fit_expsum(T, 0.15, K)
    rates = torch.tensor(rates_np, dtype=torch.float32)
    coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def close(a, b, tol):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        ok = bool((err <= tol["atol"] + tol["rtol"] * b.abs()).all())
        return ok, float(err.max()) if err.numel() else 0.0

    # ---------------------------------------------- kernel vs plain version
    shapes = list(EXP2_LEAVES.values()) + TAIL_SHAPES
    exact_err = {}
    for dname, dt in dtypes.items():
        worst = 0.0
        for shape in shapes:
            g = randn(shape, dt)
            hist = randn((T,) + shape, dt)
            for cursor in (0, 3, T - 1):
                h_k, h_p = hist.clone(), hist.clone()
                d_k = KU.exact_update(g, h_k, cursor, mu, ALPHA, BETA)
                d_p, _ = ref.frodo_update_ref(g, h_p, cursor, mu, ALPHA, BETA)
                torch.cuda.synchronize()
                ok, err = close(d_k, d_p, TOL[dname])
                check(ok, f"exact delta {dname} {shape} cursor={cursor}: "
                      f"max abs err {err}")
                check(torch.equal(h_k.view(bits[dt]), h_p.view(bits[dt])),
                      f"exact pushed history {dname} {shape} cursor={cursor}"
                      " not bit-equal")
                if shape in EXP2_LEAVES.values():
                    worst = max(worst, err)
            del hist, h_k, h_p
        exact_err[dname] = worst
    emit("kernels.exact", T=T, shapes=[list(s) for s in shapes],
         cursors=[0, 3, T - 1], max_abs_err=exact_err, tol=TOL,
         pushed_history="bit-equal")

    expsum_err = {}
    for gname, gdt in dtypes.items():
        for aname, adt in dtypes.items():
            worst_d = worst_a = 0.0
            for shape in shapes:
                g = randn(shape, gdt)
                acc = randn((K,) + shape, adt)
                a_k, a_p = acc.clone(), acc.clone()
                d_k = KU.expsum_update(g, a_k, rates, coeffs, ALPHA, BETA)
                d_p, _ = ref.frodo_expsum_update_ref(g, a_p, rates, coeffs,
                                                     ALPHA, BETA)
                torch.cuda.synchronize()
                ok, err_d = close(d_k, d_p, TOL[gname])
                check(ok, f"expsum delta g={gname} acc={aname} {shape}: "
                      f"max abs err {err_d}")
                ok, err_a = close(a_k, a_p, ACC_TOL[aname])
                check(ok, f"expsum new acc g={gname} acc={aname} {shape}: "
                      f"max abs err {err_a}")
                if shape in EXP2_LEAVES.values():
                    worst_d, worst_a = max(worst_d, err_d), max(worst_a, err_a)
            expsum_err[f"g={gname},acc={aname}"] = {"delta": worst_d,
                                                    "new_acc": worst_a}
    emit("kernels.expsum", K=K, shapes=[list(s) for s in shapes],
         max_abs_err=expsum_err, tol={"delta": TOL, "new_acc": ACC_TOL})

    # ------------------------------------------------ Exp 2, full width
    X, y = make_classification(n_per_class=200, n_agents=E.N_AGENTS, seed=0,
                               noise=2.0)
    W = G.xiao_boyd_weights(G.complete(E.N_AGENTS))
    idx = E.batch_indices(0, STEPS, y.shape[1])
    # uploaded once, so no run (nor the profile) counts the copy
    X, y, idx = (torch.as_tensor(X, device=dev),
                 torch.as_tensor(y, dtype=torch.int64, device=dev),
                 torch.as_tensor(idx, dtype=torch.int64, device=dev))
    params0 = E.init_mlp(torch.Generator().manual_seed(0), device=dev)
    n_per_step = len(params0)

    def run(opt):
        return E.train(opt, params0, X, y, idx, W, device=dev)

    KU.reset_launches()
    res_k = run(E.make_optimizer("frodo"))
    launches_exact = dict(ops.LAUNCHES)
    check(launches_exact == {"frodo_exact_update": n_per_step * STEPS,
                             "frodo_expsum_update": 0},
          f"exact launches on the Exp 2 path: {launches_exact}")
    loss_k = res_k["loss"]
    check(bool(np.isfinite(loss_k).all()), "Exp 2 loss not finite")
    check(loss_k[-1] < 0.5 * loss_k[0], f"Exp 2 loss did not fall: {loss_k}")
    res_p = run(frodo(FrodoConfig(alpha=ALPHA, beta=BETA, lam=0.15, T=T,
                                  memory_mode="exact")))
    diff = np.abs(loss_k - res_p["loss"])
    tol = LOSS_TOL["exact"]
    check(bool((diff <= tol["atol"] + tol["rtol"] * np.abs(res_p["loss"]))
               .all()), f"Exp 2 loss, kernel vs plain path: {diff.max()}")
    emit("exp2_exact", steps=STEPS, n_params=E.n_params(params0),
         launches=launches_exact, loss_first=float(loss_k[0]),
         loss_last=float(loss_k[-1]), acc_last=float(res_k["acc"][-1]),
         max_abs_loss_diff_vs_plain=float(diff.max()), tol=tol)

    launches_exp2 = dict(launches_exact)
    for acc_dtype in ("float32", "bfloat16"):
        cfg = dict(alpha=ALPHA, beta=BETA, lam=0.15, T=T,
                   memory_mode="expsum", K=K, acc_dtype=acc_dtype)
        KU.reset_launches()
        res_k = run(frodo(FrodoConfig(**cfg, use_kernel=True)))
        launches = dict(ops.LAUNCHES)
        check(launches == {"frodo_exact_update": 0,
                           "frodo_expsum_update": n_per_step * STEPS},
              f"expsum launches ({acc_dtype}): {launches}")
        launches_exp2["frodo_expsum_update"] += launches[
            "frodo_expsum_update"]
        loss_k = res_k["loss"]
        check(bool(np.isfinite(loss_k).all()) and loss_k[-1] < 0.5 * loss_k[0],
              f"expsum ({acc_dtype}) loss did not fall: {loss_k}")
        res_p = run(frodo(FrodoConfig(**cfg)))
        diff = np.abs(loss_k - res_p["loss"])
        tol = LOSS_TOL[f"expsum_{acc_dtype}"]
        check(bool((diff <= tol["atol"] + tol["rtol"]
                    * np.abs(res_p["loss"])).all()),
              f"expsum ({acc_dtype}) loss, kernel vs plain: {diff.max()}")
        emit("exp2_expsum", acc_dtype=acc_dtype, steps=STEPS,
             launches=launches, loss_first=float(loss_k[0]),
             loss_last=float(loss_k[-1]),
             max_abs_loss_diff_vs_plain=float(diff.max()), tol=tol)

    # --------------------------- faults, Exp 1 and Exp 3 (their own counts)
    faults_phase(dev)
    launches_exp1 = exp1_phase(dev)
    launches_exp3 = exp3_phase(dev)
    llm = llm_train_phase(dev)
    per_path = {name: {"exp2": launches_exp2[name],
                       "exp1_point": launches_exp1[name],
                       "exp3": launches_exp3[name],
                       **{p: c[name] for p, c in llm["launches"].items()}}
                for name in ("frodo_exact_update", "frodo_expsum_update")}

    # ----------------------------------------------------------- timing
    def bound_ms(nbytes, flops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_f = flops / F32_FLOPS_PER_S * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    leaves = {k: torch.randn(s, generator=gen, device=dev)
              for k, s in EXP2_LEAVES.items()}
    n_step = sum(v.numel() for v in leaves.values())
    hists = {k: torch.randn((T,) + tuple(v.shape), generator=gen, device=dev)
             for k, v in leaves.items()}
    g0, h0 = leaves["w0"], hists["w0"]
    n0 = g0.numel()
    w_slot = fmem.slot_weights(mu, 5)

    def exact_bytes(n):   # g, hist read; delta and the pushed slot written
        return (T + 3) * n * 4 + T * 4

    ex = {
        "ms": cuda_ms(lambda: KU.exact_update(g0, h0, 5, mu, ALPHA, BETA)),
        "plain_ms": cuda_ms(lambda: ref.frodo_update_ref(
            g0, h0, 5, mu, ALPHA, BETA), reps=10),
        "library_ms": cuda_ms(lambda: torch.addmv(
            g0.view(-1), h0.view(T, -1).t(), w_slot, beta=-ALPHA,
            alpha=-BETA)),
        "step_ms": cuda_ms(lambda: [KU.exact_update(
            leaves[k], hists[k], 5, mu, ALPHA, BETA) for k in leaves]),
        "step_plain_ms": cuda_ms(lambda: [ref.frodo_update_ref(
            leaves[k], hists[k], 5, mu, ALPHA, BETA) for k in leaves],
            reps=10),
    }
    ex["bound_ms"], ex["bound_by"] = bound_ms(exact_bytes(n0), 2 * T * n0)
    ex["step_bound_ms"], _ = bound_ms(exact_bytes(n_step), 2 * T * n_step)
    ex["per_leaf_ms"] = {k: cuda_ms(lambda k=k: KU.exact_update(
        leaves[k], hists[k], 5, mu, ALPHA, BETA)) for k in leaves}
    del hists, h0

    es = {}
    for aname, adt in dtypes.items():
        accs = {k: torch.randn((K,) + tuple(v.shape), generator=gen,
                               device=dev).to(adt) for k, v in leaves.items()}
        a0 = accs["w0"]
        asz = a0.element_size()

        def expsum_bytes(n):   # g, acc read; delta, acc written
            return 2 * n * 4 + 2 * K * n * asz

        row = {
            "ms": cuda_ms(lambda: KU.expsum_update(g0, a0, rates, coeffs,
                                                   ALPHA, BETA)),
            "plain_ms": cuda_ms(lambda: ref.frodo_expsum_update_ref(
                g0, a0, rates, coeffs, ALPHA, BETA), reps=10),
            "library_ms": None,
            "step_ms": cuda_ms(lambda: [KU.expsum_update(
                leaves[k], accs[k], rates, coeffs, ALPHA, BETA)
                for k in leaves]),
            "step_plain_ms": cuda_ms(lambda: [ref.frodo_expsum_update_ref(
                leaves[k], accs[k], rates, coeffs, ALPHA, BETA)
                for k in leaves], reps=10),
        }
        row["bound_ms"], row["bound_by"] = bound_ms(expsum_bytes(n0),
                                                    4 * K * n0)
        row["step_bound_ms"], _ = bound_ms(expsum_bytes(n_step),
                                           4 * K * n_step)
        es[aname] = row
        del accs, a0

    def step_ms(opt_fn, reps=3):
        run(opt_fn())                                   # warm-up
        return statistics.median(run(opt_fn())["step_time_ms"]
                                 for _ in range(reps))

    exp2_ms = {
        "frodo_exact_kernel": step_ms(lambda: E.make_optimizer("frodo")),
        "frodo_exact_plain": step_ms(lambda: frodo(FrodoConfig(
            alpha=ALPHA, beta=BETA, lam=0.15, T=T))),
        "frodo_expsum_kernel_f32acc": step_ms(lambda: frodo(FrodoConfig(
            alpha=ALPHA, beta=BETA, lam=0.15, T=T, memory_mode="expsum",
            K=K, use_kernel=True))),
        "gd": step_ms(lambda: E.make_optimizer("gd")),
    }
    emit("timing", nvidia_smi=smi, w0_numel=n0, step_numel=n_step,
         exact_f32=ex, expsum_g_f32=es, exp2_ms_per_step=exp2_ms,
         note="kernel rows at the w0 leaf (2,784,1024) f32, CUDA events "
              "around one wrapper call (host launch path included); step_* "
              "over the six Exp 2 leaves; exp2_ms_per_step: host clock over "
              "40 steps ending in a device sync, median of 3 runs")

    # --------------------------------------------- profile (device time)
    def per_launch_us(fn, reps=20):
        rows = device_kernel_us(lambda: [fn() for _ in range(reps)])
        mine = {k: v for k, v in rows.items() if "_update_kernel" in k}
        if not mine:
            return None
        count, us = map(sum, zip(*mine.values()))
        return us / count

    hists = {k: torch.randn((T,) + tuple(v.shape), generator=gen, device=dev)
             for k, v in leaves.items()}
    accs = {k: torch.zeros((K,) + tuple(v.shape), device=dev)
            for k, v in leaves.items()}
    leaf_us = {k: {
        "exact_f32": per_launch_us(lambda k=k: KU.exact_update(
            leaves[k], hists[k], 5, mu, ALPHA, BETA)),
        "expsum_f32acc": per_launch_us(lambda k=k: KU.expsum_update(
            leaves[k], accs[k], rates, coeffs, ALPHA, BETA))}
        for k in leaves}
    del hists, accs

    # the exact kernel at the leaves of this slice's paths (T = 90 weights;
    # the Exp 1 point pads the buffer to 100 slots with zero weights)
    mu90 = torch.tensor(fmem.mu_weights(90, 0.15), dtype=torch.float32,
                        device=dev)
    slice_us = {}
    for label, (slots, shape) in {"exp3_federated_w0": (90, (4, 784, 64)),
                                  "exp3_quadratic": (90, (4, 2)),
                                  "exp1_point": (100, (4, 2))}.items():
        g = torch.randn(shape, generator=gen, device=dev)
        h = torch.randn((slots,) + shape, generator=gen, device=dev)
        w = torch.zeros(slots, device=dev)
        w[:90] = mu90
        n = g.numel()
        slice_us[label] = {
            "slots": slots, "shape": list(shape),
            "device_us": per_launch_us(lambda: KU.exact_update(
                g, h, 5, w, ALPHA, BETA)),
            "event_us": 1e3 * cuda_ms(lambda: KU.exact_update(
                g, h, 5, w, ALPHA, BETA)),
            "bound_us": 1e3 * bound_ms((slots + 3) * n * 4 + slots * 4,
                                       2 * slots * n)[0]}

    prof_steps = 10
    prof_idx = idx[:prof_steps]
    breakdown = {}
    for label, opt_fn in (("frodo_exact_kernel",
                           lambda: E.make_optimizer("frodo")),
                          ("gd", lambda: E.make_optimizer("gd"))):
        E.train(opt_fn(), params0, X, y, prof_idx, W, device=dev)  # warm-up
        rows = device_kernel_us(lambda: E.train(opt_fn(), params0, X, y,
                                                prof_idx, W, device=dev))
        total_us = sum(us for _, us in rows.values())
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]
        dev_ms = total_us / prof_steps / 1e3
        breakdown[label] = {
            "device_ms_per_step": dev_ms if rows else None,
            "device_busy_share": (dev_ms / exp2_ms[label]) if rows else None,
            "kernels_per_step": (sum(c for c, _ in rows.values())
                                 / prof_steps) if rows else None,
            "top_kernels": [{"name": name[:90], "launches": c,
                             "us_per_step": us / prof_steps}
                            for name, (c, us) in top]}
    emit("profile", nvidia_smi=smi, kernel_device_us_per_launch=leaf_us,
         exact_kernel_on_slice_paths=slice_us,
         slice_paths_per_round=slice_profile(dev),
         exp2_steps_profiled=prof_steps, exp2=breakdown,
         note="torch.profiler (CUPTI) device time; busy share = device "
              "ms/step over the unprofiled host-clock ms/step of the timing "
              "phase")

    src = "src/repro_torch/kernels/csrc/frodo_update.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "step_ms", "step_plain_ms", "step_bound_ms")
    kernels = [
        {"name": "frodo_exact_update", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/frodo_update.py:55",
         "launches": sum(per_path["frodo_exact_update"].values()),
         "launches_per_path": per_path["frodo_exact_update"],
         "max_abs_err": exact_err["float32"],
         "shape": [T] + list(EXP2_LEAVES["w0"]), "dtype": "float32",
         **{k: ex[k] for k in keys}, "llm_bf16_at_embed": llm["exact"]},
        {"name": "frodo_expsum_update", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/frodo_update.py:93",
         "launches": sum(per_path["frodo_expsum_update"].values()),
         "launches_per_path": per_path["frodo_expsum_update"],
         "max_abs_err": max(expsum_err["g=float32,acc=float32"].values()),
         "shape": [K] + list(EXP2_LEAVES["w0"]), "dtype": "float32",
         **{k: es["float32"][k] for k in keys},
         "llm_bf16g_f32acc_at_mlp_up": llm["expsum"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
