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
6. timing: CUDA-event medians of each kernel, its plain version and (exact)
   one library call, beside the memory bound; the Exp 2 ms/step;
7. profile: torch.profiler device time per launch of each kernel at each
   Exp 2 leaf, and an Exp 2 step's device time, busy share and top kernels.

Then the ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result.
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
    """Device time of each kernel that ``fn`` runs, from torch.profiler
    (CUPTI): ``{name: (launches, total_us)}``.  Empty if the profiler saw
    no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        out[e.key] = (e.count, float(us))
    return out


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

    expsum_launches = 0
    for acc_dtype in ("float32", "bfloat16"):
        cfg = dict(alpha=ALPHA, beta=BETA, lam=0.15, T=T,
                   memory_mode="expsum", K=K, acc_dtype=acc_dtype)
        KU.reset_launches()
        res_k = run(frodo(FrodoConfig(**cfg, use_kernel=True)))
        launches = dict(ops.LAUNCHES)
        check(launches == {"frodo_exact_update": 0,
                           "frodo_expsum_update": n_per_step * STEPS},
              f"expsum launches ({acc_dtype}): {launches}")
        expsum_launches += launches["frodo_expsum_update"]
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
         "launches": launches_exact["frodo_exact_update"],
         "max_abs_err": exact_err["float32"],
         "shape": [T] + list(EXP2_LEAVES["w0"]), "dtype": "float32",
         **{k: ex[k] for k in keys}},
        {"name": "frodo_expsum_update", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/frodo_update.py:93",
         "launches": expsum_launches,
         "max_abs_err": max(expsum_err["g=float32,acc=float32"].values()),
         "shape": [K] + list(EXP2_LEAVES["w0"]), "dtype": "float32",
         **{k: es["float32"][k] for k in keys}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
