#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``.
Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both FrODO update kernels compiled from ``src/repro_torch/kernels/
   csrc/frodo_update.cu`` (its objects side by side), with each kernel
   instantiation's registers; then the CPU halves of the trainers'
   card-vs-CPU checks start in a process of their own beside the card's
   work;
3. kernels: each kernel against its plain version (``kernels/ref.py``) at the
   Exp 2 leaf shapes and at tail sizes, f32 and bf16; the exp-sum kernel
   at K = 1, 4, 8 and 16, each shape also one element into its buffers
   (the unaligned, scalar path), its new accumulators bit-equal;
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
   representative point through ``core.loop`` with the exact kernel at
   T = 90 padded to 100 slots (one launch per round after the first),
   against the inline trace (its telemetry trace is held against
   ``benchmarks/baselines/exp1.json`` in the regress phase);
8. exp3: Exp 3 at the regression scale (seed 0, 400 quadratic and 50
   federated rounds) through ``repro_torch.experiments.regress.check``:
   its quadratic series (``keep``) against
   ``benchmarks/baselines/exp3.json``, the exact-kernel launches of the
   FrODO arms, kernel vs plain path per round, the >= 2x robustness
   headline at 30% drop; ms per round; then the default scale (2000 / 150),
   timed, in both drop modes.  It runs in a process of its own beside
   the serving phase (10), and the symmetric default scale in another,
   followed there by regress (13) and ablations (14); their lines come
   after that phase's;
9. llm_train: the LLM trainer (``repro_torch.launch.train.run_training``)
   on h2o-danube-1.8b at full width, depth cut to 8 layers, seq 4096, 2
   agents x 2 sequences, FrODO exp-sum memory (K = 8, f32 accumulators)
   through the exp-sum kernel on bf16 leaves: 12 steps, a falling loss,
   144 launches, ms/step, tokens/s, peak memory, the step's model and
   executed FLOPs (``utils.flops.train_flops``) and ``mfu`` (model FLOPs
   over the step time and 989.4 TFLOP/s, on every llm_train line), and a
   3-step
   torch.profiler window (the kernel's device time per step and at
   ``blocks/mlp/up/w``, the top kernels, the busy share); then the
   exact-memory sub-run (2 layers, T = 40, through the exact kernel),
   kernel vs plain path in both memory modes (1 layer, seq 512; planted
   faults must fail the same limit), the card
   against the card machine's CPU (smoke config, f32, 12 steps), exp-sum
   with bf16 accumulators (5 steps), and both kernels against their plain
   versions on one full leaf each, past 2^31 elements of state (delta
   within one bf16 ulp at few elements, state bit-equal; planted faults in
   the plain version must fail the same check); then the mamba2-780m
   sub-run (``llm_train.mamba2``): full width and depth, the same shape and
   exp-sum settings, on a tree of bf16 leaves and three f32 ones; a
   falling finite loss, 11 launches a step, kernel vs plain path, card vs
   the card machine's CPU at the f32 smoke config; then the MoE and MLA
   sub-runs (``llm_train.qwen3-moe-30b-a3b``, ``llm_train.minicpm3-4b``):
   full width, the same shape, exp-sum through the kernel (qwen3-moe: 1
   layer, bf16 accumulators; minicpm3: 6 layers), profiled, a falling
   loss, peak memory under 72 GB, kernel vs plain path at 1 layer, seq 512
   (a planted alpha 10% high must fail it), card vs CPU at the f32 smoke
   config; and minicpm3's exact-memory sub-run through the exact kernel;
   then the vision and audio sub-runs (``llm_train.phi-3-vision-4.2b``,
   ``llm_train.whisper-tiny``), as the MoE and MLA ones: phi-3-vision at
   full width with 6 of 32 layers and 576 patch embeddings a sequence, 10
   steps; whisper-tiny at full width and depth (4 encoder layers over
   1,500 frames, 4 decoder layers), 20 steps; then the hybrid sub-run
   (``llm_train.recurrentgemma-9b``) the same way at full width with one
   group of 3 layers (rec, rec, local attention), exp-sum K = 4 with bf16
   accumulators, its kernel vs plain path at 3 layers; and the exp-sum
   kernel at K = 4 against its plain version on its tied embedding of
   both agents (``llm_train.kernels_k4``: 8.4 B elements of bf16 state);
10. serve: the serving launcher (``repro_torch.launch.serve``) on
    h2o-danube-1.8b, mamba2-780m, qwen3-moe-30b-a3b, minicpm3-4b,
    phi-3-vision-4.2b, whisper-tiny, recurrentgemma-9b and nemotron-4-15b:
    its default
    trace on the card and on the card machine's CPU (smoke configs, f32:
    equal tokens and step columns); decode (``prefill_cache``, every
    position's logits; for whisper from the cross K/V that
    ``encode_for_decode`` wrote) against the full-sequence forward (over
    the same frames) at full width and depth, in bf16 and in f32 (the MoE
    and MLA models' f32 runs at 4 layers, recurrentgemma's at 5), and with
    ring buffers that wrap (h2o-danube's window; recurrentgemma's local
    attention), where planted faults on copies of the modules' source
    must fail the same check; traffic at full width (16 requests, or 8 for
    the MoE, MLA, vision and hybrid models; 8 slots; each whisper request
    with its own frames; qwen3-moe, minicpm3, mamba2, h2o-danube,
    recurrentgemma and phi-3-vision at the cut depths of
    SERVE_TRAFFIC_LAYERS, whisper-tiny at full depth) with
    the first requests run alone and ``Engine.generate`` bit-equal to the
    packed run; tokens/s, TTFT, ms per step by phase and per prefill token, the
    busy share, peak memory, and one decode step over the full arena
    beside its weight-read bound.  The models run in the groups of
    SERVE_GROUPS: qwen3-moe-30b-a3b and nemotron-4-15b in this process
    beside mamba2-780m and whisper-tiny in a process of their own, then
    minicpm3-4b here beside h2o-danube-1.8b in one process and
    phi-3-vision-4.2b and recurrentgemma-9b in another;
10b. serve.late (after 16b, before 16c): kimi-k2-1t-a32b at full width
    and 2 of its 61 layers (one dense, one MoE: 384 experts top 8, the
    shared expert, the 163,840 head; SERVE_LAYERS), alone on the card
    (SERVE_LATE says why): the default
    trace card vs CPU, decode against forward in bf16 only, where the
    shared expert left out and ``top_w`` not renormalised, planted in
    decode's copy of ``moe``, must fail; its first MoE layer against the
    plain version (``plain_grouped_moe`` with the shared expert) at the
    config's capacity (tokens drop) and at no-drop, where the shared
    expert left out and the tokens to expert 0 dropped must fail; traffic
    as in 10 (each decode step beside the bytes it reads); peak memory;
11. dryrun: ``repro_torch.launch.dryrun --all`` over the ten architectures
    x four shapes on the meta path (each record ``ok`` or skipped with
    ``registry.shape_supported``'s reason), then ``--probe`` on
    h2o-danube-1.8b x train_4k at global batch 4 (exp-sum K = 8, f32
    accumulators, through the exp-sum kernel): steps at 2 and 3 layers,
    their peak memory and device ms extrapolated to 24 layers and to the
    llm_train run's 8, beside that run's readings;
12. roofline: ``repro_torch.experiments.roofline`` over those records,
    headed by the card's name and power limit: its row count and the
    probed pair's terms and ``mfu_bound``;
13. regress: ``repro_torch.experiments.regress --check --exp exp1``
    against the committed baseline; ``--record`` then ``--check`` into a
    temp dir for serve (the port's serve bench), train and exp2;
14. ablations: the four arms of ``repro_torch.experiments.ablations``
    (lambda, K, interval H, accumulator dtype) through both kernels at
    ABLATION_ROUNDS rounds; each run's error trajectory against the plain
    path's on the card, where a planted fault must fail;
15. harness: ``repro_torch.experiments.run consensus roofline
    ablations`` (consensus timed by CUDA events);
16. distributed: the collective forms (``core.consensus``) on NCCL at world
    size 1 against ``mix_stacked`` (and whether NCCL's send to self ran
    ``ring_mix``); h2o-danube-1.8b at full width, 2 layers, seq 4096, 2
    agents x 2 sequences, exp-sum K = 8 with f32 accumulators through the
    kernel, a clip that binds, 4 steps: the one-process stacked run, the
    agent-sharded step at world size 1 on NCCL (bit-equal to it), and two
    ranks (one agent each) sharing the card over gloo, each held against
    the stacked run (every agent's loss, its accumulators' norms, its
    parameters within two bf16 ulps), with ms/step, the all-reduce's ms and
    bytes a step, peak memory and the exp-sum kernel's launches per rank;
    a consensus skipped on rank 1 and a clip norm left unreduced must fail
    the same check; then grouped MoE dispatch at qwen3-moe-30b-a3b's full
    width (one MoE layer, 2 x 4096 tokens, bf16, 4 groups) against one
    group at an ample capacity and against a plain per-group version at
    the config's;
16b. tensor_parallel: the same trainer on a (data 2, model 2) mesh, four
    gloo ranks sharing the card, each holding its agent's shards
    (``train_state_specs``), against the distributed phase's stacked run
    (every agent's loss, the whole accumulator and parameter norms, the
    clip norm against the spec tree's, the gathered parameters within
    two bf16 ulps, replicated leaves bit-equal across model ranks, each
    rank's state at most 0.55 of an agent's, the exp-sum launches per
    rank), with ms/step, the all-reduce's ms, bytes and calls a step by
    group and peak memory per rank; the same ranks then take 2 steps with
    exact memory at T = 8 (the exact kernel on every local shard) against
    a stacked exact run at T = 8 (the same checks, the history's norms in
    place of the accumulators'); then ``make_prefill`` (2 x 512) and
    32 ``make_serve_step`` steps (batch 8, a 4,096-slot cache split over
    "model") on two ranks under ``serve_rules`` at 4 layers, against the
    one-process units (f32: logits rtol 1e-4, tokens equal; bf16: within
    the decode limit); a row-parallel reduce skipped in layer 0, a clip
    norm counting replicated leaves on every model rank and a
    partial-softmax combine without its max rescale must fail; then the
    two serving ranks take the families of ``TP_FAMILIES`` in turn at full
    width (phi-3-vision-4.2b, minicpm3-4b, whisper-tiny, mamba2-780m,
    qwen3-moe-30b-a3b, recurrentgemma-9b; the ``tensor_parallel.families``
    line): 2 bf16 exp-sum train steps (minicpm3 and mamba2 also 2 exact
    steps at T = 8), an f32 prefill and 16 decode steps, each against the
    one-process units this process runs meanwhile (the same limits), with
    a planted fault per family but phi-3-vision that must fail;
16c. fsdp: the fsdp and batch rules over "data" beside the "model" axis:
    four gloo ranks sharing the card at (data 2, model 2) under
    ``build_rules`` of the fsdp configs (one agent, its rows one a data
    rank, each layer's fsdp leaves split over "data" and gathered at use):
    qwen3-32b at full width (2 of 64 layers, bf16, exp-sum K = 4 with bf16
    accumulators, seq 2048, a clip that binds, 2 steps), qwen3-moe-30b-a3b
    (1 of 48 layers: 1 exp-sum step of 2 microbatches over 4 rows with
    labels masked unequally and a capacity factor of 0.5, microbatch m on
    the ranks the JAX step's m-th, then 2 exact steps at T = 8) and its
    layer 0's MoE forward (the aux loss over every rank's rows), then
    qwen3-32b's f32 prefill (2 x 256) and 2 greedy decode steps under
    ``serve_rules(..., weights_fsdp=True)``; each against the one-process
    run of the same batch, made before the ranks start (losses rtol 1e-4,
    the clip norm against the spec tree's, every shard within 2 bf16 ulps
    of the same slice (or twice the one-process spread through cuBLASLt),
    replicas bit-equal, f32 logits rtol 1e-4 with equal tokens, each
    rank's state at most 0.45 of the agent's, the ranks' peaks summed
    under 72 GB, the kernels' launches a rank); collectives a step by
    group ("data", "model"); replicated leaves counted on both data ranks
    in the clip (the norm those flags give over qwen3-32b's first
    gradient), the batch sum skipped (the clip norm and the replicas of
    qwen3-moe's first exact gradient before its sum), microbatches cut
    from each rank's own rows (one microbatched step) and MoE's load
    balance over each rank's own means must fail;
17. timing: CUDA-event medians of each kernel, its plain version and (exact)
   one library call, beside the memory bound; the Exp 2 ms/step;
18. profile: torch.profiler device time per launch of each kernel at each
    Exp 2 leaf, and an Exp 2 step's device time, busy share and top kernels;
19. kernel_bench: the rows of ``repro_torch.experiments.kernel_bench``,
    each kernel held against its plain version on the row's inputs (at
    qwen3-moe's ``experts/gate`` the bf16 exp-sum state is past 2^31
    elements), with planted faults in the plain version that must fail.

A phase line whose phase ran beside processes of its own (``start_phase``:
the CPU references, Exp 3, the regress and ablation phases, serving's
groups) names them under ``concurrent_with``; its times include their load
on the card and the host.

Then the ``{"kernels": [...]}`` summary line (launches per path: exp2,
exp1_point, exp3, llm_train, llm_train_exact, llm_train_expsum_bf16acc,
llm_train_mamba2, llm_train_qwen3_moe, llm_train_minicpm3,
llm_train_minicpm3_exact, llm_train_phi3_vision, llm_train_whisper,
llm_train_recurrentgemma, serve_<arch> for the nine served models
(none on the serve paths), dryrun_probe, ablations,
distributed_stacked, distributed_world1, distributed_2ranks,
tensor_parallel_4ranks, tensor_parallel_stacked_exact,
tensor_parallel_exact_4ranks, tensor_parallel_families_2ranks (the ranks'
sums), tensor_parallel_families_one_process, and fsdp_{dense,moe,
moe_exact}_{4ranks,one_process}, each counted from 0 just before the path
runs), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
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
    """One phase's JSON line, with the script's seconds so far and, where
    processes of start_phase ran beside it (since the previous line), their
    labels under ``concurrent_with``: its times then include their load on
    the card and the host.  finish_phase adds the same key to such a
    process's own lines."""
    if _SINCE:
        kw = {**kw, "concurrent_with": sorted(_SINCE)}
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0,
                      **kw}), flush=True)
    _SINCE.clear()
    _SINCE.update(_RUNNING)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# --------------------------------------------- phases in a process of their own
#: Host-bound phases (Exp 3's round loops, serving's dispatch) leave the
#: card idle most of the time, so some run in a process of their own beside
#: the main one.  On an H100 (700 W), two Exp 3 sweeps side by side each
#: took what one took alone (21.4 and 20.2 s against 21.8), whisper-tiny's
#: traffic beside one took 8.1 s against 7.3, and a bf16 GEMM loop beside
#: one ran 11% slower.  Such a process prints its phase lines into a file,
#: which this process prints when it joins it; its lines' ``t_s`` read the
#: same clock (``time.perf_counter`` is CLOCK_MONOTONIC).
PHASE_THREADS = 2          # intra-op CPU threads of such a process
_CHILDREN = []             # every such process, stopped if the run fails
_RUNNING = []              # labels of such processes started, not yet joined
_STARTED = []              # labels of such processes, in the order started
_SINCE = set()             # labels of those alive since the last emit


def _phase_entry(_i: int, name: str, args: tuple, out_dir: str,
                 t0: float) -> None:
    """Runs ``globals()[name](cuda:0, *args)`` with stdout to ``out_dir``
    and its result pickled there."""
    import pickle

    import torch
    from repro_torch.device import set_full_precision

    global T0
    T0 = t0
    fd = os.open(os.path.join(out_dir, "stdout"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    torch.set_num_threads(PHASE_THREADS)
    set_full_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = globals()[name](dev, *args)
    with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
        pickle.dump(out, f)


def start_phase(fn, *args):
    """Starts ``fn(cuda:0, *args)`` in a spawned process; returns a handle
    for :func:`finish_phase`."""
    import torch.multiprocessing as mp

    label = fn.__name__
    if args and isinstance(args[0], tuple):
        label += f"[{','.join(args[0])}]"
    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{fn.__name__}_")
    beside = {"main", *_RUNNING}
    ctx = mp.start_processes(_phase_entry, args=(fn.__name__, args, out_dir,
                                                 T0),
                             nprocs=1, join=False, start_method="spawn")
    _CHILDREN.append(ctx)
    _RUNNING.append(label)
    _STARTED.append(label)
    _SINCE.add(label)
    return ctx, out_dir, label, beside, len(_STARTED)


def finish_phase(handle):
    """Waits for the process, prints its phase lines, returns ``fn``'s
    result; raises if the process raised."""
    import pickle

    ctx, out_dir, label, beside, n_started = handle
    try:
        while not ctx.join():
            pass
    finally:
        _RUNNING.remove(label)
        # the processes that ran beside it: those running when it started
        # and those started after it
        beside = sorted(beside | set(_STARTED[n_started:]))
        with open(os.path.join(out_dir, "stdout")) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except ValueError:
                    row = None
                if isinstance(row, dict) and "phase" in row:
                    line = json.dumps({**row, "concurrent_with": beside})
                    line += "\n"
                sys.stdout.write(line)
        sys.stdout.flush()
    with open(os.path.join(out_dir, "result.pkl"), "rb") as f:
        return pickle.load(f)


def stop_children() -> None:
    for ctx in _CHILDREN:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events)."""
    from repro_torch.experiments.kernel_bench import cuda_us
    return cuda_us(fn, reps, warmup) / 1e3


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


def regress_passed(name: str, diffs) -> dict:
    """Raise unless every diff of a ``repro_torch.experiments.regress``
    check against ``benchmarks/baselines/<name>.json`` passed; a summary
    of the check otherwise."""
    from repro_torch.obs import regress as R
    check(bool(diffs) and all(d.passed for d in diffs),
          f"{name} against its baseline:\n{R.format_report(diffs)}")
    return {"series": len({d.group for d in diffs}), "checks": len(diffs),
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
    sweep on the CPU; its headline claims; the representative point
    through core.loop with the exact kernel at T = 90 padded to 100 slots.
    Its telemetry trace is held against the committed baseline in the
    regress phase."""
    import numpy as np
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core import loop
    from repro_torch.core.frodo import FrodoConfig, frodo
    from repro_torch.experiments import exp1_quadratic as E1
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops

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
         telemetry_vs_baseline="the regress phase (repro_torch.experiments."
         "regress --check --exp exp1)",
         point={"alpha": 0.8, "beta": 0.35, "lam": 0.15, "T": 90,
                "pad_T": 100, "rounds": K, "launches": launches,
                "max_abs_err_vs_inline": err, "tol": POINT_TOL,
                "iters_to_1e-6": loop.iterations_to_tol(res["errors"])})
    return launches


#: Exp 3's default scale runs in both drop modes: the first in the exp3
#: phase's process, the second in host_phases'
EXP3_MODES = ("directed", "symmetric")


def _exp3_launches(q: int, f: int) -> dict:
    """The exact kernel's launches of one Exp 3 run at q quadratic and f
    federated rounds: its FrODO arms, each drop rate, 4 leaves (w0, b0,
    w1, b1) a federated round."""
    from repro_torch.experiments import exp3_faults as E3
    return {"frodo_exact_update": (1 + len(E3.DROP_RATES))
            * ((q - 1) + 4 * f), "frodo_expsum_update": 0}


def exp3_default_scale(dev, mode: str) -> dict:
    """Exp 3 at its default scale (2000 / 150 rounds) in one drop mode,
    timed: the exact kernel's launches and the robustness headline."""
    from repro_torch.experiments import exp3_faults as E3
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops

    KU.reset_launches()
    t0 = time.perf_counter()
    s = E3.run_experiment(seed=0, quad_steps=2000, fed_steps=150,
                          device=dev, drop_mode=mode)
    secs = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    check(got == _exp3_launches(2000, 150),
          f"exact launches on Exp 3 ({mode}, default scale): {got}")
    check(s["quadratic"]["drop30"]["dgd_over_frodo_iters"] >= 2.0,
          f"robustness headline ({mode}, default scale): "
          f"{s['quadratic']['drop30']}")
    return {
        "seconds": secs, "launches": got["frodo_exact_update"],
        "dgd_over_frodo_iters": {t: r["dgd_over_frodo_iters"]
                                 for t, r in s["quadratic"].items()},
        "frodo_iters_to_tol": {t: r["frodo"]["iters_to_tol"]
                               for t, r in s["quadratic"].items()},
        "federated_final_loss_frodo": {
            t: r["frodo"]["final_loss"] for t, r in s["federated"].items()
            if isinstance(r, dict)}}


def exp3_phase(dev, modes: tuple = EXP3_MODES) -> dict:
    """Exp 3 at the regression scale on the card: the quadratic series
    against the committed baseline, exact-kernel launches, kernel vs plain
    path, the robustness headline; then the default scale, timed, in the
    drop modes ``modes``."""
    from repro_torch.experiments import exp3_faults as E3
    from repro_torch.experiments import regress as RG
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.obs import regress as R

    quad, fed = 400, 50                            # benchmarks/regress.py

    # the baseline's meta replays seed 0, 400 quadratic rounds (and so 50
    # federated rounds and a 60-step window): regress.run_exp3's scale
    KU.reset_launches()
    t0 = time.perf_counter()
    diffs = RG.check("exp3", RG.DEFAULT_BASELINE_DIR,
                     R.Tolerance(**REGRESS_TOL), None, None,
                     include_timing=False,
                     keep=lambda label: "quadratic-" in label, device=dev)
    reg_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    summary = diffs.summary
    want = _exp3_launches(quad, fed)
    check(launches == want, f"exact launches on Exp 3: {launches} != {want}")
    base = regress_passed("exp3", diffs)
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

    default = {mode: exp3_default_scale(dev, mode) for mode in modes}
    emit("exp3", seed=0, quad_steps=quad, fed_steps=fed, metrics_steps=60,
         seconds=reg_s, launches=launches,
         quadratic_vs_baseline=dict(base, through="repro_torch.experiments."
                                    "regress.check(keep=quadratic-*)"),
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
#: ms/step is the median of steps 6-11: the window's steps run under the
#: profiler, and step 5, the one after it, also times the trace's export.
#: 12 steps (20 until the fsdp phase took the 8 steps' ~16 s)
LLM = dict(n_layers=8, seq=4096, batch_per_agent=2, agents=2, steps=12,
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
# Card vs CPU at f32 (TF32 off): the same arithmetic in other sum orders
# (~1e-6 relative per step), carried over 12 steps of training.
CARD_CPU_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_FLOPS_PER_S = 989.4e12                 # H100 SXM5, dense bf16
#: the llm_train sub-run on mamba2-780m at full width: the train_4k shape,
#: 2 agents x 2 sequences, exp-sum K = 8 with f32 accumulators through the
#: exp-sum kernel, on a tree of bf16 leaves and three f32 ones (A_log, D,
#: dt_bias).  ms/step is the median of steps 1-7.
MAMBA2_ARCH = "mamba2-780m"
LLM_MAMBA2 = dict(n_layers=48, steps=8)
LLM_MAMBA2_REDUCED = {
    "global_batch": "256 -> 4 (2 agents x 2 sequences of train_4k's 4096)"}


def leaf_names(tree, prefix="") -> list:
    """``a/b/c`` names of a parameter tree's leaves in the port's (sorted)
    flatten order: the order the optimizer launches one kernel per leaf."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def meta_leaves(cfg, agents: int) -> dict:
    """The model's parameter leaves, agent-stacked, by name in flatten
    order: tensors on the meta device (shape and dtype, no storage)."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.models import transformer as TM

    tree = TM.init_params(torch.Generator(), cfg, (agents,), device="meta")
    return dict(zip(leaf_names(tree), TR.leaves(tree)))


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


def llm_run(dev, **kw):
    """One run_training call on ``kw``'s settings (the llm_train phase's
    defaults otherwise); returns its sink rows, its launches (counted from 0
    just before), its seconds, its peak device memory (0 for a run on the
    CPU) and its profile trace path (or None)."""
    import torch
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training
    from repro_torch.obs.metrics import read_jsonl

    tmp = tempfile.mkdtemp(prefix="llm_run_")
    prof = kw.pop("profile", None)
    args = dict(arch=LLM_ARCH, smoke=False, agents=LLM["agents"],
                seq=LLM["seq"], batch_per_agent=LLM["batch_per_agent"],
                seed=0, device=dev, use_kernel=True,
                metrics_out=os.path.join(tmp, "metrics.jsonl"))
    if prof is not None:
        args.update(profile_dir=tmp, profile_start=prof[0],
                    profile_stop=prof[1])
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
    trace = os.path.join(tmp, "trace.json") if prof is not None else None
    return rows, launches, secs, peak, trace


def _card_cpu_K(arch: str) -> int:
    """The exp-sum K of ``arch``'s trainer runs (the card-vs-CPU run's)."""
    from repro_torch.training import train_step as TS
    runs = {**LLM_NEW, **LLM_VLM_AUDIO, **LLM_HYBRID, **LLM_NEMOTRON}
    return runs.get(arch, {}).get("K", TS.TrainConfig().K)


#: the trainers whose card-vs-CPU check takes its CPU half from
#: cpu_references, in the order the checks need them
CPU_REFERENCES = (LLM_ARCH, MAMBA2_ARCH, "qwen3-moe-30b-a3b", "minicpm3-4b",
                  "phi-3-vision-4.2b", "whisper-tiny", "recurrentgemma-9b",
                  "nemotron-4-15b")
_CPU_REFS: dict = {}        # "handle": a start_phase handle, then its result


def _cpu_reference(arch: str) -> tuple:
    """``arch``'s f32 smoke config trained LLM_CARD_CPU steps on the CPU:
    (its initial weights, its losses and grad norms)."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.training import train_step as TS

    smoke = REG.get_smoke_config(arch).replace(param_dtype="float32",
                                               compute_dtype="float32")
    init = TR.tree_map(lambda t: t.numpy(), TS.init_train_state(
        torch.Generator().manual_seed(0), smoke, TS.TrainConfig(),
        LLM["agents"]).params)
    rows, *_ = llm_run("cpu", arch=arch, smoke=True, seq=128,
                       param_dtype="float32", K=_card_cpu_K(arch),
                       steps=LLM_CARD_CPU["steps"], device="cpu",
                       init_fn=lambda seed: init)
    return init, {k: [r[k] for r in rows] for k in ("loss", "grad_norm")}


def cpu_references(_dev) -> dict:
    """``_cpu_reference`` of each of CPU_REFERENCES: the CPU work of the
    trainers' card-vs-CPU checks, in a process of its own beside the
    card's work (start_cpu_references)."""
    return {arch: _cpu_reference(arch) for arch in CPU_REFERENCES}


def start_cpu_references() -> None:
    _CPU_REFS["handle"] = start_phase(cpu_references)


def cpu_reference(arch: str) -> tuple:
    """``arch``'s CPU half: from cpu_references' process if it was started
    (waiting for it once), else computed here."""
    if "handle" in _CPU_REFS:
        _CPU_REFS["result"] = finish_phase(_CPU_REFS.pop("handle"))
    if "result" in _CPU_REFS and arch in _CPU_REFS["result"]:
        return _CPU_REFS["result"][arch]
    return _cpu_reference(arch)


def smoke_card_vs_cpu(dev, arch: str) -> tuple:
    """``arch``'s f32 smoke config trained LLM_CARD_CPU steps on the card
    from the initial weights of its CPU run (cpu_reference): ({"card",
    "cpu"}: losses and grad norms, {key: the largest difference}); fails
    past CARD_CPU_TOL."""
    init, cpu = cpu_reference(arch)
    rows, *_ = llm_run(dev, arch=arch, smoke=True, seq=128,
                       param_dtype="float32", K=_card_cpu_K(arch),
                       steps=LLM_CARD_CPU["steps"], device=dev,
                       init_fn=lambda seed: init)
    runs = {"card": {k: [r[k] for r in rows] for k in ("loss", "grad_norm")},
            "cpu": cpu}
    err = {}
    for k in ("loss", "grad_norm"):
        ok, err[k] = close_np(runs["card"][k], runs["cpu"][k], CARD_CPU_TOL)
        check(ok, f"{arch} smoke f32 {k}, card vs CPU: {runs}")
    return runs, err


def flop_fields(cfg, ms: float,
                batch_per_agent: int = LLM["batch_per_agent"]) -> dict:
    """One training step's FLOPs by ``utils.flops.train_flops`` on the
    run's own config (its cut depth) and shape (seq 4096, global batch
    2 agents x ``batch_per_agent`` sequences), and ``mfu``: the model
    FLOPs (6 N_active D) over the median step time and the card's dense
    bf16 peak."""
    from repro_torch.configs.base import InputShape
    from repro_torch.utils import flops as FL
    shape = InputShape("train_4k_cut", LLM["seq"],
                       LLM["agents"] * batch_per_agent, "train")
    f = FL.train_flops(cfg, shape)
    return {"model_flops_per_step": f["model_flops"],
            "exec_flops_per_step": f["exec_flops"],
            "mfu": f["model_flops"] / (ms / 1e3 * BF16_FLOPS_PER_S)}


def llm_vs_loss(dev, mode, T_, seq=LLM_VS_PLAIN["seq"],
                n_layers=LLM_VS_PLAIN["n_layers"], **kw) -> list:
    """The losses of a short run (LLM_VS_PLAIN) for the kernel vs plain
    checks."""
    rows, *_ = llm_run(dev, n_layers=n_layers, seq=seq, memory_mode=mode,
                       T=T_, steps=LLM_VS_PLAIN["steps"], **kw)
    return [r["loss"] for r in rows]


def llm_train_phase(dev) -> dict:
    """The LLM trainer on the card: h2o-danube-1.8b at full width with cut
    depth, FrODO exp-sum memory through the exp-sum kernel on bf16 leaves
    (12 steps, profiled); the exact-memory sub-run through the exact
    kernel; kernel vs plain path in both modes; card vs the card machine's
    CPU at the f32 smoke config; exp-sum with bf16 accumulators; and both
    kernels against their plain versions at the largest leaves.  Returns
    the launches of the trainer's paths and the kernels' numbers at the
    LLM leaves."""
    import numpy as np
    import torch
    from repro_torch.configs import registry as REG
    from repro_torch.core import memory as fmem
    from repro_torch.experiments import kernel_bench as KB
    from repro_torch.experiments.kernel_bench import BF16_DELTA_TOL
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ref
    from repro_torch.training import train_step as TS

    train = functools.partial(llm_run, dev)

    cfg = REG.get_config(LLM_ARCH).replace(n_layers=LLM["n_layers"])
    shapes = {k: tuple(t.shape) for k, t in meta_leaves(
        cfg, LLM["agents"]).items()}
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
    S, B = LLM["seq"], LLM["batch_per_agent"]
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
        **flop_fields(cfg, ms),
        "peak_memory_bytes": peak, "profile_steps": [p0, p1],
        "profile": prof_main,
        "expsum_bound_ms_per_step": bound(68 * n),
        "expsum_bound_ms_at_up": bound(68 * int(np.prod(shapes[
            "blocks/mlp/up/w"])))}
    emit("llm_train", **main)

    # ---------------------------------------------- exact memory (default)
    ex = LLM_EXACT
    cfg_x = cfg.replace(n_layers=ex["n_layers"])
    shapes_x = {k: tuple(t.shape) for k, t in meta_leaves(
        cfg_x, LLM["agents"]).items()}
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
    ms_x = statistics.median(step_ms[1:q0])
    exact = {
        "n_layers": ex["n_layers"], "T": ex["T"], "steps": ex["steps"],
        "n_total": n_x, "seconds": secs, "loss": loss_x,
        "launches": launches_x, **flop_fields(cfg_x, ms_x),
        "ms_per_step": ms_x,
        "ms_per_step_steps": [1, q0 - 1], "peak_memory_bytes": peak_x,
        "profile_steps": [q0, q1],
        "profile": window_profile(trace, q1 - q0 + 1, step_ms[q0:q1 + 1],
                                  "exact_update_kernel", emb, n_leaves),
        "exact_bound_ms_per_step": bound((ex["T"] + 3) * n_x * 2),
        "exact_bound_ms_at_embed": bound((ex["T"] + 3) * n_emb * 2)}

    # ------------------------------------- kernel vs plain, both memory modes
    vs_loss = functools.partial(llm_vs_loss, dev)

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
    card_cpu, cc = smoke_card_vs_cpu(dev, LLM_ARCH)

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
    ms_b = statistics.median(step_ms[1:b0])
    bf16acc = {
        "steps": bf["steps"], "loss": loss_b, "launches": launches_b,
        "seconds": secs, "peak_memory_bytes": peak_b,
        **flop_fields(cfg.replace(n_layers=bf["n_layers"]), ms_b),
        "ms_per_step": ms_b,
        "ms_per_step_steps": [1, b0 - 1],
        "profile_steps": [b0, b1],
        "profile": window_profile(trace, b1 - b0 + 1, step_ms[b0:b1 + 1],
                                  "expsum_update_kernel", up, n_leaves),
        "expsum_bound_ms_per_step": bound(36 * n),
        "expsum_bound_ms_at_up": bound(36 * int(np.prod(shapes[
            "blocks/mlp/up/w"])))}
    emit("llm_train.sub_runs",
         mfu={"exact": exact["mfu"], "expsum_bf16_acc": bf16acc["mfu"]},
         exact=exact, kernel_vs_plain=vs,
         kernel_vs_plain_tol=LLM_LOSS_TOL, card_vs_cpu_max_abs_err=cc,
         card_vs_cpu_tol=CARD_CPU_TOL, card_vs_cpu=card_cpu,
         card_vs_cpu_steps=LLM_CARD_CPU["steps"], expsum_bf16_acc=bf16acc)

    # ------------------------- both kernels at the largest leaves, > 2^31
    gen = torch.Generator(device=dev).manual_seed(7)

    def planted(faults: dict, d_ref) -> dict:
        """Each planted fault's delta on a slab against the plain delta
        ``d_ref`` of the same slab: each must fail BF16_DELTA_TOL."""
        out = {}
        for name, d in faults.items():
            r = KB.delta_diff(d, d_ref, BF16_DELTA_TOL)
            check(not r["passes"], f"planted fault {name} passes the bf16 "
                  f"delta check: {r}")
            out[name] = {k: r[k] for k in ("max_abs_err", "elements_past_tol",
                                           "share_differing")}
        return out

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
    d_err = KB.delta_diff(d_k, d_p, BF16_DELTA_TOL)
    check(d_err["passes"], f"exp-sum delta at blocks/mlp/up/w: {d_err}")
    check(KB.bit_equal(a_k, a_p), "exp-sum new accumulators at "
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
                  "truncation": KB.truncated(ref.frodo_expsum_update_ref(
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
    d_err = KB.delta_diff(d_k, d_p, BF16_DELTA_TOL)
    check(d_err["passes"], f"exact delta at embed/table: {d_err}")
    check(KB.bit_equal(h_k, h_p), "exact pushed history at embed/table not "
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
                  "truncation": KB.truncated(ref.frodo_update_ref(
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
         mfu=main["mfu"], mfu_of="the llm_train run these leaves belong to",
         expsum_bf16g_f32acc_at_mlp_up=es_big, exact_bf16_at_embed=ex_big,
         tol={"delta": BF16_DELTA_TOL, "new_acc": "bit-equal",
              "pushed_history": "bit-equal"},
         note="kernel vs plain version on one full leaf each, past 2^31 "
              "elements of state; planted faults in the plain version on a "
              "slab of the same inputs, each failing the delta check; ms by "
              "CUDA events around one wrapper "
              "call; the library call is torch.addmv (exact; no one "
              "PyTorch call does the exp-sum update)")
    return {"main": {k: main[k] for k in ("ms_per_step", "peak_memory_bytes",
                                          "mfu")},
            "launches": {"llm_train": launches,
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


def llm_train_mamba2(dev) -> dict:
    """The llm_train phase's mamba2-780m sub-run: full width, the train_4k
    shape, exp-sum through the kernel on bf16 and f32 leaves, a falling
    finite loss; kernel vs plain path; card vs the card machine's CPU at
    the f32 smoke config.  Returns its launches."""
    import numpy as np
    import torch
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.models import transformer as TM
    from repro_torch.training import train_step as TS

    train = functools.partial(llm_run, dev)
    tokens = LLM["agents"] * LLM["batch_per_agent"] * LLM["seq"]
    # ------------------------- mamba2-780m: f32 and bf16 leaves in one tree
    mb = LLM_MAMBA2
    smoke_m = REG.get_smoke_config(MAMBA2_ARCH)
    leaf_dtypes = [t.dtype for t in TR.leaves(TM.init_params(
        torch.Generator(), smoke_m))]
    n_leaves_m = len(leaf_dtypes)
    check(set(leaf_dtypes) == {torch.bfloat16, torch.float32},
          f"mamba2 leaf dtypes {leaf_dtypes}")
    rows, launches_m, secs, peak_m, _ = train(
        arch=MAMBA2_ARCH, n_layers=mb["n_layers"], memory_mode="expsum",
        T=LLM["T"], steps=mb["steps"])
    check(launches_m == {"frodo_exact_update": 0,
                         "frodo_expsum_update": n_leaves_m * mb["steps"]},
          f"exp-sum launches on the mamba2 path: {launches_m}")
    loss_m = [r["loss"] for r in rows]
    gnorm_m = [r["grad_norm"] for r in rows]
    check(bool(np.isfinite(loss_m).all() and np.isfinite(gnorm_m).all()),
          f"mamba2 loss or grad norm not finite: {loss_m} {gnorm_m}")
    check(loss_m[-1] < loss_m[0], f"mamba2 loss did not fall: {loss_m}")
    check(peak_m < 80e9, f"mamba2 peak device memory {peak_m}")
    step_ms = [r["step_time_ms"] for r in rows]
    cfg_m = REG.get_config(MAMBA2_ARCH).replace(n_layers=mb["n_layers"])
    kern = llm_vs_loss(dev, "expsum", LLM["T"], arch=MAMBA2_ARCH, use_kernel=True)
    plain = llm_vs_loss(dev, "expsum", LLM["T"], arch=MAMBA2_ARCH, use_kernel=False)
    ok, err = close_np(kern, plain, LLM_LOSS_TOL)
    check(ok, f"mamba2 exp-sum: kernel vs plain loss {kern} {plain}")
    vs_m = {"loss_kernel": kern, "loss_plain": plain, "max_abs_err": err}
    card_cpu_m, cc_m = smoke_card_vs_cpu(dev, MAMBA2_ARCH)
    emit("llm_train.mamba2", arch=MAMBA2_ARCH, width={
        "d_model": cfg_m.d_model, "d_inner": cfg_m.ssm.expand
        * cfg_m.d_model, "ssm_heads": cfg_m.ssm.expand * cfg_m.d_model
        // cfg_m.ssm.head_dim, "head_dim": cfg_m.ssm.head_dim,
        "d_state": cfg_m.ssm.d_state, "chunk": cfg_m.ssm.chunk,
        "vocab": cfg_m.vocab, "param_dtype": cfg_m.param_dtype},
        n_layers=cfg_m.n_layers, reduced=LLM_MAMBA2_REDUCED,
        agents=LLM["agents"], seq=LLM["seq"],
        batch_per_agent=LLM["batch_per_agent"], memory_mode="expsum",
        K=TS.TrainConfig().K, T=LLM["T"], acc_dtype="float32",
        leaves=n_leaves_m, leaf_dtypes=sorted({str(d) for d in leaf_dtypes}),
        steps=mb["steps"], seconds=secs, loss=loss_m, grad_norm=gnorm_m,
        launches=launches_m, ms_per_step=statistics.median(step_ms[1:]),
        ms_per_step_steps=[1, mb["steps"] - 1],
        **flop_fields(cfg_m, statistics.median(step_ms[1:])),
        tokens_per_s=tokens / (statistics.median(step_ms[1:]) / 1e3),
        peak_memory_bytes=peak_m, kernel_vs_plain=vs_m,
        kernel_vs_plain_tol=LLM_LOSS_TOL, card_vs_cpu_max_abs_err=cc_m,
        card_vs_cpu_tol=CARD_CPU_TOL, card_vs_cpu=card_cpu_m)

    return launches_m


# ------------------------------------------ the MoE family and MLA attention
#: the llm_train sub-runs of qwen3-moe-30b-a3b (MoE) and minicpm3-4b (MLA):
#: full width, the train_4k shape, 2 agents x 2 sequences, FrODO exp-sum
#: K = 8 through the exp-sum kernel.  ms/step is the median of the steps
#: between the first and the profile window (the step after a window also
#: times the trace's export).
MOE_ARCH, MLA_ARCH = "qwen3-moe-30b-a3b", "minicpm3-4b"
LLM_NEW = {
    MOE_ARCH: dict(path="llm_train_qwen3_moe", n_layers=1, steps=10,
                   profile=(6, 7),
                   acc_dtype="bfloat16", big_leaf="blocks/moe/experts/gate",
                   reduced={
                       "n_layers": "48 -> 1: one MoE block (623 M parameters "
                                   "an agent) beside the 622 M of embedding "
                                   "and head; two agents' exp-sum state of "
                                   "more does not fit one card",
                       "global_batch": "256 -> 4 (2 agents x 2 sequences of "
                                       "train_4k's 4096)",
                       "acc_dtype": "float32 -> bfloat16: 8 f32 "
                                    "accumulators of 2 x 1.25 B parameters "
                                    "are 80 GB"}),
    MLA_ARCH: dict(path="llm_train_minicpm3", n_layers=6, steps=10,
                   profile=(6, 7),
                   acc_dtype="float32", big_leaf="blocks/mlp/up/w",
                   reduced={
                       "n_layers": "62 -> 6: two agents' exp-sum state (8 "
                                   "f32 accumulators of 2 x 752 M "
                                   "parameters, 48 GB) fits one card",
                       "global_batch": "256 -> 4 (2 agents x 2 sequences of "
                                       "train_4k's 4096)"}),
}
#: minicpm3's exact-memory sub-run through the exact kernel (seq 4096)
LLM_MLA_EXACT = dict(n_layers=1, T=32, steps=5, reduced={
    "n_layers": "62 -> 1",
    "T": "40 -> 32: two agents' bf16 history of 878 M parameters is 70 GB "
         "at T = 40, 56 GB at T = 32"})
#: the peak device memory each trainer run must stay under (of 80 GB)
LLM_PEAK_LIMIT = 72e9
# Per-step loss, kernel path vs plain path at 1 layer, seq 512, 3 steps,
# with the accumulators of the main run, one agent: the plain path's
# out-of-place accumulator update holds a second copy of the whole state
# (2 x 20 GB for qwen3-moe's one agent) and OOMs with two.  The limit is
# LLM_LOSS_TOL.  On an H100 qwen3-moe's losses (bf16 accumulators: the
# plain path rounds a g, b M, their sum and each new accumulator to bf16,
# the kernel once from f32) read 7.3e-5 apart on a loss of 12.2, a third
# of the limit's 1.2e-3; alpha 10% high in the plain path, 3.3e-2.
LLM_NEW_VS_PLAIN_AGENTS = 1


def llm_train_archs(dev, runs: dict) -> tuple:
    """The llm_train sub-runs of ``runs`` (arch -> settings, as in
    LLM_NEW): full width with cut depth, the train_4k shape, exp-sum
    through the kernel (profiled: the kernel's device time at the largest
    leaf, the busy share); a falling finite loss, one launch per leaf a
    step, peak memory under LLM_PEAK_LIMIT; kernel vs plain path at 1
    layer, seq 512 (a planted alpha 10% high must fail it); card vs the
    card machine's CPU at the f32 smoke config.  Returns (the launches of
    each path, the kernel's device times at the largest leaves)."""
    import numpy as np
    from repro_torch.configs import registry as REG
    from repro_torch.training import train_step as TS

    train = functools.partial(llm_run, dev)
    out, launches, kern = {}, {}, {}
    for arch, run in runs.items():
        K_ = run.get("K", TS.TrainConfig().K)
        B = run.get("batch_per_agent", LLM["batch_per_agent"])
        tokens = LLM["agents"] * B * LLM["seq"]
        cfg = REG.get_config(arch).replace(n_layers=run["n_layers"])
        sizes = {n: (tuple(t.shape), t.element_size(), t.dtype)
                 for n, t in meta_leaves(cfg, LLM["agents"]).items()}
        names = list(sizes)
        n_leaves = len(names)
        big = names.index(run["big_leaf"])
        n = sum(int(np.prod(s)) for s, _, _ in sizes.values())
        acc_b = 2 if run["acc_dtype"] == "bfloat16" else 4
        state_bytes = sum(2 * int(np.prod(s)) * (e + K_ * acc_b)
                          for s, e, _ in sizes.values())
        big_shape, big_e, _ = sizes[run["big_leaf"]]
        big_bytes = 2 * int(np.prod(big_shape)) * (big_e + K_ * acc_b)

        steps = run["steps"]
        rows, ln, secs, peak, trace = train(
            arch=arch, n_layers=run["n_layers"], memory_mode="expsum",
            T=LLM["T"], K=K_, acc_dtype=run["acc_dtype"], steps=steps,
            batch_per_agent=B, profile=run["profile"])
        check(ln == {"frodo_exact_update": 0,
                     "frodo_expsum_update": n_leaves * steps},
              f"{arch}: exp-sum launches {ln}, want {n_leaves} a step")
        loss = [r["loss"] for r in rows]
        gnorm = [r["grad_norm"] for r in rows]
        check(bool(np.isfinite(loss).all() and np.isfinite(gnorm).all()),
              f"{arch}: loss or grad norm not finite: {loss} {gnorm}")
        check(loss[-1] < loss[0], f"{arch}: loss did not fall: {loss}")
        check(peak < LLM_PEAK_LIMIT, f"{arch}: peak device memory {peak}")
        step_ms = [r["step_time_ms"] for r in rows]
        p0, p1 = run["profile"]
        ms = statistics.median(step_ms[1:p0])
        prof = window_profile(trace, p1 - p0 + 1, step_ms[p0:p1 + 1],
                              "expsum_update_kernel", big, n_leaves)

        # kernel vs plain path: 1 layer, seq 512 (or the run's
        # vs_plain_layers, vs_plain_seq)
        tol = LLM_LOSS_TOL
        vs_kw = dict(arch=arch, acc_dtype=run["acc_dtype"], K=K_,
                     agents=LLM_NEW_VS_PLAIN_AGENTS,
                     seq=run.get("vs_plain_seq", LLM_VS_PLAIN["seq"]),
                     n_layers=run.get("vs_plain_layers",
                                      LLM_VS_PLAIN["n_layers"]))
        vs = {uk: llm_vs_loss(dev, "expsum", LLM["T"], use_kernel=uk,
                              **vs_kw) for uk in (True, False)}
        ok, err = close_np(vs[True], vs[False], tol)
        check(ok, f"{arch}: kernel vs plain loss {vs}")
        planted = llm_vs_loss(dev, "expsum", LLM["T"], use_kernel=False,
                              **vs_kw, **LLM_PLANTED["alpha_x1.1"])
        passes, e_pl = close_np(vs[True], planted, tol)
        check(not passes, f"{arch}: planted alpha_x1.1 passes the kernel vs "
              f"plain check ({e_pl})")

        # card vs CPU, the f32 smoke config
        cc_rows, cc = smoke_card_vs_cpu(dev, arch)

        launches[run["path"]] = ln
        out[arch] = {
            "arch": arch, "width": {
                "family": cfg.family, "d_model": cfg.d_model,
                "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                "head_dim": cfg.hd(), "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                "moe": cfg.moe and cfg.moe.__dict__,
                "mla": cfg.mla and cfg.mla.__dict__,
                "n_enc_layers": cfg.n_enc_layers,
                "n_frames": cfg.n_frames if cfg.family == "audio" else 0,
                "n_img_tokens": cfg.n_img_tokens,
                "hybrid": cfg.hybrid and cfg.hybrid.__dict__,
                "logit_softcap": cfg.logit_softcap,
                "param_dtype": cfg.param_dtype},
            "n_layers": cfg.n_layers, "reduced": run["reduced"],
            "agents": LLM["agents"], "seq": LLM["seq"],
            "batch_per_agent": B,
            "tokens_per_step": tokens, "params_per_agent": n // LLM["agents"],
            "leaves": n_leaves, "memory_mode": "expsum", "K": K_,
            "T": LLM["T"], "acc_dtype": run["acc_dtype"], "steps": steps,
            "seconds": secs, "loss": loss, "grad_norm": gnorm,
            "launches": ln, "launches_per_step": n_leaves,
            "ms_per_step": ms, "ms_per_step_steps": [1, p0 - 1],
            **flop_fields(cfg, ms, B),
            "tokens_per_s": tokens / (ms / 1e3), "peak_memory_bytes": peak,
            "profile_steps": [p0, p1], "profile": prof,
            "expsum_bound_ms_per_step": state_bytes / HBM_BYTES_PER_S * 1e3,
            "big_leaf": run["big_leaf"], "big_leaf_shape": list(big_shape),
            "expsum_bound_ms_at_big_leaf": big_bytes / HBM_BYTES_PER_S * 1e3,
            "kernel_vs_plain": {"agents": LLM_NEW_VS_PLAIN_AGENTS,
                                "seq": vs_kw["seq"],
                                "n_layers": vs_kw["n_layers"],
                                "loss_kernel": vs[True],
                                "loss_plain": vs[False], "max_abs_err": err,
                                "planted_alpha_x1.1_max_abs_err": e_pl},
            "kernel_vs_plain_tol": tol, "card_vs_cpu_max_abs_err": cc,
            "card_vs_cpu_tol": CARD_CPU_TOL}
        kern[arch] = {"leaf": run["big_leaf"], "shape": list(big_shape),
                      "mfu": out[arch]["mfu"],
                      "acc_dtype": run["acc_dtype"],
                      "device_ms_at_leaf": prof["kernel_ms_at_leaf"],
                      "bound_ms_at_leaf": out[arch][
                          "expsum_bound_ms_at_big_leaf"],
                      "device_ms_per_step": prof["kernel_ms_per_step"],
                      "bound_ms_per_step": out[arch][
                          "expsum_bound_ms_per_step"]}
        emit("llm_train." + arch, nvidia_smi=nvidia_smi(), **out[arch])

    return launches, kern


def llm_train_moe_mla(dev) -> dict:
    """The llm_train phase's sub-runs of the MoE family (qwen3-moe-30b-a3b)
    and MLA attention (minicpm3-4b), as ``llm_train_archs`` runs them, and
    minicpm3's exact-memory sub-run through the exact kernel.  Returns the
    launches of each path and the kernels' device times at the largest
    leaves."""
    import numpy as np
    from repro_torch.configs import registry as REG

    train = functools.partial(llm_run, dev)
    launches, kern = llm_train_archs(dev, LLM_NEW)

    # ----------------------- minicpm3: exact memory through the exact kernel
    ex = LLM_MLA_EXACT
    n_leaves = len(meta_leaves(REG.get_config(MLA_ARCH).replace(
        n_layers=ex["n_layers"]), LLM["agents"]))
    rows, ln, secs, peak, _ = train(
        arch=MLA_ARCH, n_layers=ex["n_layers"], memory_mode="exact",
        T=ex["T"], steps=ex["steps"])
    check(ln == {"frodo_exact_update": n_leaves * ex["steps"],
                 "frodo_expsum_update": 0},
          f"{MLA_ARCH}: exact launches {ln}")
    loss = [r["loss"] for r in rows]
    check(bool(np.isfinite(loss).all()), f"{MLA_ARCH} exact loss: {loss}")
    check(peak < LLM_PEAK_LIMIT, f"{MLA_ARCH} exact: peak {peak}")
    launches["llm_train_minicpm3_exact"] = ln
    ms = statistics.median([r["step_time_ms"] for r in rows][1:])
    emit("llm_train." + MLA_ARCH + ".exact", nvidia_smi=nvidia_smi(),
         n_layers=ex["n_layers"], T=ex["T"], reduced=ex["reduced"],
         steps=ex["steps"], loss=loss, launches=ln,
         launches_per_step=n_leaves, seconds=secs, ms_per_step=ms,
         **flop_fields(REG.get_config(MLA_ARCH).replace(
             n_layers=ex["n_layers"]), ms),
         peak_memory_bytes=peak)
    return {"launches": launches, "kernels": kern}


# ------------------------------- the vision and encoder-decoder audio families
#: the llm_train sub-runs of phi-3-vision-4.2b (vision: 576 patch embeddings
#: scattered at the first positions of every sequence) and whisper-tiny
#: (audio: a 4-layer encoder over 1,500 frame embeddings, a 4-layer decoder
#: with cross attention), as llm_train_archs runs them: full width, the
#: train_4k shape, 2 agents x 2 sequences, exp-sum K = 8 with f32
#: accumulators through the exp-sum kernel.  whisper-tiny runs at full
#: depth, 20 steps, its profile window late so that ms/step is the median
#: of steps 1-15.  phi-3-vision peaked at 60.3 GB with 5 layers on an H100
#: (700 W); a layer adds 8.15 GB of parameters, gradients and accumulators
#: for two agents, so 6 layers stay under LLM_PEAK_LIMIT.  phi-3-vision's
#: kernel vs plain path runs at seq 1024
#: (576 patch and 448 token positions): at seq 512 every position is a
#: patch embedding, and on an H100 (700 W) the plain path with alpha 10%
#: high moved the loss by 4.1e-4 there, inside the limit of 1.1e-3.
VLM_ARCH, AUDIO_ARCH = "phi-3-vision-4.2b", "whisper-tiny"
LLM_VLM_AUDIO = {
    VLM_ARCH: dict(path="llm_train_phi3_vision", n_layers=6, steps=10,
                   profile=(6, 7), acc_dtype="float32", vs_plain_seq=1024,
                   big_leaf="blocks/mlp/up/w", reduced={
                       "n_layers": "32 -> 6: two agents' exp-sum state (8 "
                                   "f32 accumulators of 2 x 876 M "
                                   "parameters, 56 GB) fits one card",
                       "global_batch": "256 -> 4 (2 agents x 2 sequences of "
                                       "train_4k's 4096)"}),
    AUDIO_ARCH: dict(path="llm_train_whisper", n_layers=4, steps=20,
                     profile=(16, 17), acc_dtype="float32",
                     big_leaf="embed/table", reduced={
                         "global_batch": "256 -> 4 (2 agents x 2 sequences "
                                         "of train_4k's 4096)"}),
}


def llm_train_vlm_audio(dev) -> dict:
    """The llm_train phase's sub-runs of the vision (phi-3-vision-4.2b) and
    audio (whisper-tiny) families, as ``llm_train_archs`` runs them.
    Returns the launches of each path and the kernel's device times at
    the largest leaves."""
    launches, kern = llm_train_archs(dev, LLM_VLM_AUDIO)
    return {"launches": launches, "kernels": kern}


# ---------------------------------------------------------- the hybrid family
#: the llm_train sub-run of recurrentgemma-9b (groups of two RG-LRU
#: sub-layers and one local-attention sub-layer over a 2,048 window, each
#: with a gated MLP; a 256,000-token tied embedding), as llm_train_archs
#: runs it: full width, the train_4k shape, 2 agents x 2 sequences, exp-sum
#: K = 4 with bf16 accumulators through the exp-sum kernel, 10 steps.  Its
#: kernel vs plain path runs at 3 layers: one layer is divmod(1, 3) = no
#: group (a zero-length stack, no attention, leaves that launch nothing).
HYBRID_ARCH = "recurrentgemma-9b"
LLM_HYBRID = {
    HYBRID_ARCH: dict(
        path="llm_train_recurrentgemma", n_layers=3, steps=10,
        profile=(6, 7), acc_dtype="bfloat16", K=4, vs_plain_layers=3,
        big_leaf="embed/table", reduced={
            "n_layers": "38 -> 3: one group (rec, rec, local attention), "
                        "656 M parameters an agent beside the 1,049 M of "
                        "the tied embedding: 1.705 B an agent, 3.41 B for "
                        "the two",
            "global_batch": "256 -> 4 (2 agents x 2 sequences of "
                            "train_4k's 4096)",
            "acc_dtype": "float32 -> bfloat16",
            "K": "8 -> 4: two agents' state at K = 8 is 3.41 B x (2 + 2 + "
                 "8 x 2) B = 68 GB with bf16 accumulators (109 GB with "
                 "f32) before activations; at K = 4 it is 41 GB"}),
}


def expsum_at_largest_leaf(dev, shape: tuple, K_: int) -> dict:
    """The exp-sum kernel against its plain version on one leaf of
    ``shape`` (bf16 gradient, ``K_`` bf16 accumulators, past 2^31 elements
    of state), by ``kernel_bench.vs_plain``: delta within BF16_DELTA_TOL,
    the new accumulators bit-equal, planted faults in the plain version on
    a slab failing the same check.  The plain version runs in slices of
    CHECK_CHUNK elements (it is elementwise, so each slice's bits are the
    whole call's): its f32 temporaries of a whole 2.1-3.1 B-element leaf
    would not fit beside the state.  Timed by CUDA events."""
    import torch
    from repro_torch.core import memory as fmem
    from repro_torch.experiments import kernel_bench as KB
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(11)
    g = KB._randn(shape, torch.bfloat16, dev, gen)
    acc = KB._randn((K_,) + shape, torch.bfloat16, dev, gen)
    rates_np, coeffs_np = fmem.fit_expsum(LLM["T"], 0.15, K_)
    rates = torch.tensor(rates_np, dtype=torch.float32)
    coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
    n = g.numel()

    def plain(st):
        g_f, a_f = g.view(-1), st.view(K_, -1)
        d = torch.empty_like(g_f)
        for i in range(0, n, KB.CHECK_CHUNK):
            j = min(n, i + KB.CHECK_CHUNK)
            d[i:j], _ = ref.frodo_expsum_update_ref(
                g_f[i:j], a_f[:, i:j], rates, coeffs, KB.ALPHA, KB.BETA)
        return d.view(shape), st

    def kern():
        return KU.expsum_update(g, acc, rates, coeffs, KB.ALPHA, KB.BETA)

    out = {"shape": [K_] + list(shape), "elements": acc.numel(),
           "g_dtype": "bfloat16", "acc_dtype": "bfloat16", "K": K_,
           **KB.vs_plain("expsum", g, acc, (rates, coeffs), plain, kern),
           "ms": cuda_ms(kern, reps=10),
           "plain_ms": cuda_ms(lambda: plain(acc), reps=2, warmup=1),
           # g read, delta written; the accumulators read and written
           "bound_ms": (2 * n * 2 + 2 * K_ * n * 2) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None}
    del g, acc
    torch.cuda.empty_cache()
    out["copy_ceiling_ms"] = KB.copy_ceiling_us(
        2 * n * 2 + 2 * K_ * n * 2, dev, 10) / 1e3
    torch.cuda.empty_cache()
    return out


def llm_train_at_leaf(dev, runs: dict, phase: str) -> dict:
    """The llm_train phase's sub-run of the one model of ``runs`` (as in
    LLM_HYBRID), as ``llm_train_archs`` runs it, then the exp-sum kernel
    against its plain version at the run's K on its largest leaf, the
    embedding of both agents (recurrentgemma-9b's tied 2 x 256,000 x
    4,096, 8.4 B elements of state at K = 4; nemotron-4-15b's 2 x 256,000
    x 6,144, 3.1 B elements an accumulator), emitted as ``phase``.
    Returns the launches of its path and the kernel's numbers."""
    from repro_torch.configs import registry as REG

    (arch, run), = runs.items()
    launches, kern = llm_train_archs(dev, runs)
    shape = tuple(meta_leaves(REG.get_config(arch).replace(
        n_layers=run["n_layers"]), LLM["agents"])[run["big_leaf"]].shape)
    big = expsum_at_largest_leaf(dev, shape, run["K"])
    emit(phase, nvidia_smi=nvidia_smi(), mfu=kern[arch]["mfu"],
         mfu_of="the llm_train run this leaf belongs to",
         leaf=arch + "/" + run["big_leaf"],
         device_ms_in_the_run=kern[arch]["device_ms_at_leaf"], **big,
         note="kernel vs plain version on the whole leaf; planted faults "
              "in the plain version on a slab of the same inputs; ms by "
              "CUDA events around one call (the plain version in slices); "
              "device_ms_in_the_run from the run's profile window")
    return {"launches": launches, "kernels": kern, "expsum_at_leaf": big}


# -------------------------------------------------- nemotron-4-15b's trainer
#: the llm_train sub-run of nemotron-4-15b (GQA with kv 8 and RoPE on the
#: first half of each head, a squared-ReLU MLP without a gate, an untied
#: 256,000 x 6,144 unembedding), as llm_train_archs runs it: full width,
#: the train_4k sequence of 4,096, 2 agents x 1 sequence, exp-sum through
#: the exp-sum kernel with bf16 accumulators, 10 steps.  Its largest
#: leaves, the embedding and the head, are 2 x 1.573 B elements each.
NEMOTRON_ARCH = "nemotron-4-15b"
LLM_NEMOTRON = {
    NEMOTRON_ARCH: dict(
        path="llm_train_nemotron", n_layers=1, steps=10, profile=(6, 7),
        acc_dtype="bfloat16", K=1, batch_per_agent=1,
        big_leaf="embed/table", reduced={
            "n_layers": "32 -> 1: 390 M parameters an agent beside the "
                        "3,146 M of embedding and head: 3.536 B an agent, "
                        "7.07 B for the two",
            "global_batch": "256 -> 2 (2 agents x 1 sequence of "
                            "train_4k's 4096): cut before K, and the "
                            "sequence keeps its length",
            "acc_dtype": "float32 -> bfloat16",
            "K": "8 -> 1: a step holds the parameters, the gradients, one "
                 "more parameter-sized tree (the clipped gradients, the "
                 "delta, or the updated or mixed parameters beside the "
                 "last) and K bf16 accumulators: 7.07 B x (2 + 2 + 2 + "
                 "2 K) B = 70.7 GB at K = 2 before activations, past the "
                 "68 GB aimed at under the 72 GB limit; 56.6 GB at K = 1 "
                 "(on an H100, 700 W, K = 2 peaked at 77.9 GB in 3 steps, "
                 "K = 1 at 63.5 GB)"}),
}


# ---------------------------------------------------------------- serving
#: the serve phase drives repro_torch.launch.serve (the scheduler) and the
#: decode path on every family the port serves
SERVE_ARCHS = ("h2o-danube-1.8b", "mamba2-780m", "qwen3-moe-30b-a3b",
               "minicpm3-4b", "phi-3-vision-4.2b", "whisper-tiny",
               "recurrentgemma-9b", "nemotron-4-15b", "kimi-k2-1t-a32b")
#: launch/serve's default trace (card against CPU, smoke configs in f32)
SERVE_SMOKE = dict(n_requests=8, rate=0.7, prompt_len_range=(4, 12),
                   new_tokens_range=(3, 8), max_slots=4, prefill_chunk=8,
                   token_budget=32, max_len=64, seed=0)
#: traffic at full width and full depth, and how many of its first
#: requests run alone, each in a fresh scheduler, and must give the packed
#: run's tokens bit for bit.  The MoE and MLA models serve a shorter trace
#: (their decode steps launch 3-4 times the kernels), and so does
#: phi-3-vision, whose decode is the dense branch that h2o-danube drives
#: at full depth; each whisper-tiny request carries its own frames
SERVE_FULL = dict(n_requests=16, rate=0.7, prompt_len_range=(16, 128),
                  new_tokens_range=(16, 64), max_slots=8, prefill_chunk=32,
                  token_budget=128, max_len=256, seed=0)
SERVE_SHORT = dict(SERVE_FULL, n_requests=8, prompt_len_range=(16, 48),
                   new_tokens_range=(16, 32))
SERVE_TRAFFIC = {"h2o-danube-1.8b": (SERVE_FULL, 4),
                 "mamba2-780m": (SERVE_FULL, 4),
                 "qwen3-moe-30b-a3b": (SERVE_SHORT, 2),
                 "minicpm3-4b": (SERVE_SHORT, 2),
                 "phi-3-vision-4.2b": (SERVE_SHORT, 2),
                 "whisper-tiny": (SERVE_FULL, 4),
                 "recurrentgemma-9b": (SERVE_SHORT, 2),
                 "nemotron-4-15b": (SERVE_SHORT, 2),
                 "kimi-k2-1t-a32b": (SERVE_SHORT, 2)}
#: the traffic runs served at a cut depth (the first layers of the loaded
#: model's stack; its decode-vs-forward runs stay at full depth), so that
#: the script stays within its limit of 1,200 s with a 10% margin on the
#: slowest host seen.  Before recurrentgemma-9b was served, the whole
#: script took 1,178.5 s on that host and 989.9 s on a faster one, and
#: recurrentgemma-9b's trainer and serve sub-runs take 95 s more on an
#: H100 (700 W).  The models are cut in this order until the projection
#: at the slowest host's pace is at most 1,080 s.  Each saving is the
#: model's full-depth traffic time (from its launcher's time, on the
#: 989.9 s host) less its cut run: qwen3-moe ~73 s, minicpm3 ~64 s,
#: mamba2 ~56 s.  With those three the whole script took 857.8 s on a
#: host 1.12-1.53 times faster than the slowest in the phases that did
#: not change: 1,104 s at its pace.  h2o-danube's cut saves ~35 s more
#: (~45 s at that pace); with it the script took 850.7 s, ~1,007 s at
#: that pace.  The distributed phase added 40 s, and the whole script took
#: 992.3 s with Exp 3 at 204 s; the slowest host seen ran Exp 3 in 224 s
#: and the rest ~1.2 times slower alike, so ~1,090 s at its pace.
#: recurrentgemma-9b's traffic and then phi-3-vision's are cut: their
#: serving took 23 s and 47 s in place of 48 s and 61 s, and the script
#: 999.1 s on a host that ran Exp 3 in 211.5 s, ~1,058 s at that pace.
#: The tensor_parallel phase adds ~45-55 s and the distributed phase's
#: cut from 6 to 4 steps saves ~8: qwen3-moe's, minicpm3's and mamba2's
#: traffic are halved again (each ~11-14 s of its time at the earlier
#: depth, from the savings above); with them the script took 939.6 s on
#: a host that ran Exp 3 in 175.8 s (before it: 937.5 s on one at 180 s), so
#: h2o-danube's and phi-3-vision's traffic are halved as well; then 945.9
#: s on a host at 195.2 s, ~1,085 s at the slowest host's pace, so
#: mamba2's, phi-3-vision's and recurrentgemma-9b's were halved again:
#: 955.3 s on a host at 217.4 s, ~984 s at that pace, ~100 s more than
#: the 5 s needed.  That last halving is undone (it saved ~15-20 s), and
#: the tensor_parallel phase's exact-memory steps take ~10 s of the room.
#: The fsdp phase (132-164 s) took the script to 911-946 s: mamba2's
#: traffic is halved again, and whisper-tiny moves to the third group
#: (the second, h2o-danube, mamba2 and whisper, ended 74 s after it).
SERVE_TRAFFIC_CUT = ("traffic only, decode vs forward at full depth: "
                     "the script's 1,200 s limit")
SERVE_TRAFFIC_LAYERS = {
    "qwen3-moe-30b-a3b": (6, "48 -> 6 (12 until the tensor_parallel "
                             "phase), " + SERVE_TRAFFIC_CUT),
    "minicpm3-4b": (8, "62 -> 8 (16 until the tensor_parallel phase), "
                       + SERVE_TRAFFIC_CUT),
    "mamba2-780m": (4, "48 -> 4 (8 until the fsdp phase, 16 until the "
                       "tensor_parallel phase), " + SERVE_TRAFFIC_CUT),
    "h2o-danube-1.8b": (4, "24 -> 4 (8 until the tensor_parallel "
                           "phase), " + SERVE_TRAFFIC_CUT),
    "recurrentgemma-9b": (6, "38 -> 6 (two rec, rec, local-attention "
                             "groups, no tail), " + SERVE_TRAFFIC_CUT),
    "phi-3-vision-4.2b": (8, "32 -> 8 (16 until the tensor_parallel "
                             "phase), " + SERVE_TRAFFIC_CUT),
    # its decode-vs-forward runs at full depth in bf16 (31.3 GB of
    # weights); a traffic step at 32 layers reads them all
    "nemotron-4-15b": (4, "32 -> 4, " + SERVE_TRAFFIC_CUT)}
#: models served at a cut depth throughout (decode against forward, the
#: MoE block and traffic alike; loaded at that depth by launch/serve's
#: ``n_layers``), because the whole model does not fit the card:
#: (layers, the model's ``reduced`` record).  kimi-k2-1t-a32b at 2 layers
#: (one dense, one MoE) holds 19,615,353,856 parameters, 39.23 GB in bf16;
#: each of its expert leaves (blocks/moe/experts/{gate,up,down}, 1 x 384 x
#: 7168 x 2048) holds 5,637,144,576 elements, 2.6 times 2^31 - 1, and
#: embed/table and the untied lm_head/w 1,174,405,120 each
SERVE_LAYERS = {"kimi-k2-1t-a32b": (2, {
    "n_layers": "61 -> 2 (one dense, one MoE layer: 39.23 GB in bf16; 3 "
                "layers hold 73.4 GB)",
    "float32": "no decode-vs-forward run in f32: the 2 layers' 19.62 B "
               "parameters hold 78.5 GB in f32; its planted faults run in "
               "bf16"})}
#: served in this process after the tensor_parallel phase, before fsdp
#: (serve_late_phase), beside no other phase: kimi-k2 at 2 layers holds
#: 50.2 GB of the card at its peak (nvidia-smi's memory.used, NVIDIA H100
#: 80GB HBM3, 700.00 W), and the phases after serving, meant to have it
#: beside them, reach 54.6 GB (distributed) and 77.1 GB (tensor_parallel)
#: the same way; beside them it ran out of memory.  The trainers allocate
#: 57-68 GB, serving's first group 61 GB, the fsdp ranks up to 72 GB
SERVE_LATE = ("kimi-k2-1t-a32b",)
#: scheduler steps under the profiler (busy share)
SERVE_PROFILE = (12, 15)
#: serve.step columns that do not read a clock
SERVE_STEP_KEYS = ("step", "queue_depth", "occupancy", "free_slots",
                   "n_prefill", "n_decode", "prefill_tokens",
                   "decode_tokens", "admitted", "completed")
#: decode (prefill_cache, every position's logits) against the
#: full-sequence forward: 2 sequences of 256 tokens; h2o-danube again with
#: a 128-token window at max_len 512 and 300 tokens, so the ring wraps
DVF = dict(batch=2, seq=256)
RING = dict(window=128, max_len=512, seq=300)
RING_ARCH = "h2o-danube-1.8b"
#: the f32 decode-vs-forward runs of the MoE and MLA models (and their
#: planted faults) at cut depth, on an f32 model of this many layers drawn
#: from the same seed: qwen3-moe's 30.5 B parameters in f32 (122 GB) do
#: not fit the card, nor do nemotron-4-15b's 15.63 B (62.5 GB) beside the
#: 31.3 GB of its bf16 model; at 8 layers it holds 6.27 B (25 GB)
DVF_F32_LAYERS = {"qwen3-moe-30b-a3b": 4, "minicpm3-4b": 4,
                  "recurrentgemma-9b": 5, "nemotron-4-15b": 8}
# The largest |logit| difference, decode against forward, per run, with the
# served bf16 weights and with the same weights in float32 (TF32 off).  On
# an H100 (NVIDIA H100 80GB HBM3, 700 W) the first runs read, bf16 / f32:
# h2o-danube 0.047 / 1.3e-5, the ring 0.051 / 1.2e-5, mamba2 0.30 / 5.8e-5
# (mamba2's bf16 gap is larger: the JAX formulation runs the block's conv
# in bf16 and the decode's in f32).  Each limit is 2-3 times its reading in
# bf16 and 7-9 times in f32.  Planted faults (DVF_PLANTED) moved the
# largest difference to 0.30-6.2 in both dtypes; they must fail the f32
# check, whose floor is four orders of magnitude lower.  In bf16, mamba2's
# dA-without-dt fault (0.37) hides under the gap of 0.30 and its limit.
# The MoE forward runs with the capacity of every token (decode drops
# none).  MLA decodes in the absorbed form, the forward in the naive one.
# qwen3-moe and minicpm3 read 0.094 / 1.4e-5 and 0.094 / 1.3e-5 (the f32
# runs at 4 layers; argmax agreeing at 97% of positions in bf16); their
# limits are 2.7 times that in bf16 and 7-8 times in f32.  Planted: tokens
# routed to expert 0 dropped in decode 0.078, MLA decode without its rope
# scores 1.26 (f32).  phi-3-vision (MHA, 32 heads of 96, the dense branch)
# read 0.0625 / 1.3e-5 and whisper-tiny (decoding from its encoded cross
# K/V, against a forward over the same frames) 0.031 / 5.2e-6, on an H100
# (NVIDIA H100 80GB HBM3, 700 W); their limits are 2.4 times that in bf16
# and 7.5-7.7 times in f32.  Planted, f32: whisper's decoder sinusoid one
# position ahead 0.54, cross V read as K 0.0076, each layer reading the
# next layer's cross K/V 5.1.  recurrentgemma-9b (38 layers, its f32 runs
# at 5: one group and the rec tail) read 0.098 / 3.6e-5, its local-
# attention ring (window 128 over 300 tokens) 3.6e-5 in f32, on an H100
# (NVIDIA H100 80GB HBM3, 700 W); the limits are 2.6 times that in bf16
# and 8.3-8.4 times in f32.  Planted, f32: the RG-LRU conv window shifted
# the wrong way 10.1, the state not decayed 8.6, the local window ignored
# in decode 9.9.  nemotron-4-15b (RoPE on the first half of each head; its
# f32 runs at 8 layers) read 0.070 at 32 layers / 2.3e-5, on an H100
# (NVIDIA H100 80GB HBM3, 700 W); the limits are 2.8 times that in bf16 and
# 8.7 times in f32.  Planted, f32: the key rotated over the whole head in
# decode 1.07.  kimi-k2-1t-a32b (2 of its 61 layers, one dense and one MoE;
# bf16 only) read 0.0625 with argmax agreeing at 98.4% of positions, on an
# H100 (NVIDIA H100 80GB HBM3, 700 W); its limit is 2 times that.  Planted,
# bf16, in decode's moe: the shared expert left out 0.51, top_w not
# renormalised over the chosen 8 of 384 experts 0.18 (1.4 times the limit;
# a limit of 3 times the reading, 0.1875, would let it pass).
DVF_TOL = {"h2o-danube-1.8b": {"bfloat16": 0.15, "float32": 1e-4},
           "ring": {"bfloat16": 0.15, "float32": 1e-4},
           "mamba2-780m": {"bfloat16": 0.6, "float32": 5e-4},
           "qwen3-moe-30b-a3b": {"bfloat16": 0.25, "float32": 1e-4},
           "minicpm3-4b": {"bfloat16": 0.25, "float32": 1e-4},
           "phi-3-vision-4.2b": {"bfloat16": 0.15, "float32": 1e-4},
           "whisper-tiny": {"bfloat16": 0.075, "float32": 4e-5},
           "recurrentgemma-9b": {"bfloat16": 0.25, "float32": 3e-4},
           "hybrid_ring": {"float32": 3e-4},
           "nemotron-4-15b": {"bfloat16": 0.2, "float32": 2e-4},
           "kimi-k2-1t-a32b": {"bfloat16": 0.125}}
#: the shared expert left out of moe.moe_mlp (planted in decode's copy of
#: moe, and in the MoE block's check)
SHARED_EXPERT_LEFT_OUT = ('if "shared" in params:', "if False:")
#: planted faults, each a one-line change to a copy of a module's source
#: (decode's ``A``, attention, ``S``, ssm, ``MOE``, moe, or ``R``, rglru;
#: ``D``: decode itself) that the f32 decode-vs-forward check (the bf16
#: one of a model of SERVE_LAYERS, which has no f32 run) must catch:
#: (module, run, old, new)
DVF_PLANTED = {
    "rope_query_off_by_one": (
        "A", "h2o-danube-1.8b",
        "q = L.apply_rope(q, p, cfg.rope_theta, cfg.rope_fraction, ctx.rope)",
        "q = L.apply_rope(q, p + 1, cfg.rope_theta, cfg.rope_fraction)"),
    "ring_slot_off_by_one": ("A", "ring", "slot = pos % cache_len if",
                             "slot = (pos + 1) % cache_len if"),
    "ssm_conv_cache_shifted": ("S", "mamba2-780m",
                               "new_conv = seq[:, 1:, lo:lo + Cl]",
                               "new_conv = seq[:, :-1, lo:lo + Cl]"),
    "ssm_dA_without_dt": ("S", "mamba2-780m",
                          "dA = torch.exp(dt * A)", "dA = torch.exp(A)"),
    "moe_tokens_to_expert_0_dropped": (
        "MOE", "qwen3-moe-30b-a3b", "keep = pos_in_e < C ",
        "keep = (pos_in_e < C) & (flat_e != 0) "),
    "mla_without_k_rope": (
        "A", "minicpm3-4b",
        "+ torch.matmul(q_rope.view(B, H, -1), k_rope.transpose(1, 2))",
        ""),
    "audio_sinusoid_off_by_one": (
        "D", "whisper-tiny", "L.sinusoid_at(pos, cfg.d_model)",
        "L.sinusoid_at(pos + 1, cfg.d_model)"),
    "cross_v_read_as_cross_k": (
        "D", "whisper-tiny",
        'T.cross_attend(p["xattn"], q, bp["cross_k"], bp["cross_v"], cfg)',
        'T.cross_attend(p["xattn"], q, bp["cross_v"], bp["cross_v"], cfg)'),
    "cross_kv_of_the_next_layer": (
        "D", "whisper-tiny", "TR.tree_map(lambda t: t[i], xa)",
        "TR.tree_map(lambda t: t[(i + 1) % cfg.n_layers], xa)"),
    "rglru_conv_cache_shifted": ("R", "recurrentgemma-9b",
                                 "new_conv = seq[:, 1:]",
                                 "new_conv = seq[:, :-1]"),
    "rglru_state_not_decayed": ("R", "recurrentgemma-9b",
                                "h = torch.exp(log_a) * cache.h + b",
                                "h = cache.h + b"),
    "hybrid_decode_ignores_local_window": ("D", "hybrid_ring",
                                           "cfg.hybrid.local_window", "0"),
    "rope_key_over_the_whole_head": (
        "A", "nemotron-4-15b",
        "k_new = L.apply_rope(k_new, p, cfg.rope_theta, cfg.rope_fraction,\n"
        "                         ctx.rope)",
        "k_new = L.apply_rope(k_new, p, cfg.rope_theta, 1.0)"),
    "moe_shared_expert_left_out": ("MOE", "kimi-k2-1t-a32b",
                                   *SHARED_EXPERT_LEFT_OUT),
    "moe_top_w_not_renormalised": (
        "MOE", "kimi-k2-1t-a32b",
        "top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)",
        "top_w = top_w"),
}
#: the MoE block at full width against its plain version
#: (plain_grouped_moe, with the shared expert): the loaded model's first
#: MoE layer on 2 x 256 bf16 inputs from the model's generator, at the
#: config's capacity (kimi-k2: 1.25, C = 16 for 512 tokens, so tokens
#: drop) and at the no-drop capacity, within DIST_MOE_TOL; each planted
#: fault in moe.py must fail it at both
MOE_BLOCK = dict(batch=2, seq=256)
MOE_BLOCK_ARCHS = ("kimi-k2-1t-a32b",)
MOE_BLOCK_PLANTED = {
    "moe_shared_expert_left_out": SHARED_EXPERT_LEFT_OUT,
    "moe_tokens_to_expert_0_dropped": DVF_PLANTED[
        "moe_tokens_to_expert_0_dropped"][2:]}


def planted_module(module, old: str, new: str):
    """A copy of ``module`` built from its source with ``old`` (which must
    occur once) replaced by ``new``."""
    import types
    with open(module.__file__) as f:
        src = f.read()
    check(src.count(old) == 1, f"{module.__name__}: {old!r} occurs "
          f"{src.count(old)} times")
    copy = types.ModuleType(module.__name__ + "_planted")
    copy.__file__ = module.__file__
    exec(compile(src.replace(old, new), module.__file__, "exec"),
         copy.__dict__)
    return copy


def busy_share(trace: str, step_ms: list) -> dict:
    """Device kernel time over the host-clock time of a profile window's
    steps, and the kernels per step."""
    ks = trace_kernels(trace)
    busy_ms = sum(d for _, _, d in ks) / 1e3
    return {"device_ms": busy_ms, "host_ms": sum(step_ms),
            "device_busy_share": busy_ms / sum(step_ms),
            "kernels_per_step": len(ks) / len(step_ms)}


def bench_rows(rows: list, kernel: str) -> dict:
    """The kernel bench's rows of one kernel, by name, for the kernels
    line: device and events microseconds, plain, library, bytes, GB/s,
    and the check against the plain version."""
    keys = ("shape", "g_dtype", "state_dtype", "us_events", "us_device",
            "us_plain", "us_library", "kernel_bytes", "gb_per_s",
            "share_of_hbm", "vs_plain")
    return {r["name"]: {k: r.get(k) for k in keys} for r in rows
            if r["kernel"] == kernel}


def serve_dvf(dev, label, cfg, params, toks, window_override=None,
              max_len=None, frames=None) -> tuple:
    """Decode against forward on the sequences ``toks`` (and an audio
    model's ``frames``, which encode_for_decode turns into the cross K/V
    decode reads) with one model: ``(reading, {planted fault: reading})``;
    the reading must pass ``DVF_TOL[label]``, each planted fault of
    ``label`` (f32 runs only; bf16 for a model of SERVE_LAYERS) must fail
    it."""
    from repro_torch.models import attention as A
    from repro_torch.models import decode as D
    from repro_torch.models import moe as MOE
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    seq = toks.shape[1]
    max_len = max_len or seq
    dtype = cfg.param_dtype
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames

    def gap(dm=D):
        cache = dm.init_cache(cfg, toks.shape[0], max_len, window_override,
                              device=dev)
        if frames is not None:
            cache = dm.encode_for_decode(params, cache, frames, cfg)
        dec, _ = dm.prefill_cache(params, cache, toks, 0, cfg,
                                  window_override, all_logits=True)
        fwd, _ = T.forward(params, batch, MOE.no_drop(cfg),
                           window_override=window_override)
        d = (dec - fwd).abs()
        return {"max_abs_err": float(d.max()),
                "rms_err": float(d.square().mean().sqrt()),
                "logit_rms": float(fwd.square().mean().sqrt()),
                "argmax_agree": float((dec.argmax(-1) == fwd.argmax(-1))
                                      .float().mean())}

    tol = DVF_TOL[label][dtype]
    g = gap()
    check(g["max_abs_err"] <= tol, f"decode vs forward ({label}, {dtype}): "
          f"{g} past {tol}")
    g.update(window_override=window_override, max_len=max_len, seq=seq,
             n_layers=cfg.n_layers)
    planted = {}
    for name, (mod, run, old, new) in DVF_PLANTED.items():
        if run != label or dtype != ("bfloat16" if label in SERVE_LAYERS
                                     else "float32"):
            continue
        if mod == "D":
            e = gap(planted_module(D, old, new))
        else:
            setattr(D, mod, planted_module(getattr(D, mod), old, new))
            try:
                e = gap()
            finally:
                D.A, D.S, D.MOE, D.R = A, S, MOE, R
        planted[name] = e
        check(e["max_abs_err"] > tol, f"planted fault {name} passes the "
              f"decode vs forward check ({label}, {dtype}): {e}")
    return g, planted


def serve_traffic(dev, arch, cfg, params, gen, tmp) -> tuple:
    """One model's full-width traffic through the scheduler, profiled; its
    first requests alone and request 0 twice through Engine.generate
    bit-equal to the packed run; one decode step over the full arena timed
    and profiled.  Returns (summary, FrODO kernel launches)."""
    import numpy as np
    import torch
    from repro_torch import tree as TR
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import frames_shape, run_traffic, traffic
    from repro_torch.obs.metrics import read_jsonl
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                               masked_decode)

    trace_kw, n_solo = SERVE_TRAFFIC[arch]
    sched_kw = {k: trace_kw[k] for k in ("max_slots", "max_len",
                                         "prefill_chunk", "token_budget")}
    n_bytes = sum(t.numel() * t.element_size() for t in TR.leaves(params))
    path = os.path.join(tmp, f"full_{arch}.jsonl")
    prof_dir = os.path.join(tmp, f"prof_{arch}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    KU.reset_launches()
    # ``cfg`` may be a depth cut of the registry's
    summary = run_traffic(arch=arch, smoke=False, device=dev,
                          init_fn=lambda seed: params, metrics_out=path,
                          quiet=True, profile_dir=prof_dir,
                          profile_start=SERVE_PROFILE[0],
                          profile_stop=SERVE_PROFILE[1],
                          n_layers=cfg.n_layers, **trace_kw)
    torch.cuda.synchronize(dev)
    launches = dict(ops.LAUNCHES)
    check(sum(launches.values()) == 0,
          f"FrODO kernels launched on the serve path: {launches}")
    peak = torch.cuda.max_memory_allocated(dev)
    rows = read_jsonl(path)
    steps = [r for r in rows if r["name"] == "serve.step"]
    reqs = [r for r in rows if r["name"] == "serve.request"]
    check(len(reqs) == trace_kw["n_requests"]
          and max(r["occupancy"] for r in steps) > 1,
          f"serve {arch}: {len(reqs)} requests done, occupancy "
          f"{max(r['occupancy'] for r in steps)}")

    # the first requests alone, each in a fresh scheduler (an audio
    # request with its frames)
    trace = [r for rd in traffic(cfg.vocab, **{
        k: trace_kw[k] for k in ("n_requests", "rate", "prompt_len_range",
                                 "new_tokens_range", "seed")},
        frames_shape=frames_shape(cfg)) for r in rd]
    sc = SchedulerConfig(**sched_kw)
    for i, req in enumerate(trace[:n_solo]):
        sch = Scheduler(cfg, params, sc)
        solo = sch.result(sch.submit(*req)).tolist()
        check(solo == summary["tokens"][i],
              f"serve {arch}: request {i} alone {solo} != packed "
              f"{summary['tokens'][i]}")
    # Engine.generate: request 0 twice in one batch, against alone
    prompt, n_new = trace[0][:2]
    out = Engine(cfg, params, **sched_kw).generate(
        np.stack([prompt, prompt]), n_new,
        np.stack([trace[0][2]] * 2) if len(trace[0]) == 3 else None)
    check(all(row.tolist() == summary["tokens"][0] for row in out),
          f"serve {arch}: Engine.generate {out.tolist()} != alone "
          f"{summary['tokens'][0]}")

    # one decode step over a full arena, timed and profiled
    sch = Scheduler(cfg, params, sc)
    n = sc.max_slots
    toks = torch.randint(1, cfg.vocab, (n, 1), generator=gen, device=dev)
    pos = torch.full((n,), 100, dtype=torch.int64, device=dev)
    active = torch.arange(n, device=dev)
    for _ in range(n):
        sch.pool.alloc()

    def step():
        return masked_decode(params, sch.pool, toks, pos, active, cfg, None)

    dec_ms = cuda_ms(step, reps=10)
    rows_k = device_kernel_us(step)
    dec_dev_ms = sum(us for _, us in rows_k.values()) / 1e3
    arena_bytes = sum(t.numel() * t.element_size()
                      for t in TR.leaves(sch.pool.arena))
    step_bytes = decode_read_bytes(cfg, params, n)
    del sch
    p0, p1 = SERVE_PROFILE
    decode_steps = [r for r in steps if r["n_decode"] > 0]
    gaps = [r["step_time_ms"] for r in decode_steps]
    pre = sum(r["prefill_tokens"] for r in steps)
    out = {
        "width": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                  "vocab": cfg.vocab, "param_dtype": cfg.param_dtype},
        "params": sum(t.numel() for t in TR.leaves(params)),
        "weight_bytes": n_bytes, "trace": trace_kw, "solo_runs": n_solo,
        "steps": len(steps), "new_tokens": summary["total_new_tokens"],
        "decode_tokens": sum(r["decode_tokens"] for r in steps),
        "prefill_tokens": pre,
        "decode_tokens_per_s_launcher": summary["decode_tokens_per_s"],
        "decode_tokens_per_s": sum(r["decode_tokens"] for r in steps)
        / (sum(r["phase_decode_ms"] for r in steps) / 1e3),
        "mean_ttft_ms": statistics.mean(r["ttft_ms"] for r in reqs),
        "mean_ttft_steps": statistics.mean(r["ttft_steps"] for r in reqs),
        "ttft_ms_median_max": [statistics.median(r["ttft_ms"] for r in reqs),
                               max(r["ttft_ms"] for r in reqs)],
        # a decoding request gets one token a step: the gap between its
        # tokens is the step's time, prefills in it included
        "token_gap_ms_median_p90": [statistics.median(gaps),
                                    statistics.quantiles(gaps, n=10)[-1]],
        "ms_per_step": {k: statistics.mean(r[k] for r in steps)
                        for k in ("step_time_ms", "phase_admission_ms",
                                  "phase_prefill_ms", "phase_decode_ms",
                                  "phase_telemetry_ms")},
        "decode_phase_ms_median": statistics.median(
            r["phase_decode_ms"] for r in decode_steps),
        "ms_per_prefill_token": sum(r["phase_prefill_ms"]
                                    for r in steps) / pre,
        "profile_steps": [p0, p1],
        "profile": busy_share(os.path.join(prof_dir, "trace.json"),
                              [r["step_time_ms"] for r in steps[p0:p1 + 1]]),
        "peak_memory_bytes": peak,
        "decode_step_full_arena": {
            "slots": n, "position": 100, "ms_events": dec_ms,
            "device_ms": dec_dev_ms if rows_k else None,
            "kernels": sum(c for c, _ in rows_k.values()),
            "weight_read_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "step_read_bytes": step_bytes,
            "step_read_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "arena_bytes": arena_bytes,
            "weight_and_arena_read_bound_ms": (n_bytes + arena_bytes)
            / HBM_BYTES_PER_S * 1e3},
        "solo_vs_packed": f"first {n_solo} requests bit-equal",
        "engine_vs_solo": "bit-equal"}
    return out, launches


def decode_read_bytes(cfg, params, rows: int) -> int:
    """The weight bytes one decode step of ``rows`` tokens reads: every
    leaf whole (MoE decode runs every expert, ``moe.moe_mlp``'s batched
    products), but an untied embedding table, of which it gathers
    ``rows`` rows."""
    from repro_torch import tree as TR

    n = sum(t.numel() * t.element_size() for t in TR.leaves(params))
    if cfg.tie_embeddings:
        return n
    table = params["embed"]["table"]
    return n - table.numel() * table.element_size() \
        + rows * table.shape[-1] * table.element_size()


def serve_moe_block(dev, cfg, params, gen) -> dict:
    """The loaded model's first MoE layer (``blocks/moe`` at index 0)
    against plain_grouped_moe on MOE_BLOCK's bf16 inputs, at the config's
    capacity and at the no-drop one, within DIST_MOE_TOL; each planted
    fault of MOE_BLOCK_PLANTED must fail at both."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.models import moe as MOE

    p = TR.tree_map(lambda t: t[0], params["blocks"]["moe"])
    x = torch.randn((MOE_BLOCK["batch"], MOE_BLOCK["seq"], cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    n = MOE_BLOCK["batch"] * MOE_BLOCK["seq"]
    planted = {name: planted_module(MOE, old, new)
               for name, (old, new) in MOE_BLOCK_PLANTED.items()}
    out = {}
    with torch.no_grad():
        top_e = MOE.route(p, x.reshape(n, -1), cfg)[3]
        counts = MOE._expert_counts(top_e.reshape(-1), cfg.moe.n_experts)
        for label, c in (("config", cfg), ("no_drop", MOE.no_drop(cfg))):
            C = MOE._capacity(n, c.moe)
            want = plain_grouped_moe(p, x, c)
            got, _ = MOE.moe_mlp(p, x, c, with_aux=False)
            ok, err = moe_close(got, want)
            check(ok, f"{cfg.arch_id} MoE block ({label}) vs the plain "
                  f"version: {err}")
            check(bool(torch.isfinite(got).all()),
                  f"{cfg.arch_id} MoE block ({label}) not finite")
            row = {"capacity_factor": c.moe.capacity_factor, "capacity": C,
                   "assignments": n * cfg.moe.top_k,
                   "dropped": int((counts - C).clamp(min=0).sum()),
                   "max_abs_err": err,
                   "plain_max_abs": float(want.float().abs().max()),
                   "planted": {}}
            for name, mod in planted.items():
                bad, _ = mod.moe_mlp(p, x, c, with_aux=False)
                caught = not moe_close(bad, want)[0]
                e = float((bad.float() - want.float()).abs().max())
                check(caught, f"planted fault {name} passes the "
                      f"{cfg.arch_id} MoE block check ({label}): {e}")
                row["planted"][name] = e
            out[label] = row
    return {"tokens": [MOE_BLOCK["batch"], MOE_BLOCK["seq"]],
            "layer": "blocks/moe[0]", "tol": DIST_MOE_TOL, **out}


def first_layers(cfg, params, n: int) -> tuple:
    """``(cfg, params)`` cut to the first ``n`` layers of the model's layer
    stack (views of the loaded tensors: nothing is drawn again); a hybrid
    model to its first ``n / len(pattern)`` whole groups, without the tail
    blocks."""
    from repro_torch import tree as TR

    if cfg.family == "hybrid":
        k = len(cfg.hybrid.pattern)
        check(n % k == 0, f"{cfg.arch_id}: {n} layers are not whole groups")
        kept = {key: v for key, v in params.items() if key != "tail_blocks"}
        return cfg.replace(n_layers=n), {
            **kept, "groups": TR.tree_map(lambda t: t[:n // k],
                                          params["groups"])}
    check(set(params) <= {"embed", "ln_f", "lm_head", "blocks"},
          f"{cfg.arch_id}: a depth cut needs one layer stack, not "
          f"{sorted(params)}")
    return cfg.replace(n_layers=n), {
        **params, "blocks": TR.tree_map(lambda t: t[:n], params["blocks"])}


#: the serving phase's models in five groups: the first (qwen3-moe: its 48
#: layers hold 61 GB; then nemotron-4-15b, 31.3 GB) in this process beside
#: the second (peaks of 0.5-1.8 GB) in a process of its own; then the last
#: here beside the third and the fourth in two more (the peaks after the
#: first add to ~40 GB)
SERVE_GROUPS = (("qwen3-moe-30b-a3b", "nemotron-4-15b"),
                ("mamba2-780m", "whisper-tiny"),
                ("h2o-danube-1.8b",),
                ("phi-3-vision-4.2b", "recurrentgemma-9b"),
                ("minicpm3-4b",))


def serve_phase(dev) -> dict:
    """Serving on the card (:func:`serve_models`) over SERVE_GROUPS: this
    process serves the first group (qwen3-moe, 61 GB of the card) beside
    the second (small models) in a process of its own, then the last
    beside the third and the fourth in two more.  Returns the FrODO
    kernels' launches on the serve path of each model (there are none)."""
    check(sorted(sum(SERVE_GROUPS, SERVE_LATE)) == sorted(SERVE_ARCHS),
          f"SERVE_GROUPS {SERVE_GROUPS} and SERVE_LATE != SERVE_ARCHS")
    small = start_phase(serve_models, SERVE_GROUPS[1])
    parts = [serve_models(dev, SERVE_GROUPS[0])]
    rest = [start_phase(serve_models, g) for g in SERVE_GROUPS[2:-1]]
    parts.append(serve_models(dev, SERVE_GROUPS[-1]))
    parts += [finish_phase(h) for h in (small, *rest)]
    out = {k: {a: v for p in parts for a, v in p[k].items()}
           for k in parts[0]}
    emit("serve", nvidia_smi=nvidia_smi(), card_vs_cpu=out["card_vs_cpu"],
         card_vs_cpu_trace=SERVE_SMOKE, decode_vs_forward=out["dvf"],
         planted_faults=out["planted"], dvf_tol=DVF_TOL,
         dvf_f32_layers=DVF_F32_LAYERS,
         traffic_layers=SERVE_TRAFFIC_LAYERS,
         groups=[list(g) for g in SERVE_GROUPS])
    return {"launches": out["launches"], "decode_vs_forward": out["dvf"],
            "planted": out["planted"], "traffic": out["traffic"]}


def serve_late_phase(dev) -> dict:
    """Serving SERVE_LATE (kimi-k2-1t-a32b at the depth of SERVE_LAYERS)
    through :func:`serve_models`, alone on the card; its ``serve.late``
    line adds the MoE block against its plain version and each model's
    peak memory.  Returns the FrODO kernels' launches on its serve path
    (there are none)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = serve_models(dev, SERVE_LATE)
    emit("serve.late", nvidia_smi=nvidia_smi(), archs=list(SERVE_LATE),
         card_vs_cpu=out["card_vs_cpu"], card_vs_cpu_trace=SERVE_SMOKE,
         decode_vs_forward=out["dvf"], planted_faults=out["planted"],
         dvf_tol={a: DVF_TOL[a] for a in SERVE_LATE},
         moe_block=out["moe_block"],
         reduced={a: SERVE_LAYERS[a][1] for a in SERVE_LATE
                  if a in SERVE_LAYERS},
         peak_memory_bytes={a: max(t["peak_memory_bytes"],
                                   t["checks_peak_memory_bytes"])
                            for a, t in out["traffic"].items()},
         seconds=time.perf_counter() - t0)
    return {"launches": out["launches"]}


def serve_models(dev, archs: tuple) -> dict:
    """Serving ``archs`` on the card: the launcher's default trace on the
    card against the card machine's CPU (smoke configs, f32); then per
    model at full width and depth: decode against the full-sequence
    forward (and the ring; the f32 run of the MoE and MLA models at cut
    depth), with planted faults that must fail the same check, and traffic
    through the scheduler, solo runs and Engine.generate bit-equal to the
    packed run, timed and profiled.  A model of SERVE_LAYERS runs at its
    cut depth throughout, in bf16 only, its planted faults in bf16; a
    model of MOE_BLOCK_ARCHS also holds its first MoE layer against the
    plain version.  Each model draws its inputs from a generator of its own
    (seeded by its place in SERVE_ARCHS)."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.launch.serve import load_model, run_traffic
    from repro_torch.models import transformer as T
    from repro_torch.obs.metrics import read_jsonl

    tmp = tempfile.mkdtemp(prefix="serve_")

    # ---------------------------------- card against CPU, smoke configs
    card_cpu = {}
    for arch in archs:
        cfg = REG.get_smoke_config(arch).replace(param_dtype="float32",
                                                 compute_dtype="float32")
        init = TR.tree_map(lambda t: t.numpy(), T.init_params(
            torch.Generator().manual_seed(0), cfg))
        runs = {}
        for where in (dev, "cpu"):
            path = os.path.join(tmp, f"smoke_{arch}_{where}.jsonl")
            s = run_traffic(arch=arch, smoke=True, param_dtype="float32",
                            init_fn=lambda seed: init, device=where,
                            metrics_out=path, quiet=True, **SERVE_SMOKE)
            steps = [{k: r[k] for k in SERVE_STEP_KEYS}
                     for r in read_jsonl(path) if r["name"] == "serve.step"]
            runs["cpu" if where == "cpu" else "card"] = (s["tokens"], steps)
        check(runs["card"] == runs["cpu"],
              f"serve {arch} smoke: card and CPU differ: {runs}")
        card_cpu[arch] = {"requests": len(runs["card"][0]),
                          "tokens": sum(map(len, runs["card"][0])),
                          "steps": len(runs["card"][1]),
                          "tokens_and_step_columns": "equal"}

    # --------------- per model, full width and depth: decode vs forward,
    # then traffic
    dvf, planted, traffic_out, launches, moe_block = {}, {}, {}, {}, {}
    for arch in archs:
        gen = torch.Generator(device=dev).manual_seed(
            3 + SERVE_ARCHS.index(arch))
        cut, reduced = SERVE_LAYERS.get(arch, (0, None))
        torch.cuda.reset_peak_memory_stats(dev)
        cfg, params = load_model(arch, False, 0, dev, n_layers=cut)
        runs = {arch: (None, None, DVF["seq"])}
        if arch == RING_ARCH:
            runs["ring"] = (RING["window"], RING["max_len"], RING["seq"])
        for label, (wo, max_len, seq) in runs.items():
            toks = torch.randint(1, cfg.vocab, (DVF["batch"], seq),
                                 generator=gen, device=dev)
            frames = (torch.randn((DVF["batch"], cfg.n_frames, cfg.d_model),
                                  generator=gen, device=dev)
                      if cfg.family == "audio" else None)
            dvf[f"{label}/bfloat16"], p_ = serve_dvf(
                dev, label, cfg, params, toks, wo, max_len, frames)
            planted.update(p_)
            if reduced:
                dvf[f"{label}/bfloat16"]["reduced"] = reduced
            elif arch not in DVF_F32_LAYERS:
                cfg32 = cfg.replace(param_dtype="float32",
                                    compute_dtype="float32")
                params32 = TR.tree_map(lambda t: t.float(), params)
                dvf[f"{label}/float32"], p_ = serve_dvf(
                    dev, label, cfg32, params32, toks, wo, max_len, frames)
                planted.update(p_)
                del params32
                torch.cuda.empty_cache()
        if arch in MOE_BLOCK_ARCHS:
            moe_block[arch] = serve_moe_block(dev, cfg, params, gen)
        # the draw and the checks above (serve_traffic resets the peak)
        checks_peak = torch.cuda.max_memory_allocated(dev)
        cfg_t, params_t = cfg, params
        if arch in SERVE_TRAFFIC_LAYERS:
            cfg_t, params_t = first_layers(cfg, params,
                                           SERVE_TRAFFIC_LAYERS[arch][0])
        traffic_out[arch], launches[f"serve_{arch}"] = serve_traffic(
            dev, arch, cfg_t, params_t, gen, tmp)
        traffic_out[arch]["checks_peak_memory_bytes"] = checks_peak
        if arch in SERVE_TRAFFIC_LAYERS:
            traffic_out[arch]["reduced"] = {
                "n_layers": SERVE_TRAFFIC_LAYERS[arch][1]}
        elif reduced:
            traffic_out[arch]["reduced"] = reduced
        del params_t
        emit("serve.traffic", arch=arch, nvidia_smi=nvidia_smi(),
             **traffic_out[arch])
        del params
        torch.cuda.empty_cache()
        if arch in DVF_F32_LAYERS:
            cfg32 = cfg.replace(param_dtype="float32",
                                compute_dtype="float32",
                                n_layers=DVF_F32_LAYERS[arch])
            params32 = T.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg32,
                device=dev)
            dvf[f"{arch}/float32"], p_ = serve_dvf(dev, arch, cfg32,
                                                   params32, toks)
            planted.update(p_)
            if cfg.family == "hybrid":
                # the local-attention ring wraps: a 128-token window over
                # 300 tokens at max_len 512
                ring = cfg32.replace(hybrid=dataclasses.replace(
                    cfg32.hybrid, local_window=RING["window"]))
                rtoks = torch.randint(1, cfg.vocab,
                                      (DVF["batch"], RING["seq"]),
                                      generator=gen, device=dev)
                dvf["hybrid_ring/float32"], p_ = serve_dvf(
                    dev, "hybrid_ring", ring, params32, rtoks,
                    max_len=RING["max_len"])
                dvf["hybrid_ring/float32"]["local_window"] = RING["window"]
                planted.update(p_)
            del params32
            torch.cuda.empty_cache()
    return {"card_vs_cpu": card_cpu, "launches": launches, "dvf": dvf,
            "planted": planted, "traffic": traffic_out,
            "moe_block": moe_block}


# ---------------------- the dry-run, the roofline and the experiments' CLIs
#: the dry-run's probed pair: the llm_train run's model and shape (probed
#: at global batch 4 with exp-sum K = 8 and f32 accumulators, the
#: dry-run's default TrainConfig, at 2 of its 8 microbatches: the rows an
#: agent allow no more), and the depth of the llm_train run its
#: extrapolation is printed beside
DRYRUN_PROBE = ("h2o-danube-1.8b", "train_4k")
#: the ablation arms' rounds on the card (the JAX script's K_MAX is 4000),
#: and the dtype arm's steps (its default is 800): the card script's time
ABLATION_ROUNDS = 600
ABLATION_DTYPE_STEPS = 300
ABLATION_REDUCED = {
    "rounds": f"4000 -> {ABLATION_ROUNDS} (the lambda, K and interval "
              "arms): the card script's 1,200 s; a count of "
              f"{ABLATION_ROUNDS} reads 'not converged'",
    "dtype_steps": f"800 -> {ABLATION_DTYPE_STEPS}"}
#: the plain path's run on the card at every point, and a planted fault
#: (beta 1% high, the plain path) at three points, over their first
#: ABLATION_PLAIN_ROUNDS rounds, where the dynamics move fastest
ABLATION_PLAIN_ROUNDS = 100
ABLATION_PLANTED = {"beta_x1.01": dict(beta=0.35 * 1.01)}
#: (arm, point, the point's run: condition number, interval, FrODO)
ABLATION_PLANTED_POINTS = (
    ("lambda_sensitivity", "cond10/lam=0.2", 10.0, 1, dict(lam=0.2)),
    ("expsum_K", "K=8", 100.0, 1, dict(memory_mode="expsum", K=8)),
    ("consensus_interval_H", "H=8", 100.0, 8, {}))
# Per-round error (mean distance to x*), kernel path vs plain path: the
# kernels form -(a g + b M) in f32 with one rounding where the plain path
# rounds each term, and the dynamics carry that rounding.  On an H100
# (700 W) the two parted by 3.9e-6 at most over 100 (and over 300) rounds
# at the 22 points, while beta 1% high departed by 2.6e-3 to 4.3e-3 at the
# three planted points (the phase's kernel_vs_plain readings).  Iteration
# counts are not compared: the error oscillates as it decays, and where a
# dip grazes 1e-6 that rounding moves the count by a whole swing (lambda
# = 0.1, cond 10: 274 rounds on the card, 323 in the JAX script on the
# CPU).
ABLATION_ERR_TOL = dict(rtol=1e-3, atol=1e-5)


def dryrun_phase(dev, out: str, llm_main: dict) -> dict:
    """The dry-run over every arch x shape on the meta path (each record
    ``ok``, or skipped with the reason of ``registry.shape_supported``),
    then the probed pair on the card: steps at trip counts 2 and 3,
    extrapolated to the model's depth and to the llm_train run's."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.experiments import roofline as RF
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    check(DR.main(["--all", "--device", "cuda", "--out", out]) == 0,
          "dry-run --all recorded an error")
    meta_s = time.perf_counter() - t0
    recs = {(r["arch"], r["shape"]): r for r in RF.load_records(out)}
    check(len(recs) == len(REG.ARCH_IDS) * len(INPUT_SHAPES),
          f"dry-run records: {len(recs)}")
    for (arch, shape), r in recs.items():
        ok, reason = REG.shape_supported(REG.get_config(arch),
                                         INPUT_SHAPES[shape])
        check(r["status"] == ("ok" if ok else "skipped")
              and r.get("reason", "") == reason,
              f"dry-run {arch} x {shape}: {r['status']} {r.get('reason')}")

    arch, shape = DRYRUN_PROBE
    cfg = REG.get_config(arch)
    n_leaves = len(meta_leaves(cfg, DR.N_AGENTS))
    KU.reset_launches()
    t0 = time.perf_counter()
    rec = DR.run_one(arch, shape, out, probes=True, device=dev)
    probe_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(rec["status"] == "ok", f"dry-run probe: {rec.get('error')}")
    # two probes (2 and 3 layers: the same leaves, stacked), two steps each
    check(launches == {"frodo_exact_update": 0,
                       "frodo_expsum_update": 4 * n_leaves},
          f"exp-sum launches on the dry-run probe: {launches}")
    trips = rec["probe"]["trip_counts"]
    check(all(t["device_ms"] > 0 and t["peak_bytes"] > 0
              for t in trips.values()), f"probe readings: {trips}")
    at_llm = DR._affine_extrapolate(trips["2"], trips["3"],
                                    LLM["n_layers"])
    emit("dryrun", nvidia_smi=nvidia_smi(), records=len(recs),
         ok=sum(r["status"] == "ok" for r in recs.values()),
         skipped={f"{a} x {s}": r["reason"] for (a, s), r in recs.items()
                  if r["status"] == "skipped"},
         meta_path_seconds=meta_s, probe_seconds=probe_s,
         probe={"arch": arch, "shape": shape, "n_agents": rec["n_agents"],
                "global_batch": rec["probe"]["global_batch"],
                "microbatches": rec["probe"]["microbatches"],
                "reduced": rec["probe"]["reduced"], "K": 8,
                "acc_dtype": "float32", "trip_counts": trips,
                "launches": launches,
                "extrapolated_to_depth": rec["extrapolated"],
                "extrapolated_to_llm_train_depth": at_llm,
                "llm_train_measured": dict(llm_main,
                                           n_layers=LLM["n_layers"])},
         memory_of_probed_pair=rec["memory"], fits=rec["fits"])
    return {"launches": launches, "probe": rec}


def roofline_phase(out: str, smi: str) -> dict:
    """The port's roofline over the dry-run's records, headed by the card's
    name and power limit."""
    from repro_torch.experiments import roofline as RF

    recs = RF.load_records(out)
    text = RF.report(recs, card=smi)
    with open(os.path.join(out, "roofline_torch.md"), "w") as f:
        f.write(text)
    rows = [l for l in text.splitlines() if l.startswith("| ")
            and "| 1xH100 |" in l]
    n_ok = sum(r["status"] == "ok" for r in recs)
    check(text.startswith(f"Card: {smi}") and len(rows) == n_ok,
          f"roofline: {len(rows)} rows for {n_ok} records")
    probed = RF.roofline_terms(next(
        r for r in recs if (r["arch"], r["shape"]) == DRYRUN_PROBE))
    emit("roofline", nvidia_smi=smi, rows=len(rows),
         probed_pair={k: probed[k] for k in (
             "arch", "shape", "dominant", "t_compute_s", "t_memory_s",
             "t_link_s", "mfu_bound", "mem_per_dev_gib", "fits_hbm",
             "probe_device_ms")},
         peaks={"bf16_flops_per_s": RF.PEAK_FLOPS, "hbm_bytes_per_s":
                RF.HBM_BW, "hbm_per_card_bytes": RF.HBM_PER_CARD},
         link_note=RF.LINK_NOTE)
    return probed


def regress_phase(dev, tmp: str) -> dict:
    """``repro_torch.experiments.regress``: ``--check --exp exp1`` against
    the committed baseline, then ``--record`` and ``--check`` into a temp
    dir for serve (through the port's serve bench), train and exp2 (their
    committed baselines hold JAX initial weights, which the card has no
    JAX to draw)."""
    import contextlib
    import io

    from repro_torch.experiments import regress as RG

    def cli(*argv) -> tuple:
        """(exit code, report) of one regress call; its per-metric report
        and the runs' step lines go to a buffer, not the phase lines."""
        report = os.path.join(tmp, "report.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = RG.main([*argv, "--device", "cuda", "--report", report])
        with open(report) as f:
            return rc, json.load(f)

    out = {}
    t0 = time.perf_counter()
    rc, rep = cli("--check", "--exp", "exp1")
    check(rc == 0 and rep["passed"], f"regress --check exp1: {rep}")
    out["exp1_vs_committed"] = {k: rep[k] for k in ("n_checks",
                                                    "n_drifted")}
    out["exp1_seconds"] = time.perf_counter() - t0
    base_dir = os.path.join(tmp, "baselines_torch")
    for exp in ("serve", "train", "exp2"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = RG.main(["--record", "--exp", exp, "--baseline-dir",
                          base_dir, "--device", "cuda"])
        check(rc == 0, f"regress --record {exp}")
        rc, rep = cli("--check", "--exp", exp, "--baseline-dir", base_dir)
        check(rc == 0 and rep["passed"],
              f"regress {exp} round trip: {rep['n_drifted']} drifted")
        out[f"{exp}_round_trip"] = {
            "n_checks": rep["n_checks"], "n_drifted": rep["n_drifted"],
            "steps": RG.DEFAULT_STEPS[exp],
            "seconds": time.perf_counter() - t0}
    emit("regress", nvidia_smi=nvidia_smi(), **out,
         note="exp1 against the committed benchmarks/baselines/exp1.json "
              "(timing bands under the 0.05 ms floor are skipped); exp3's "
              "quadratic series in the exp3 phase through regress.check("
              "keep=...); serve, train and exp2 recorded and checked on "
              "the card's own weights")
    return out


def ablations_phase(dev, tmp: str) -> dict:
    """The four ablation arms through the kernels at ABLATION_ROUNDS (the
    launches of the path), each run's error trajectory against the plain
    path's on the card, and a planted fault that must fail the same
    check."""
    import numpy as np
    from repro_torch.experiments import ablations as AB
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops

    R_, S_, P_ = ABLATION_ROUNDS, ABLATION_DTYPE_STEPS, ABLATION_PLAIN_ROUNDS
    arm_fns = (("lambda_sensitivity", AB.lambda_sensitivity),
               ("expsum_K", AB.expsum_K),
               ("consensus_interval_H", AB.consensus_interval))
    KU.reset_launches()
    t0 = time.perf_counter()
    arms, secs, errs = {}, {}, {}
    for key, fn in arm_fns:
        t1 = time.perf_counter()
        errs[key] = {}
        arms[key] = fn(R_, dev, errors=errs[key])
        secs[key] = time.perf_counter() - t1
    t1 = time.perf_counter()
    path = os.path.join(tmp, "ablate_dtype.jsonl")
    arms["expsum_dtype"] = AB.expsum_dtype(path, steps=S_, device=dev)
    secs["expsum_dtype"] = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    path_s = time.perf_counter() - t0
    # one launch a round after the first: 12 lambda runs, exact T90 and 4
    # interval runs through the exact kernel; 5 K runs and the 2 dtype
    # runs through the exp-sum kernel
    want = {"frodo_exact_update": 17 * (R_ - 1),
            "frodo_expsum_update": 5 * (R_ - 1) + 2 * (S_ - 1)}
    check(launches == want, f"ablation launches {launches} != {want}")
    dt = arms["expsum_dtype"]
    check(all(np.isfinite(dt[d]["final_error"]) for d in dt),
          f"dtype arm: {dt}")

    t1 = time.perf_counter()
    plain, worst = {}, 0.0
    for key, fn in arm_fns:
        plain[key] = {}
        fn(P_, dev, use_kernel=False, errors=plain[key])
        for point, e in plain[key].items():
            ok, err = close_np(errs[key][point][:P_], e, ABLATION_ERR_TOL)
            check(ok, f"ablation {key} {point}: kernel vs plain errors "
                  f"{err}")
            worst = max(worst, err)
    planted = {}
    for name, fault in ABLATION_PLANTED.items():
        for key, point, cond, interval, kw in ABLATION_PLANTED_POINTS:
            e = AB._errors(AB._frodo(dev, False, **kw, **fault), cond, P_,
                           interval, dev)
            passes, err = close_np(errs[key][point][:P_], e,
                                   ABLATION_ERR_TOL)
            check(not passes, f"planted {name} at {key} {point} passes the "
                  f"kernel vs plain check ({err})")
            planted[f"{name}@{point}"] = err
    emit("ablations", nvidia_smi=nvidia_smi(), rounds=R_, dtype_steps=S_,
         reduced=ABLATION_REDUCED, seconds=path_s, seconds_by_arm=secs,
         launches=launches, arms=arms,
         kernel_vs_plain={"rounds": P_, "points": sum(len(v) for v in
                                                      plain.values()),
                          "max_abs_err": worst, "tol": ABLATION_ERR_TOL,
                          "planted_max_abs_err": planted,
                          "seconds": time.perf_counter() - t1})
    return launches


def harness_phase(dev, dryrun_dir: str, tmp: str) -> list:
    """``repro_torch.experiments.run consensus roofline ablations`` on the
    card (exp1, exp2 and kernels have phases of their own)."""
    import contextlib
    import io

    from repro_torch.experiments import run as RUN

    path = os.path.join(tmp, "harness.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = RUN.main(["consensus", "roofline", "ablations", "--device",
                         "cuda", "--ablation-rounds", str(ABLATION_ROUNDS),
                         "--dryrun-dir", dryrun_dir, "--metrics-out", path])
    names = [r[0] for r in rows]
    cons = [r for r in rows if r[0].startswith("consensus_")]
    check(len(cons) == 4 and all(r[2].endswith("clock=device") and r[1] > 0
                                 for r in cons), f"consensus rows {cons}")
    pairs = [r for r in rows if r[0] == "roofline_pairs_analyzed"]
    check(pairs == [("roofline_pairs_analyzed", 0.0, "count=39")],
          f"roofline rows: {pairs}")
    check(sum(n.startswith("ablation_") for n in names) == 6,
          f"ablation rows: {names}")
    check(buf.getvalue().splitlines()[0] == "name,us_per_call,derived",
          "harness CSV header")
    emit("harness", nvidia_smi=nvidia_smi(),
         which=["consensus", "roofline", "ablations"],
         ablation_rounds=ABLATION_ROUNDS, rows=[
             r for r in rows if not r[0].startswith("roofline_")
             or r[0] == "roofline_pairs_analyzed"],
         roofline_rows=sum(n.startswith("roofline_") for n in names) - 1)
    return rows


# ------------------------------------------------------------ distributed
#: the agent-sharded trainer: h2o-danube-1.8b at full width, 2 of its 24
#: layers, the train_4k sequence, 2 agents x 2 sequences, exp-sum K = 8
#: with f32 accumulators through the exp-sum kernel, remat, seed 0; the
#: one-process stacked run, the same step at world size 1 on NCCL, and two
#: ranks (one agent each) that share the one card over gloo.  The clip
#: (0.1 sqrt(A)) binds at every step (the phase checks it), so a norm left
#: unreduced changes the update.
def host_phases(dev, tmp: str) -> dict:
    """Exp 3's default scale in its last drop mode, then the regress CLI
    and the ablations: host-bound and light on the card's memory, they run
    in a process of their own beside the serving phase (and the exp3
    phase in another).  Returns the launches of the ablations' path."""
    mode = EXP3_MODES[-1]
    emit("exp3.default_scale", mode=mode,
         **exp3_default_scale(dev, mode))
    regress_phase(dev, tmp)
    return ablations_phase(dev, tmp)


DIST = dict(n_layers=2, seq=4096, batch_per_agent=2, agents=2, K=8,
            grad_clip=0.1, steps=4, planted_steps=1, ranks=2)
DIST_REDUCED = {
    "n_layers": "24 -> 2 (the dry-run probe's 2-layer step)",
    "steps": "6 -> 4 (room for the tensor_parallel phase, which holds its "
             "ranks against this phase's stacked run)",
    "global_batch": "256 -> 4 (2 agents x 2 sequences of train_4k's 4096)",
    "ranks": "2 ranks, one agent each, share one H100 over gloo (NCCL "
             "refuses two ranks on one card); NCCL runs at world size 1"}
#: the world-1 group's backend (each rank its own card)
DIST_BACKEND_1 = "nccl"
# The two ranks against the stacked run: per-agent loss rtol 1e-4 (the
# trainer tolerance of PERF.md section 2); parameters within DIST_ULPS bf16
# ulps of the stacked run's (|a - b| <= DIST_ULPS * 2^-7 |b|, 2^-7 |b|
# being one bf16 ulp or more).  The only arithmetic that differs is the
# order of the sums across ranks (the clip norm's, and the consensus
# mean's of two agents, which is exact): a parameter that rounds the other
# way moves by one ulp and carries that into the next steps.  The two
# planted faults must fail the loss limit by step 2.
DIST_LOSS_TOL = dict(rtol=1e-4, atol=0.0)
DIST_ULPS = 2
# Each leaf's f32 norm per step and agent, of the parameters and of the
# exp-sum accumulators (the clipped gradients' memory).  A bf16 update that
# rounds away (most do at alpha 0.02 under a clip that binds) leaves no
# trace in the parameters or the loss, but always in the accumulators, so
# a clip scaled by the wrong norm shows there (by ~40% at two agents: one
# agent's gradients have ~1/sqrt(2) of both's norm); a consensus skipped
# shows in the parameter norms at once (one agent's draw against the mean
# of two: ~40%).  Healthy ranks differ from the stacked run in the clip
# norm's last bits, which can round a bf16 gradient element the other
# way: one bf16 ulp (2^-8 relative) of that element's share of the norm,
# in every step's term at worst.  The limit is four such ulps, 2^-6
# relative.
DIST_STATE_TOL = dict(rtol=2.0 ** -6, atol=0.0)
#: the collective forms on NCCL at world size 1 against mix_stacked:
#: the same f32 arithmetic, so equal up to the last rounding
DIST_MIX_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
                "bfloat16": dict(rtol=2.0 ** -8, atol=1e-6)}
#: grouped MoE dispatch: qwen3-moe-30b-a3b at full width, one MoE layer,
#: 2 x 4096 tokens in bf16, 4 groups.  bf16 outputs of products summed in
#: other orders (another capacity, per-expert products in the plain
#: version, its f32 combine): two bf16 ulps relative, plus 2^-6 of the
#: largest magnitude for elements that cancel.
DIST_MOE = dict(arch="qwen3-moe-30b-a3b", batch=2, seq=4096, groups=4)
DIST_MOE_TOL = dict(rtol=2.0 ** -6, atol_of_max=2.0 ** -6)


def dist_trainer(dev, group, **kw):
    """A Trainer of the distributed phase's settings (``kw`` overrides
    TrainConfig fields)."""
    from repro_torch.configs import registry as REG
    from repro_torch.training.train_step import TrainConfig
    from repro_torch.training.trainer import Trainer

    cfg = REG.get_config(LLM_ARCH).replace(n_layers=DIST["n_layers"])
    tc = TrainConfig(**{"memory_mode": "expsum", "K": DIST["K"],
                        "use_kernel": True, "grad_clip": DIST["grad_clip"],
                        **kw})
    return Trainer(cfg, tc, n_agents=DIST["agents"], device=dev,
                   group=group, log_every=10 ** 9)


def dist_run(tr, steps: int) -> tuple:
    """``tr`` over ``steps`` steps of the seed-0 token stream: the final
    state, every agent's loss per step, the pre-clip norm per step, the
    host ms per step (each step ends in a device sync) and, per step and
    per agent of this process, the f32 norm of each parameter leaf and of
    each leaf's memory (the clipped gradients': the exp-sum accumulators
    or the exact history)."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.data.synthetic import TokenPipeline

    losses, norms, ms, acc_norms = [], [], [], []
    inner = tr.step_fn

    def step(state, batch):
        t0 = time.perf_counter()
        state, met = inner(state, batch)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(met["agent_loss"].float().cpu().tolist())
        norms.append(float(met["grad_norm"]))
        accs = TR.leaves(memory_of(state))           # (K or T, A_local, ...)
        params = TR.leaves(state.params)                 # (A_local, ...)
        acc_norms.append(torch.stack([torch.stack(
            [torch.linalg.vector_norm(a[:, i].float()) for a in accs]
            + [torch.linalg.vector_norm(p[i].float()) for p in params])
            for i in range(params[0].shape[0])]).cpu().tolist())
        return state, met

    tr.step_fn = step
    data = TokenPipeline(vocab=tr.cfg.vocab, seq_len=DIST["seq"],
                         batch_per_agent=DIST["batch_per_agent"],
                         n_agents=DIST["agents"], seed=0)
    state = tr.run(tr.init(seed=0), iter(data), steps)
    return state, losses, norms, ms, acc_norms


def memory_of(state):
    """The FrODO memory tree of a train state: the exp-sum accumulators or
    the exact history."""
    opt = state.opt_state
    return opt["acc"] if "acc" in opt else opt["hist"]


def dist_held(losses, acc_norms, ref_losses, ref_acc_norms) -> tuple:
    """(within the limits, the largest loss and state-norm differences):
    every agent's loss per step, and this rank's agent's accumulator norms
    per step and leaf."""
    ok_l, err_l = close_np(losses, ref_losses, DIST_LOSS_TOL)
    ok_s, err_s = close_np(acc_norms, ref_acc_norms, DIST_STATE_TOL)
    return ok_l and ok_s, err_l, err_s


def ulp_excess(a, b) -> tuple:
    """(the largest |a - b| in bf16 ulps of |b| (2^-7 |b|), the share of
    elements that differ) of two tensors."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    ulps = d / (b.abs() * 2.0 ** -7).clamp(min=1e-30)
    return float(ulps.max()), float((d > 0).float().mean())


def _consensus_skipped_on_rank1(real):
    """A planted fault: rank 1 takes part in the all-reduce and keeps its
    own parameters."""
    import torch.distributed as dist

    def mix(x, group=None, n_agents=None):
        out = real(x, group, n_agents)
        return x if dist.get_rank() == 1 else out
    return mix


def _unreduced_norm(tree, group=None):
    """A planted fault: the clip norm of this rank's agents only."""
    import torch
    from repro_torch.obs import metrics as obs_metrics
    return torch.sqrt(obs_metrics.tree_sq_sum(tree))


def _dist_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of the ranks that share the card over gloo: the sharded run
    (counted, timed), held against the stacked run's record in ``tmp``,
    then the two planted faults; results to ``tmp/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as TR
    from repro_torch.core import consensus as C
    from repro_torch.device import set_full_precision
    from repro_torch.distributed import comm
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.training import train_step as TS

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    set_full_precision()
    t_start = time.perf_counter()
    group = dist.group.WORLD
    # warm up (the first step of a process loads its kernels and gloo its
    # buffers) while the main process runs the one-process references
    dist_run(dist_trainer(dev, group), 1)
    torch.cuda.empty_cache()
    warm_s = time.perf_counter() - t_start
    while not os.path.exists(os.path.join(tmp, "ref_ready")):
        time.sleep(0.05)
    wait_s = time.perf_counter() - t_start - warm_s
    ref = torch.load(os.path.join(tmp, f"ref{rank}.pt"))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    KU.reset_launches()
    comm.reset_counts()
    with comm.timed():
        state, losses, norms, ms, acc_norms = dist_run(
            dist_trainer(dev, group), DIST["steps"])
    launches = dict(ops.LAUNCHES)
    counts = {k: dict(v) for k, v in comm.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    held, loss_err, state_err = dist_held(
        losses, [a[0] for a in acc_norms], ref["losses"],
        [a[rank] for a in ref["acc_norms"]])
    worst_ulps, share = 0.0, 0.0
    flat = TR.leaves(state.params)
    for got, want in zip(flat, ref["params"]):
        u, sh = ulp_excess(got[0], want.to(dev))
        worst_ulps, share = max(worst_ulps, u), max(share, sh)
    n_el = sum(t.numel() for t in flat)
    del state, flat
    torch.cuda.empty_cache()
    planted = {}
    real_mix, real_norm = C.mix_uniform_constrained, TS._global_norm
    n = DIST["planted_steps"]
    for name in ("consensus_skipped_on_rank1", "clip_norm_unreduced"):
        try:
            if name == "consensus_skipped_on_rank1":
                C.mix_uniform_constrained = _consensus_skipped_on_rank1(
                    real_mix)
            else:
                TS._global_norm = _unreduced_norm
            _, p_losses, _, _, p_acc = dist_run(dist_trainer(dev, group), n)
        finally:
            C.mix_uniform_constrained, TS._global_norm = real_mix, real_norm
        ok, err_l, err_s = dist_held(
            p_losses, [a[0] for a in p_acc], ref["losses"][:n],
            [a[rank] for a in ref["acc_norms"][:n]])
        planted[name] = {"passes_the_check": ok, "max_abs_loss_diff": err_l,
                         "max_abs_state_norm_diff": err_s}
        torch.cuda.empty_cache()
    res = {"rank": rank, "losses": losses, "grad_norm": norms,
           "ms_per_step": ms, "median_ms_per_step": statistics.median(
               ms[1:]),
           "held": held, "max_abs_loss_diff": loss_err,
           "max_abs_state_norm_diff": state_err,
           "param_max_ulps": worst_ulps, "param_share_differing": share,
           "param_elements": n_el, "launches": launches,
           "collectives": counts, "peak_bytes": peak,
           "planted": planted, "warm_up_s": warm_s, "wait_s": wait_s,
           "seconds": time.perf_counter() - t_start}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def plain_grouped_moe(params, x, cfg):
    """The plain version of grouped MoE dispatch, independent of
    ``moe.py``'s sort-and-scatter: per group, each assignment's place in
    its expert from a running count of one-hot rows, the kept tokens of
    each expert through its products one expert at a time, the outputs
    added in f32, and a shared expert's (``params["shared"]``) products of
    every token added in f32 too.  Routing is ``moe.route``'s."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    m = cfg.moe
    B, S, d = x.shape
    N, E, k, G = B * S, m.n_experts, m.top_k, m.dispatch_groups
    n = N // G
    C = MOE._capacity(n, m)
    xt = x.reshape(N, d)
    _, _, top_w, top_e = MOE.route(params, xt, cfg)
    ex = params["experts"]
    act = L.activation(cfg.activation)
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    for g in range(G):
        e = top_e[g * n:(g + 1) * n].reshape(-1)
        w = top_w[g * n:(g + 1) * n].reshape(-1)
        onehot = torch.nn.functional.one_hot(e, E)
        pos = (torch.cumsum(onehot, 0) - 1).gather(1, e[:, None])[:, 0]
        tok = torch.arange(n, device=x.device).repeat_interleave(k) + g * n
        keep = pos < C
        for j in range(E):
            sel = (e == j) & keep
            xe = xt[tok[sel]]
            y = (act(xe @ ex["gate"][j]) * (xe @ ex["up"][j])) @ ex["down"][j]
            out.index_add_(0, tok[sel], y.float() * w[sel][:, None])
    if "shared" in params:
        sh = params["shared"]
        out += ((act(xt @ sh["gate"]["w"]) * (xt @ sh["up"]["w"]))
                @ sh["down"]["w"]).float()
    return out.to(x.dtype).reshape(B, S, d)


def moe_close(a, b) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs()
    lim = DIST_MOE_TOL["atol_of_max"] * b.abs().max() \
        + DIST_MOE_TOL["rtol"] * b.abs()
    return bool((err <= lim).all()), float(err.max())


def dist_moe_groups(dev) -> dict:
    """Grouped dispatch at qwen3-moe's full width: 4 groups at an ample
    capacity equal one group; at the config's capacity, the plain
    per-group version."""
    import torch
    from repro_torch.configs import registry as REG
    from repro_torch.models import moe as MOE

    cfg = REG.get_config(DIST_MOE["arch"])
    m = cfg.moe

    def with_moe(**kw):
        return cfg.replace(moe=m.__class__(**{**m.__dict__, **kw}))

    gen = torch.Generator(device=dev).manual_seed(0)
    p = MOE.moe_init(gen, cfg, (), dev)
    x = torch.randn((DIST_MOE["batch"], DIST_MOE["seq"], cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    G = DIST_MOE["groups"]
    ample = m.n_experts / m.top_k
    with torch.no_grad():
        one, _ = MOE.moe_mlp(p, x, with_moe(capacity_factor=ample))
        grouped, _ = MOE.moe_mlp(p, x, with_moe(capacity_factor=ample,
                                                 dispatch_groups=G))
        ok_ample, err_ample = moe_close(grouped, one)
        cfg_g = with_moe(dispatch_groups=G)
        got, aux = MOE.moe_mlp(p, x, cfg_g)
        want = plain_grouped_moe(p, x, cfg_g)
        ok_cap, err_cap = moe_close(got, want)
        at_one, _ = MOE.moe_mlp(p, x, cfg)
    check(ok_ample, f"grouped MoE at ample capacity vs one group: {err_ample}")
    check(ok_cap, f"grouped MoE vs the plain per-group version: {err_cap}")
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(aux)),
          "grouped MoE output not finite")
    return {"arch": DIST_MOE["arch"], "tokens": [DIST_MOE["batch"],
                                                  DIST_MOE["seq"]],
            "groups": G, "capacity_per_group": MOE._capacity(
                DIST_MOE["batch"] * DIST_MOE["seq"] // G, m),
            "capacity_one_group": MOE._capacity(
                DIST_MOE["batch"] * DIST_MOE["seq"], m),
            "ample_vs_one_group_max_abs_err": err_ample,
            "vs_plain_per_group_max_abs_err": err_cap,
            "max_abs_diff_vs_one_group_at_config_capacity": float(
                (got.float() - at_one.float()).abs().max()),
            "tol": DIST_MOE_TOL}


def dist_forms_world1(dev) -> dict:
    """The collective forms on the world-1 group on card tensors against
    ``mix_stacked``; whether ring_mix's send to self ran."""
    import numpy as np
    import torch
    from repro_torch.core import consensus as C

    gen = torch.Generator(device=dev).manual_seed(1)
    W = np.array([[0.7, 0.3], [0.4, 0.6]])
    out = {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        two = {"w": torch.randn((2, 1024, 1024), generator=gen,
                                device=dev).to(dt),
               "b": torch.randn((2, 4096), generator=gen, device=dev).to(dt)}
        one = {k: v[:1].clone() for k, v in two.items()}
        pairs = {
            "pmean_mix": (C.pmean_mix(one), C.mix_stacked(one, np.ones((1,
                                                                        1)))),
            "mix_uniform_constrained": (C.mix_uniform_constrained(two),
                                        C.mix_stacked(two, np.full((2, 2),
                                                                   0.5))),
            "general_mix": (C.general_mix(two, W), C.mix_stacked(two, W))}
        try:
            pairs["ring_mix"] = (C.ring_mix(one), C.mix_stacked(
                one, np.ones((1, 1))))
            out["ring_mix_send_to_self"] = "ran"
        except RuntimeError as e:
            out["ring_mix_send_to_self"] = f"refused: {str(e)[:200]}"
        errs = {}
        for form, (got, want) in pairs.items():
            worst = 0.0
            for k in got:
                ok, err = close_np(got[k].float().cpu().numpy(),
                                   want[k].float().cpu().numpy(),
                                   DIST_MIX_TOL[dname])
                check(ok, f"{form} ({dname}) on the world-1 group vs "
                          f"mix_stacked: {err}")
                worst = max(worst, err)
            errs[form] = worst
        out[dname] = errs
    return out


def distributed_phase(dev) -> dict:
    """The distributed layer on the card: the collective forms and the
    agent-sharded step on NCCL at world size 1 (bit-equal to the stacked
    step), two ranks sharing the card over gloo against the stacked run
    (planted faults must fail), and grouped MoE dispatch."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import tree as TR
    from repro_torch.distributed import comm
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    respawns = comm.RESPAWNS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    launches = {}
    torch.cuda.empty_cache()
    # the two ranks start (and warm up) while this process runs the
    # one-process references; they wait for ref_ready
    ctx = comm.spawn(_dist_rank, DIST["ranks"], tmp, str(dev),
                     backend="gloo", store_dir=tmp, join=False)
    try:
        # ---- one process: the stacked run, then NCCL at world size 1
        KU.reset_launches()
        ref_state, ref_losses, ref_norms, ref_ms, ref_acc = dist_run(
            dist_trainer(dev, None), DIST["steps"])
        launches["distributed_stacked"] = dict(ops.LAUNCHES)
        clip = DIST["grad_clip"] * DIST["agents"] ** 0.5
        check(all(v > clip for v in ref_norms),
              f"the clip does not bind at every step: {ref_norms} vs {clip}")
        check(bool(np.isfinite(ref_losses).all()),
              f"stacked losses not finite: {ref_losses}")
        dist.init_process_group(
            DIST_BACKEND_1, store=dist.FileStore(os.path.join(tmp, "w1"), 1),
            rank=0, world_size=1)
        try:
            backend = dist.get_backend()
            forms = dist_forms_world1(dev)
            KU.reset_launches()
            w1_state, w1_losses, _, w1_ms, w1_acc = dist_run(
                dist_trainer(dev, dist.group.WORLD), DIST["steps"])
            launches["distributed_world1"] = dict(ops.LAUNCHES)
        finally:
            dist.destroy_process_group()
        check(w1_losses == ref_losses and w1_acc == ref_acc,
              f"world-1 {backend} losses or state differ from the stacked "
              f"run's: {w1_losses} vs {ref_losses}")
        check(all(torch.equal(a, b) for a, b in zip(
            TR.leaves(w1_state.params), TR.leaves(ref_state.params))),
            f"world-1 {backend} parameters differ from the stacked run's")
        del w1_state
        flat = TR.leaves(ref_state.params)
        for r in range(DIST["ranks"]):
            torch.save({"losses": ref_losses, "acc_norms": ref_acc,
                        "grad_norm": ref_norms,
                        "params": [t[r].cpu() for t in flat]},
                       os.path.join(tmp, f"ref{r}.pt"))
        n_leaves = len(flat)
        del ref_state, flat
        torch.cuda.empty_cache()
        # grouped MoE dispatch, while the ranks may still warm up (it runs
        # before they are let go, so it perturbs none of their timings)
        moe = dist_moe_groups(dev)
        torch.cuda.empty_cache()
        # ---- two ranks sharing the card over gloo
        t0 = time.perf_counter()
        open(os.path.join(tmp, "ref_ready"), "w").close()
        while not ctx.join():
            pass
        ranks_s = time.perf_counter() - t0
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    ranks = []
    for r in range(DIST["ranks"]):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r in ranks:
        check(r["held"], f"rank {r['rank']}: losses or state vs the stacked "
                         f"run: {r['max_abs_loss_diff']}, "
                         f"{r['max_abs_state_norm_diff']}")
        check(r["param_max_ulps"] <= DIST_ULPS,
              f"rank {r['rank']}: parameters {r['param_max_ulps']} bf16 "
              f"ulps from the stacked run's")
        check(r["launches"] == {"frodo_exact_update": 0,
                                "frodo_expsum_update": n_leaves
                                * DIST["steps"]},
              f"rank {r['rank']}: launches {r['launches']}")
    for name in ranks[0]["planted"]:        # a fault shows on some rank
        check(not all(r["planted"][name]["passes_the_check"] for r in ranks),
              f"planted {name} passed the check on every rank")
    launches["distributed_2ranks"] = {
        k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    steps = DIST["steps"]
    emit("distributed", nvidia_smi=nvidia_smi(), arch=LLM_ARCH,
         respawns=comm.RESPAWNS - respawns,
         n_layers=DIST["n_layers"], seq=DIST["seq"], agents=DIST["agents"],
         batch_per_agent=DIST["batch_per_agent"], K=DIST["K"],
         acc_dtype="float32", grad_clip=DIST["grad_clip"], steps=steps,
         reduced=DIST_REDUCED,
         world1={"backend": backend, "bit_equal_to_stacked": True,
                 "forms_vs_mix_stacked_max_abs_err": forms,
                 "median_ms_per_step": statistics.median(w1_ms[1:]),
                 "ms_per_step": w1_ms},
         stacked={"median_ms_per_step": statistics.median(ref_ms[1:]),
                  "ms_per_step": ref_ms,
                  "losses": ref_losses, "grad_norm": ref_norms},
         ranks={"backend": "gloo", "world": DIST["ranks"],
                "seconds_after_the_references": ranks_s,
                "per_rank": [{
                    "rank": r["rank"],
                    "median_ms_per_step": r["median_ms_per_step"],
                    "ms_per_step": r["ms_per_step"],
                    "all_reduce_ms_per_step":
                        r["collectives"]["all_reduce"]["ms"] / steps,
                    "all_reduce_bytes_per_step":
                        r["collectives"]["all_reduce"]["bytes"] / steps,
                    "collectives": r["collectives"],
                    "peak_bytes": r["peak_bytes"],
                    "expsum_launches": r["launches"]["frodo_expsum_update"],
                    "max_abs_loss_diff": r["max_abs_loss_diff"],
                    "max_abs_state_norm_diff": r["max_abs_state_norm_diff"],
                    "param_max_ulps": r["param_max_ulps"],
                    "param_share_differing": r["param_share_differing"],
                    "planted": r["planted"], "warm_up_s": r["warm_up_s"],
                    "wait_s": r["wait_s"], "seconds": r["seconds"]}
                    for r in ranks]},
         tol={"loss": DIST_LOSS_TOL, "param_bf16_ulps": DIST_ULPS,
              "state_norms": DIST_STATE_TOL, "forms": DIST_MIX_TOL},
         moe_groups=moe, seconds=time.perf_counter() - t_phase)
    return {"launches": launches, "ref_dir": tmp}


# -------------------------------------------------------- tensor parallel
#: tensor-parallel training over the "model" axis: the distributed phase's
#: model, shape, optimizer and clip on a (data 2, model 2) mesh, four gloo
#: ranks that share the one card; each rank holds its agent's shards
#: (``train_state_specs`` under ``build_rules``), the agents go over
#: "data", the model is split over "model".  Held against the
#: distributed phase's stacked run (not repeated); then the same ranks
#: take ``exact_steps`` steps with exact memory (``exact_T`` slots, through
#: the exact kernel on every local shard) against a stacked exact run
#: that this process makes meanwhile.
TP = dict(mesh=(2, 2), steps=DIST["steps"], planted_steps=1, exact_T=8,
          exact_steps=2)
TP_REDUCED = {
    "n_layers": DIST_REDUCED["n_layers"],
    "global_batch": DIST_REDUCED["global_batch"],
    "mesh": "(data 2, model 2): four ranks share one H100 over gloo (NCCL "
            "refuses two ranks on one card); the production mesh's model "
            "axis is 16",
    "steps": "4: the distributed phase's stacked run, reused; exact "
             "memory 2 steps at T = 8"}
#: serving: the prefill and serve units under serve_rules on (data 1,
#: model 2), two ranks; h2o-danube at full width, depth 24 -> 4, batch 8;
#: a prefill of 2 x 512 tokens, then 32 decode steps from an empty cache
#: of the model's window (4,096 slots, 2,048 a rank), greedy in f32, a
#: fixed token stream in bf16
TP_SERVE = dict(mesh=(1, 2), n_layers=4, prefill=(2, 512), batch=8,
                steps=32, max_len=4096, planted_steps=4)
TP_SERVE_REDUCED = {"n_layers": "24 -> 4 (the script's time)",
                    "mesh": "(data 1, model 2): two ranks share one H100 "
                            "over gloo"}
# Checks.  Per-agent losses rtol 1e-4 and parameters within DIST_ULPS bf16
# ulps of the stacked run's (an ulp of an element's own magnitude, or of
# its leaf's RMS where that is larger: the consensus mean of two agents'
# values cancels to exactly 0 at thousands of elements a leaf, where an
# input one ulp off leaves a value of ~1e-10 against 0, which no relative
# limit holds; those elements are listed), accumulator and parameter norms within
# DIST_STATE_TOL (each leaf's whole norm: the local shards' squares summed
# over the model axis, a replicated leaf once): the only arithmetic that
# differs is the row-parallel sums (f32 over bf16 partials, rounded once)
# and the order of the sums across ranks.  The clip norm the step used
# against the norm of the whole gradient taken from the spec tree (a
# leaf whose spec names "model" adds every rank's shard, any other leaf
# one copy), f32 sums in another order: rtol 1e-5.  The replicated leaves
# (the norm scales) hold only ~3e-4 of the squared gradient norm at this
# width (measured on the CPU at seq 512), so counting them on both model
# ranks moves the clip by ~1.5e-4: the accumulators (2^-6) cannot see it,
# this check does.
TP_NORM_TOL = dict(rtol=1e-5, atol=0.0)
#: each rank's state (its parameter and accumulator shards) against one
#: agent's whole state
TP_STATE_SHARE = 0.55
#: serving in f32: logits rtol 1e-4 against the one-process units, tokens
#: equal; in bf16 the decode-vs-forward limit of h2o-danube
TP_SERVE_TOL = dict(rtol=1e-4, atol=1e-5)


def tp_config(n_layers, dtype=None):
    from repro_torch.configs import registry as REG
    cfg = REG.get_config(LLM_ARCH).replace(n_layers=n_layers)
    return cfg if dtype is None else cfg.replace(param_dtype=dtype,
                                                 compute_dtype=dtype)


def _spec_split(spec) -> bool:
    from repro_torch.distributed import sharding as SH
    return any("model" in SH.axes_of(p) for p in spec)


def _row_parallel_skipped_in_layer0(real):
    """A planted fault: layer 0's MLP keeps its partial sums (no
    all-reduce of the down projection)."""
    from repro_torch.distributed import comm

    def mlp(params, x, act_name, d_ff=None):
        if params["down"]["w"].storage_offset() != 0:
            return real(params, x, act_name, d_ff)
        saved = comm.reduce_from_model
        comm.reduce_from_model = lambda t, group: t
        try:
            return real(params, x, act_name, d_ff)
        finally:
            comm.reduce_from_model = saved
    return mlp


def _tp_train_rank(rank: int, world: int, tmp: str, ref_dir: str,
                   device: str) -> None:
    """One of the four ranks of the tensor-parallel train run: warm-up,
    TP["steps"] counted and timed steps, the checks against the stacked
    run, the two planted faults; results to ``tmp/train<r>.json``."""
    import numpy as np
    import torch
    from repro_torch import convert as CV
    from repro_torch import tree as TR
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.device import set_full_precision
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as ML
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TM
    from repro_torch.training import train_step as TS

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    set_full_precision()
    t_start = time.perf_counter()
    mesh = ML.make_host_mesh(TP["mesh"][1])
    coords = SH.mesh_coords(mesh)
    d_rank, m_rank = coords["data"], coords["model"]
    model = (mesh, "model")
    cfg = tp_config(DIST["n_layers"])
    tc = TS.TrainConfig(memory_mode="expsum", K=DIST["K"], use_kernel=True,
                        grad_clip=DIST["grad_clip"])
    tc_exact = TS.TrainConfig(memory_mode="exact", T=TP["exact_T"],
                              use_kernel=True, grad_clip=DIST["grad_clip"])
    rules = TS.build_rules(cfg, False)
    A = DIST["agents"]

    def fresh(tc):
        """The stacked run's initial draw (``Trainer.init(seed=0)``), this
        rank's shards of it, and a fresh optimizer state."""
        gen = torch.Generator(device=dev).manual_seed(0)
        full = TM.init_params(gen, cfg, (A,), dev)
        specs = TS.param_specs(full, rules, mesh)
        shapes = TR.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), full)
        params = CV.shard_tree(full, specs, mesh, dev)
        del full
        return TS.train_state_from_params(params, tc), specs, shapes

    def batches():
        data = iter(TokenPipeline(vocab=cfg.vocab, seq_len=DIST["seq"],
                                  batch_per_agent=DIST["batch_per_agent"],
                                  n_agents=A, seed=0))
        b0 = next(data)
        bspecs = TS.batch_specs(b0, rules, mesh)
        yield CV.shard_tree(b0, bspecs, mesh, dev)
        for b in data:
            yield CV.shard_tree(b, bspecs, mesh, dev)

    def whole_norms(state, specs):
        """Per leaf: the f32 norm of this rank's agent's memory, then of its
        parameters, over every model rank's shards."""
        split = [_spec_split(s) for s in TR.leaves(specs)]
        accs = TR.leaves(memory_of(state))
        sq = [torch.sum(torch.square(a[:, 0].float())) for a in accs]
        sq += [torch.sum(torch.square(p[0].float()))
               for p in TR.leaves(state.params)]
        sq = torch.stack([s if (sp or m_rank == 0) else s * 0
                          for s, sp in zip(sq, split + split)])
        return torch.sqrt(comm.all_reduce_sum(sq, model)).cpu().tolist()

    def run(steps, timed=False, tc=tc):
        """``steps`` steps from a fresh state: (state, specs, shapes,
        losses, norms, ms, [(step's clip norm, the spec tree's norm)])."""
        state, specs, shapes = fresh(tc)
        split = [_spec_split(s) for s in TR.leaves(specs)]
        clips = []
        real_clip = TS.clip_by_global_norm

        def spy(tree, max_norm, norm=None):
            sq = sum(torch.sum(torch.square(g.float()))
                     for g, sp in zip(TR.leaves(tree), split)
                     if sp or m_rank == 0)
            torch.distributed.all_reduce(sq)     # not the step's: uncounted
            clips.append((float(norm), float(torch.sqrt(sq))))
            return real_clip(tree, max_norm, norm)

        TS.clip_by_global_norm = spy
        try:
            with SH.use_rules(rules, mesh):
                step = TS.make_train_step(cfg, tc, A)
            losses, norms, ms = [], [], []
            data = batches()
            ctx = comm.timed() if timed else contextlib.nullcontext()
            with ctx:
                for _ in range(steps):
                    b = next(data)
                    t0 = time.perf_counter()
                    with SH.use_rules(rules, mesh):
                        state, met = step(state, b)
                    if on_card:
                        torch.cuda.synchronize(dev)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(met["agent_loss"].float().cpu().tolist())
                    norms.append(whole_norms(state, specs))
        finally:
            TS.clip_by_global_norm = real_clip
        return state, specs, shapes, losses, norms, ms, clips

    def gathered_vs(state, specs, shapes, ref):
        """This agent's gathered parameters against the stacked run's:
        (the most bf16 ulps, the share of elements that differ, whether
        the replicated leaves are bit-equal across model ranks, the leaves
        with elements past DIST_ULPS of their own magnitude)."""
        worst_ulps, share, replicated_equal = 0.0, 0.0, True
        over = {}
        for path, got, spec, shape, want in zip(
                SH.flatten_with_paths(shapes), TR.leaves(state.params),
                TR.leaves(specs), TR.leaves(shapes), ref["params"]):
            parts = comm.all_gather(got.contiguous(), model)  # (m, 1, ...)
            if _spec_split(spec):
                whole = torch.empty((1,) + tuple(shape.shape[1:]),
                                    dtype=got.dtype, device=dev)
                sizes = {"data": 1, "model": parts.shape[0]}
                for m in range(parts.shape[0]):
                    sl = SH.local_slice(whole.shape, spec, sizes,
                                        {"data": 0, "model": m})
                    whole[sl] = parts[m]
            else:
                replicated_equal &= bool(torch.equal(parts[0], parts[-1]))
                whole = parts[0]
            a, b = whole[0].float(), want.to(dev).float()
            d = (a - b).abs()
            rms = torch.sqrt(torch.mean(b * b))
            worst_ulps = max(worst_ulps, float((d / (torch.maximum(
                b.abs(), rms) * 2.0 ** -7)).max()))
            share = max(share, float((d > 0).float().mean()))
            own = d / (b.abs() * 2.0 ** -7).clamp(min=1e-30)
            n_over = int((own > DIST_ULPS).sum())
            if n_over:
                i = int(own.argmax())
                over[path] = {"elements_over": n_over,
                              "got": float(a.flatten()[i]),
                              "want": float(b.flatten()[i]),
                              "max_abs_diff": float(d.max()),
                              "leaf_rms": float(rms)}
        return worst_ulps, share, replicated_equal, over

    def held(losses, norms, clips, ref, n):
        ok_l, err_l = close_np(losses, ref["losses"][:n], DIST_LOSS_TOL)
        ok_s, err_s = close_np(norms, [a[d_rank] for a in
                                       ref["acc_norms"][:n]],
                               DIST_STATE_TOL)
        ok_c, err_c = close_np([c[0] for c in clips], [c[1] for c in clips],
                               TP_NORM_TOL)
        return ok_l and ok_s and ok_c, {"max_abs_loss_diff": err_l,
                                        "max_abs_state_norm_diff": err_s,
                                        "max_abs_clip_norm_diff": err_c}

    warm_s = time.perf_counter() - t_start
    ref = torch.load(os.path.join(ref_dir, f"ref{d_rank}.pt"))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    torch.distributed.barrier()
    KU.reset_launches()
    comm.reset_counts()
    n = TP["steps"]
    state, specs, shapes, losses, norms, ms, clips = run(n, timed=True)
    launches = dict(ops.LAUNCHES)
    groups = {g: {op: dict(c) for op, c in ops_.items()}
              for g, ops_ in comm.GROUP_COUNTS.items()}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ok, errs = held(losses, norms, clips, ref, n)
    worst_ulps, share, replicated_equal, over = gathered_vs(
        state, specs, shapes, ref)
    p_leaves = TR.leaves(state.params)
    one_agent = sum(int(np.prod(s.shape[1:])) * s.element_size() * (
        1 + tc.K * 4 // s.element_size()) for s in TR.leaves(shapes))
    mine = sum(t.numel() * t.element_size() for t in p_leaves) + sum(
        t.numel() * t.element_size() for t in TR.leaves(memory_of(state)))
    n_leaves = len(p_leaves)
    del state
    if on_card:
        torch.cuda.empty_cache()
    planted = {}
    real_mlp, real_counted = L.mlp, TS.model_counted
    k = TP["planted_steps"]
    for name in ("row_parallel_reduce_skipped_in_layer0",
                 "clip_norm_counts_replicated_leaves_on_every_model_rank"):
        try:
            if name.startswith("row"):
                L.mlp = _row_parallel_skipped_in_layer0(real_mlp)
            else:
                TS.model_counted = lambda *a, **kw: [True] * len(
                    real_counted(*a, **kw))
            _, _, _, p_losses, p_norms, _, p_clips = run(k)
        finally:
            L.mlp, TS.model_counted = real_mlp, real_counted
        p_ok, p_errs = held(p_losses, p_norms, p_clips, ref, k)
        planted[name] = {"passes_the_check": p_ok, **p_errs}
        if on_card:
            torch.cuda.empty_cache()
    # exact memory on the local shards, against the stacked exact run
    while not os.path.exists(os.path.join(tmp, "ref_exact_ready")):
        time.sleep(0.05)
    ref_x = torch.load(os.path.join(tmp, f"ref_exact{d_rank}.pt"))
    kx = TP["exact_steps"]
    KU.reset_launches()
    state, specs, shapes, x_losses, x_norms, x_ms, x_clips = run(
        kx, tc=tc_exact)
    x_launches = dict(ops.LAUNCHES)
    x_ok, x_errs = held(x_losses, x_norms, x_clips, ref_x, kx)
    x_ulps, x_share, x_same, x_over = gathered_vs(state, specs, shapes,
                                                  ref_x)
    del state
    exact = {"held": x_ok, **x_errs, "losses": x_losses, "ms_per_step": x_ms,
             "param_max_ulps": x_ulps, "param_share_differing": x_share,
             "param_elements_over_ulps_of_own_magnitude": x_over,
             "replicated_bit_equal": x_same, "launches": x_launches}
    res = {"rank": rank, "coords": coords, "losses": losses,
           "clip_norms": clips, "ms_per_step": ms,
           # the first step warms the kernels and gloo's buffers up
           "median_ms_per_step": statistics.median(ms[1:] or ms),
           "held": ok, **errs, "param_max_ulps": worst_ulps,
           "param_elements_over_ulps_of_own_magnitude": over,
           "param_share_differing": share,
           "replicated_bit_equal": replicated_equal,
           "state_bytes": mine, "one_agent_state_bytes": one_agent,
           "launches": launches, "n_leaves": n_leaves, "groups": groups,
           "peak_bytes": peak, "planted": planted, "exact": exact,
           "start_s": warm_s,
           "seconds": time.perf_counter() - t_start}
    with open(os.path.join(tmp, f"train{rank}.json"), "w") as f:
        json.dump(res, f)


def tp_serve_run(dev, dtype: str, mesh=None, planted: bool = False,
                 steps: int = TP_SERVE["steps"]) -> dict:
    """The serving units of TP_SERVE in ``dtype``: in one process (``mesh``
    None) or on this rank's shards under ``serve_rules`` on ``mesh``.  The
    prefill's last logits, then ``steps`` decode steps (``decode_step``'s
    logits beside ``make_serve_step``'s tokens; greedy in f32, a fixed
    token stream in bf16), every output gathered whole."""
    import numpy as np
    import torch
    from repro_torch import convert as CV
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import attention as AT
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as TM
    from repro_torch.serving import engine as E
    from repro_torch.training import train_step as TS

    cfg = tp_config(TP_SERVE["n_layers"], dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    full = TM.init_params(gen, cfg, (), dev)
    rng = np.random.default_rng(0)
    Bp, S = TP_SERVE["prefill"]
    B = TP_SERVE["batch"]
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (Bp, S)),
                             device=dev)
    stream = torch.as_tensor(rng.integers(0, cfg.vocab, (steps, B, 1)),
                             device=dev)
    V = cfg.vocab

    def rules(batch):
        return None if mesh is None else TS.serve_rules(cfg, False, batch,
                                                        mesh)

    def whole(t, shape):
        if mesh is None:
            return t
        return SH.gather(t.contiguous(), SH.P(None, "model"), mesh, shape)

    params = full if mesh is None else CV.shard_tree(
        full, TS.param_specs(full, rules(B), mesh, False), mesh, dev)
    del full
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = {}
    real = AT._partial_scale
    if planted:
        AT._partial_scale = lambda m, m_all: torch.ones_like(m)
    try:
        with torch.no_grad():
            with SH.use_rules(rules(Bp), mesh):
                sync()
                t0 = time.perf_counter()
                lg = E.make_prefill(cfg)(params, {"tokens": prompt})
                sync()
                out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            out["prefill"] = whole(lg, (Bp, V)).float().cpu()
            cache = D.init_cache(cfg, B, TP_SERVE["max_len"], device=dev)
            if mesh is not None:
                r = rules(B)
                cache = CV.shard_tree(cache, TS.cache_specs(cache, r, mesh),
                                      mesh, dev)
            step = E.make_serve_step(cfg)
            tok, logits, toks, ms = stream[0], [], [], []
            ar = {"calls": 0, "bytes": 0}            # the serve steps'
            with SH.use_rules(rules(B), mesh):
                for t in range(steps):
                    lg, _ = D.decode_step(params, cache, tok, t, cfg)
                    sync()
                    before = dict(comm.COUNTS["all_reduce"])
                    t0 = time.perf_counter()
                    nxt, cache = step(params, cache, tok, t)
                    sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    for k in ar:
                        ar[k] += comm.COUNTS["all_reduce"][k] - before[k]
                    logits.append(whole(lg[:, -1], (B, V)).float().cpu())
                    toks.append(nxt[:, 0].cpu())
                    tok = nxt if dtype == "float32" else stream[
                        min(t + 1, steps - 1)]
            out["decode_all_reduce_per_step"] = {k: v / steps
                                                 for k, v in ar.items()}
    finally:
        AT._partial_scale = real
    out["logits"] = torch.stack(logits)
    out["tokens"] = torch.stack(toks)
    out["decode_ms"] = ms
    return out


def _tp_serve_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of the two serving ranks: both dtypes, then the planted fault
    (rank 0 saves the gathered outputs to ``tmp/serve.pt``); then the
    families of TP_FAMILIES (``tp_families_ranks``)."""
    import torch
    from repro_torch.device import set_full_precision
    from repro_torch.launch import mesh as ML

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    set_full_precision()
    mesh = ML.make_host_mesh(TP_SERVE["mesh"][1])
    res = {dt: tp_serve_run(dev, dt, mesh) for dt in ("float32",
                                                       "bfloat16")}
    res["planted"] = tp_serve_run(dev, "float32", mesh, planted=True,
                                  steps=TP_SERVE["planted_steps"])
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    if rank == 0:
        torch.save(res, os.path.join(tmp, "serve.pt"))
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tp_families_ranks(dev, tmp, mesh, rank)
    with open(os.path.join(tmp, f"families_s{rank}.json"), "w") as f:
        json.dump(time.perf_counter() - t0, f)


def row_parallel_gemm(dev) -> dict:
    """One model rank's row-parallel GEMM at the train run's MLP down
    projection (2 x 4096 tokens, half of d_ff against d_model), bf16
    operands: the f32 result the layer takes (the GEMM's own accumulator)
    against the product of f32 copies, by CUDA events on a quiet card."""
    import torch
    from repro_torch.models import layers as L

    cfg = tp_config(DIST["n_layers"])
    n = DIST["batch_per_agent"] * DIST["seq"]
    k = cfg.d_ff // TP["mesh"][1]
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, cfg.d_model), generator=gen, device=dev)
         * k ** -0.5).to(torch.bfloat16)
    got = L._MatmulF32Out.apply(h, w)
    want = h.float() @ w.float()
    err = float((got - want).abs().max())
    check(err <= 1e-4 * float(want.abs().max()),
          f"row-parallel GEMM: f32-out bf16 product {err} from the f32 one")
    flops = 2 * n * k * cfg.d_model
    out = {"m_k_n": [n, k, cfg.d_model], "max_abs_err_vs_f32": err,
           "bf16_f32_out_ms": cuda_ms(lambda: L._MatmulF32Out.apply(h, w)),
           "f32_copies_ms": cuda_ms(lambda: h.float() @ w.float()),
           "flops": flops}
    del h, w, got, want
    torch.cuda.empty_cache()
    return out


# -------------------------------------- tensor parallel: six more families
#: the vision, MLA, audio, SSM, MoE and hybrid families tensor-parallel on
#: the serving ranks' (data 1, model 2) mesh, one family after another at
#: full width, each held against the one-process units of the same config
#: that this process runs meanwhile: 2 exp-sum train steps in bf16 with the
#: family's llm_train accumulators (K = 8, recurrentgemma's K = 4;
#: minicpm3 and mamba2 also 2 exact-memory steps at T = 8), then the
#: serving units in f32: a prefill of 2 x 256 tokens
#: (phi-3-vision's patch embeddings at the first 64 positions, whisper's
#: 1,500 frames) and 16 greedy decode steps from an empty cache of 256
#: slots (128 a rank; whisper's cross K/V from ``encode_for_decode``)
#: ``spread``: the family's one-process units are computed a second time
#: through cuBLASLt (``cublaslt``), another summation order of the same
#: arithmetic, and a limit the reference's own spread exceeds becomes
#: ``TP_SPREAD_FACTOR`` times that spread: mamba2's and the RG-LRU's
#: zero-initialized conv biases, whose update is a cancelling sum over the
#: tokens (3.9 and 1.8 bf16 ulps of the leaf's RMS between cuBLAS and
#: cuBLASLt in one process), and recurrentgemma's f32 logits (3.7e-5)
#: (PERF.md §6, PR 22)
TP_FAMILIES = {VLM_ARCH: dict(n_layers=2, acc_dtype="float32"),
               MLA_ARCH: dict(n_layers=2, acc_dtype="float32", exact_T=8),
               AUDIO_ARCH: dict(n_layers=4, acc_dtype="float32"),
               MAMBA2_ARCH: dict(n_layers=4, acc_dtype="float32", exact_T=8,
                                 spread=True),
               MOE_ARCH: dict(n_layers=1, acc_dtype="bfloat16"),
               HYBRID_ARCH: dict(n_layers=3, acc_dtype="bfloat16", K=4,
                                 spread=True)}
TP_SPREAD_FACTOR = 2.0
TP_FAM = dict(seq=2048, batch_per_agent=1, K=8, steps=2, exact_steps=2,
              prefill=(2, 256), img_tokens=64, decode_steps=16, max_len=256)
TP_FAM_REDUCED = {
    "n_layers": "phi-3-vision 32 -> 2, minicpm3 62 -> 2, qwen3-moe 48 -> 1 "
                "(its llm_train cell), whisper-tiny at full depth, "
                "mamba2-780m 48 -> 4, recurrentgemma-9b 38 -> 3 (one "
                "group, its llm_train cell)",
    "K": "recurrentgemma-9b 8 -> 4 with bf16 accumulators (its llm_train "
         "cell)",
    "global_batch": "256 x 4096 -> one agent's 1 x 2048 (the (data 1, "
                    "model 2) mesh has one agent; the row-parallel sums go "
                    "through host memory over gloo)",
    "mesh": "(data 1, model 2): two ranks share one H100 over gloo"}
#: a planted fault per family, in its tensor-parallel prefill
TP_FAM_PLANTED = {MOE_ARCH: "moe_combine_without_reduce",
                  AUDIO_ARCH: "cross_attention_without_reduce",
                  MLA_ARCH: "k_rope_from_rank0_columns",
                  MAMBA2_ARCH: "gated_norm_over_local_width",
                  HYBRID_ARCH: "hybrid_mlp_without_d_ff"}


def _without_reduce(real):
    """A planted fault: ``real`` with every ``reduce_from_model`` in it
    skipped (each rank keeps its partial sums)."""
    from repro_torch.distributed import comm

    def fn(*args, **kwargs):
        saved = comm.reduce_from_model
        comm.reduce_from_model = lambda t, group: t
        try:
            return real(*args, **kwargs)
        finally:
            comm.reduce_from_model = saved
    return fn


def _k_rope_from_rank0(ckv, tp, r):
    """A planted fault: MLA's rope part read from rank 0's column range of
    ``kv_down`` (its last rope columns) rather than the whole output's."""
    from repro_torch.distributed import comm

    full = comm.gather_from_model(ckv, -1, tp.group)
    w, rope = ckv.shape[-1], full.shape[-1] - r
    return full[..., :r], full[..., w - rope:w]


def _local_width_norm(params, x, eps=1e-6):
    """A planted fault: an RMS norm over this rank's part of the width
    alone (mamba2's gated norm), with its slice of the scale."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L

    tp, n = SH.model_axis(), x.shape[-1]
    scale = params["scale"][tp.rank * n:(tp.rank + 1) * n]
    return L.rmsnorm({"scale": scale}, x, eps)


def _without_d_ff(real):
    """A planted fault: the MLP called without its full hidden width, so
    a split hidden layer's partial sums are never reduced."""
    def mlp(params, x, act_name, d_ff=None):
        return real(params, x, act_name)
    return mlp


def tp_fam_planted(name):
    """(module, attribute, faulty replacement) of a planted fault."""
    from repro_torch.models import attention as AT
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TM

    if name == "moe_combine_without_reduce":
        return MOE, "moe_mlp", _without_reduce(MOE.moe_mlp)
    if name == "cross_attention_without_reduce":
        return TM, "cross_attend", _without_reduce(TM.cross_attend)
    if name == "gated_norm_over_local_width":
        return L, "rmsnorm_split", _local_width_norm
    if name == "hybrid_mlp_without_d_ff":
        return L, "mlp", _without_d_ff(L.mlp)
    return AT, "_kv_latent", _k_rope_from_rank0


def tp_family_train(dev, arch, tc, mesh=None) -> dict:
    """``TP_FAM["steps"]`` (or ``exact_steps``) train steps of ``arch`` at
    TP_FAMILIES' depth from the seed-0 draw: in one process (``mesh``
    None) or on this rank's shards.  Losses, the clip norm the step used
    beside the spec tree's norm of its gradient, host ms, launches, the
    whole parameters (gathered) and whether the replicated leaves are
    bit-equal across the model ranks."""
    import torch
    from repro_torch import convert as CV
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import TokenPipeline, augment_modalities
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TM
    from repro_torch.training import train_step as TS

    cfg = REG.get_config(arch).replace(n_layers=TP_FAMILIES[arch]["n_layers"])
    gen = torch.Generator(device=dev).manual_seed(0)
    full = TM.init_params(gen, cfg, (1,), dev)
    data = augment_modalities(iter(TokenPipeline(
        vocab=cfg.vocab, seq_len=TP_FAM["seq"],
        batch_per_agent=TP_FAM["batch_per_agent"], n_agents=1, seed=0)),
        cfg)
    steps = TP_FAM["exact_steps" if tc.memory_mode == "exact" else "steps"]
    batches = [next(data) for _ in range(steps)]
    rules = specs = None
    if mesh is not None:
        rules = TS.build_rules(cfg, False)
        specs = TS.param_specs(full, rules, mesh)
        shapes = TR.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), full)
        params = CV.shard_tree(full, specs, mesh, dev)
        del full
        bspecs = TS.batch_specs(batches[0], rules, mesh)
        batches = [CV.shard_tree(b, bspecs, mesh, dev) for b in batches]
        split = [_spec_split(s) for s in TR.leaves(specs)]
        m_rank = SH.mesh_coords(mesh)["model"]
    else:
        params = full
    state = TS.train_state_from_params(params, tc)
    del params
    clips = []
    real_clip = TS.clip_by_global_norm

    def spy(tree, max_norm, norm=None):
        sq = sum(torch.sum(torch.square(g.float()))
                 for g, sp in zip(TR.leaves(tree), split) if sp or m_rank == 0)
        torch.distributed.all_reduce(sq)         # not the step's: uncounted
        clips.append((float(norm), float(torch.sqrt(sq))))
        return real_clip(tree, max_norm, norm)

    if mesh is not None:
        TS.clip_by_global_norm = spy
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)
    KU.reset_launches()
    comm.reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    try:
        with SH.use_rules(rules, mesh):
            step = TS.make_train_step(cfg, tc, 1)
            for b in batches:
                sync()
                t0 = time.perf_counter()
                with SH.use_rules(rules, mesh):
                    state, met = step(state, b)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
    finally:
        TS.clip_by_global_norm = real_clip
    out = {"losses": losses, "clips": clips, "ms_per_step": ms,
           "launches": dict(ops.LAUNCHES),
           "all_reduce": dict(comm.COUNTS["all_reduce"]),
           "all_gather": dict(comm.COUNTS["all_gather"]),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card
           else 0,
           "n_leaves": len(TR.leaves(state.params)),
           "names": leaf_names(state.params)}
    if mesh is None:
        out["params"] = [t[0] for t in TR.leaves(state.params)]
        return out
    out["params"] = [t[0] for t in TR.leaves(CV.gather_tree(
        state.params, specs, mesh, shapes))]
    same = True
    model = (mesh, "model")
    for leaf, sp in zip(TR.leaves(state.params), split):
        if not sp:
            got = comm.all_gather(leaf.contiguous(), model)
            same &= bool(torch.equal(got[0], got[-1]))
    out["replicated_bit_equal"] = same
    return out


def tp_family_serve(dev, arch, mesh=None, planted=None) -> dict:
    """The serving units of TP_FAM for ``arch`` in f32 at TP_FAMILIES'
    depth from the seed-0 draw, in one process or on this rank's shards
    under ``serve_rules``: the prefill's last logits, then greedy decode's
    logits and tokens, gathered whole (with ``planted``, the prefill
    alone under that fault)."""
    import numpy as np
    import torch
    from repro_torch import convert as CV
    from repro_torch.configs import registry as REG
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as TM
    from repro_torch.serving import engine as E
    from repro_torch.training import train_step as TS

    cfg = REG.get_config(arch).replace(
        n_layers=TP_FAMILIES[arch]["n_layers"], param_dtype="float32",
        compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    full = TM.init_params(gen, cfg, (), dev)
    rng = np.random.default_rng(0)
    B, S = TP_FAM["prefill"]
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       device=dev)}
    if cfg.family == "vlm":
        n = TP_FAM["img_tokens"]
        batch["img_embeds"] = torch.as_tensor(
            rng.normal(size=(B, n, cfg.d_model)), dtype=torch.float32,
            device=dev)
        batch["img_pos"] = torch.arange(n, device=dev).expand(B, n)
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(B, cfg.n_frames, cfg.d_model)),
            dtype=torch.float32, device=dev)
    V = cfg.vocab
    rules = None
    params = full
    if mesh is not None:
        rules = TS.serve_rules(cfg, False, B, mesh)
        params = CV.shard_tree(full, TS.param_specs(full, rules, mesh,
                                                    False), mesh, dev)
        batch = CV.shard_tree(batch, TS.batch_specs_serve(batch, rules,
                                                          mesh), mesh, dev)
    del full

    def whole(t):
        return t if mesh is None else SH.gather(
            t.contiguous(), SH.P(None, "model"), mesh, (B, V))

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = {}
    fault = tp_fam_planted(planted) if planted else None
    if fault:
        real = getattr(fault[0], fault[1])
        setattr(fault[0], fault[1], fault[2])
    try:
        with torch.no_grad(), SH.use_rules(rules, mesh):
            sync()
            t0 = time.perf_counter()
            lg = E.make_prefill(cfg)(params, batch)
            sync()
            out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            out["prefill"] = whole(lg).float().cpu()
            if fault:
                return out
            cache = D.init_cache(cfg, B, TP_FAM["max_len"], device=dev)
            if mesh is not None:
                cache = CV.shard_tree(cache, TS.cache_specs(cache, rules,
                                                            mesh), mesh, dev)
            if cfg.family == "audio":
                cache = D.encode_for_decode(params, cache, batch["frames"],
                                            cfg)
            step = E.make_serve_step(cfg)
            tok, logits, toks, ms = batch["tokens"][:, :1], [], [], []
            calls = {"all_reduce": 0, "all_gather": 0}   # the serve steps'
            for t in range(TP_FAM["decode_steps"]):
                lg, _ = D.decode_step(params, cache, tok, t, cfg)
                sync()
                before = {k: comm.COUNTS[k]["calls"] for k in calls}
                t0 = time.perf_counter()
                tok, cache = step(params, cache, tok, t)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                for k in calls:
                    calls[k] += comm.COUNTS[k]["calls"] - before[k]
                logits.append(whole(lg[:, -1]).float().cpu())
                toks.append(tok[:, 0].cpu())
            out["decode_calls_per_step"] = {k: v / len(ms)
                                            for k, v in calls.items()}
    finally:
        if fault:
            setattr(fault[0], fault[1], real)
    out["logits"], out["tokens"] = torch.stack(logits), torch.stack(toks)
    out["decode_ms"] = ms
    return out


def _tc_family(arch, exact=False):
    from repro_torch.training import train_step as TS

    if exact:
        return TS.TrainConfig(memory_mode="exact",
                              T=TP_FAMILIES[arch]["exact_T"],
                              use_kernel=True, grad_clip=DIST["grad_clip"])
    return TS.TrainConfig(memory_mode="expsum",
                          K=TP_FAMILIES[arch].get("K", TP_FAM["K"]),
                          acc_dtype=TP_FAMILIES[arch]["acc_dtype"],
                          use_kernel=True, grad_clip=DIST["grad_clip"])


@contextlib.contextmanager
def cublaslt():
    """Every GEMM through cuBLASLt rather than cuBLAS for the span of the
    block: the same products in another summation order."""
    import torch

    prev = torch.backends.cuda.preferred_blas_library()
    torch.backends.cuda.preferred_blas_library("cublaslt")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_blas_library(prev)


def param_ulps(names, got, want) -> tuple:
    """(per leaf, the largest |got - want| in bf16 ulps of the larger of
    the element and its leaf's RMS; the largest share of a leaf's elements
    that differ)."""
    import torch

    ulps, share = {}, 0.0
    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.to(a.device).float()
        d = (a - b).abs()
        rms = torch.sqrt(torch.mean(b * b))
        ulps[name] = float((d / (torch.maximum(b.abs(), rms)
                                 * 2.0 ** -7)).max())
        share = max(share, float((d > 0).float().mean()))
    return ulps, share


def tp_families_reference(dev, tmp: str, before=None) -> dict:
    """The one-process units of every family of TP_FAMILIES, in order,
    saved to ``tmp/fam_<arch>.pt`` for the ranks (``before(arch)`` runs
    before each family), with their spread where the family asks for it;
    returns each family's launches, ms, peak and spread."""
    import torch

    out = {}
    for arch in TP_FAMILIES:
        if before is not None:
            before(arch)
        t0 = time.perf_counter()
        ref = {"train": tp_family_train(dev, arch, _tc_family(arch))}
        if "exact_T" in TP_FAMILIES[arch]:
            ref["exact"] = tp_family_train(dev, arch, _tc_family(arch, True))
        ref["serve"] = tp_family_serve(dev, arch)
        for k in ("train", "exact"):
            if k in ref:
                ref[k]["params"] = [t.cpu() for t in ref[k]["params"]]
        if TP_FAMILIES[arch].get("spread"):
            with cublaslt():
                for k in ("train", "exact"):
                    if k in ref:
                        alt = tp_family_train(dev, arch,
                                              _tc_family(arch, k == "exact"))
                        ref[k]["spread_ulps"] = param_ulps(
                            alt["names"], alt["params"], ref[k]["params"])[0]
                        del alt
                alt = tp_family_serve(dev, arch)
            want = ref["serve"]
            ref["serve"]["spread_err"] = {
                u: close_np(alt[u], want[u], TP_SERVE_TOL)[1]
                for u in ("prefill", "logits")}
            check(torch.equal(alt["tokens"], want["tokens"]),
                  f"{arch} one-process serving through cuBLASLt: tokens "
                  f"differ")
            del alt
        torch.save(ref, os.path.join(tmp, f"fam_{arch}.pt"))
        open(os.path.join(tmp, f"fam_{arch}.ready"), "w").close()
        out[arch] = {k: {"launches": v["launches"],
                         "ms_per_step": v["ms_per_step"],
                         "peak_bytes": v["peak_bytes"]}
                     for k, v in ref.items() if k != "serve"}
        out[arch]["serve"] = {"prefill_ms": ref["serve"]["prefill_ms"],
                              "decode_ms": ref["serve"]["decode_ms"],
                              "spread_err": ref["serve"].get("spread_err")}
        for k in ("train", "exact"):
            if "spread_ulps" in ref.get(k, {}):
                out[arch][k]["spread_worst_leaves"] = sorted(
                    ref[k]["spread_ulps"].items(), key=lambda kv: kv[1],
                    reverse=True)[:3]
        out[arch]["seconds"] = time.perf_counter() - t0
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _family_vs(mine: dict, ref: dict) -> dict:
    """A family's train run on the ranks against the one-process run."""
    ulps, share = param_ulps(mine["names"], mine["params"], ref["params"])
    spread = ref.get("spread_ulps", {})
    limit = {n: max(DIST_ULPS, TP_SPREAD_FACTOR * spread.get(n, 0.0))
             for n in ulps}
    worst = max(ulps.values())
    ok_l, err_l = close_np(mine["losses"], ref["losses"], DIST_LOSS_TOL)
    ok_c, err_c = close_np([c[0] for c in mine["clips"]],
                           [c[1] for c in mine["clips"]], TP_NORM_TOL)
    return {"held": ok_l and ok_c and mine["replicated_bit_equal"]
            and all(ulps[n] <= limit[n] for n in ulps),
            "losses": mine["losses"], "ref_losses": ref["losses"],
            "max_abs_loss_diff": err_l, "clip_norms": mine["clips"],
            "max_abs_clip_norm_diff": err_c, "param_max_ulps": worst,
            "param_worst_leaves": sorted(ulps.items(), key=lambda kv: kv[1],
                                         reverse=True)[:3],
            "param_ulps_limits_over_2": {n: v for n, v in limit.items()
                                         if v > DIST_ULPS},
            "param_share_differing": share,
            "replicated_bit_equal": mine["replicated_bit_equal"],
            "launches": mine["launches"], "n_leaves": mine["n_leaves"],
            "ms_per_step": mine["ms_per_step"],
            "ref_ms_per_step": ref["ms_per_step"],
            "all_reduce_per_step": {k: mine["all_reduce"][k]
                                    / len(mine["losses"])
                                    for k in ("calls", "bytes")},
            "all_gather_per_step": {k: mine["all_gather"][k]
                                    / len(mine["losses"])
                                    for k in ("calls", "bytes")},
            "peak_bytes": mine["peak_bytes"],
            "ref_peak_bytes": ref["peak_bytes"]}


def tp_families_ranks(dev, tmp: str, mesh, rank: int) -> None:
    """Every family of TP_FAMILIES on this serving rank, in order: the
    train runs, the serving units and the planted fault, each held
    against the one-process units in ``tmp`` once they are there; this
    rank's results to ``tmp/fam_<arch>_r<rank>.json``."""
    import torch

    on_card = dev.type == "cuda"
    for arch in TP_FAMILIES:
        t0 = time.perf_counter()
        runs = {"train": tp_family_train(dev, arch, _tc_family(arch), mesh)}
        if "exact_T" in TP_FAMILIES[arch]:
            runs["exact"] = tp_family_train(dev, arch, _tc_family(arch, True),
                                            mesh)
        serve = tp_family_serve(dev, arch, mesh)
        fault = TP_FAM_PLANTED.get(arch)
        bad = tp_family_serve(dev, arch, mesh, fault) if fault else None
        t_run = time.perf_counter() - t0
        ready = os.path.join(tmp, f"fam_{arch}.ready")
        while not os.path.exists(ready):
            time.sleep(0.05)
        ref = torch.load(os.path.join(tmp, f"fam_{arch}.pt"))
        res = {k: _family_vs(v, ref[k]) for k, v in runs.items()}
        want = ref["serve"]
        ok_p, err_p = close_np(serve["prefill"], want["prefill"],
                               TP_SERVE_TOL)
        ok_d, err_d = close_np(serve["logits"], want["logits"], TP_SERVE_TOL)
        spread = want.get("spread_err")
        if spread:
            ok_p |= err_p <= TP_SPREAD_FACTOR * spread["prefill"]
            ok_d |= err_d <= TP_SPREAD_FACTOR * spread["logits"]
        res["serve"] = {
            "held": ok_p and ok_d and torch.equal(serve["tokens"],
                                                  want["tokens"]),
            "one_process_spread": spread,
            "prefill_max_abs_err": err_p, "decode_max_abs_err": err_d,
            "tokens_equal": torch.equal(serve["tokens"], want["tokens"]),
            "prefill_ms": serve["prefill_ms"],
            "ref_prefill_ms": want["prefill_ms"],
            "median_decode_ms": statistics.median(serve["decode_ms"][1:]),
            "ref_median_decode_ms": statistics.median(
                want["decode_ms"][1:]),
            "decode_calls_per_step": serve["decode_calls_per_step"]}
        if fault:
            passes, err = close_np(bad["prefill"], want["prefill"],
                                   TP_SERVE_TOL)
            res["planted"] = {fault: {"passes_the_check": passes,
                                      "max_abs_err": err}}
        res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if on_card else 0)
        res["run_s"] = t_run
        res["seconds"] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"fam_{arch}_r{rank}.json"), "w") as f:
            json.dump(res, f)
        del runs, serve, bad, ref
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)


def tp_families_check(tmp: str, ranks: int, ref: dict) -> dict:
    """The checks of every family's rank results (``tmp``) and the
    one-process runs' summary ``ref``; returns the families' line and the
    launches of the paths."""
    out, launches = {}, {}
    for arch in TP_FAMILIES:
        per_rank = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"fam_{arch}_r{r}.json")) as f:
                per_rank.append(json.load(f))
        for r, res in enumerate(per_rank):
            tag = f"tensor_parallel {arch} rank {r}"
            for kind in ("train", "exact"):
                if kind not in res:
                    continue
                x = res[kind]
                check(x["held"], f"{tag} {kind}: loss {x['max_abs_loss_diff']}"
                      f", clip norm {x['max_abs_clip_norm_diff']}, "
                      f"parameters {x['param_max_ulps']} bf16 ulps, "
                      f"replicated equal {x['replicated_bit_equal']}")
                steps = TP_FAM["exact_steps" if kind == "exact" else "steps"]
                key = ("frodo_exact_update" if kind == "exact"
                       else "frodo_expsum_update")
                want = {"frodo_exact_update": 0, "frodo_expsum_update": 0,
                        key: x["n_leaves"] * steps}
                check(x["launches"] == want, f"{tag} {kind}: launches "
                      f"{x['launches']}, want {want}")
            s = res["serve"]
            check(s["held"], f"{tag} serving f32: prefill "
                  f"{s['prefill_max_abs_err']}, decode "
                  f"{s['decode_max_abs_err']}, tokens equal "
                  f"{s['tokens_equal']}")
            check(res["peak_bytes"] <= LLM_PEAK_LIMIT,
                  f"{tag}: peak device memory {res['peak_bytes']}")
        for name, p in per_rank[0].get("planted", {}).items():
            check(not all(r["planted"][name]["passes_the_check"]
                          for r in per_rank),
                  f"planted {name} passed the check on every rank")
        for kind in ("train", "exact"):
            if kind in per_rank[0]:
                check(ref[arch][kind]["peak_bytes"] <= LLM_PEAK_LIMIT,
                      f"{arch} one-process {kind}: peak device memory "
                      f"{ref[arch][kind]['peak_bytes']}")
                for k, v in (("2ranks", [r[kind]["launches"]
                                         for r in per_rank]),
                             ("one_process", [ref[arch][kind]["launches"]])):
                    tot = launches.setdefault(
                        f"tensor_parallel_families_{k}",
                        {"frodo_exact_update": 0, "frodo_expsum_update": 0})
                    for ln in v:
                        for n in tot:
                            tot[n] += ln[n]
        out[arch] = {"one_process": ref[arch], "per_rank": per_rank}
    return {"families": out, "launches": launches}


def tensor_parallel_phase(dev, ref_dir: str) -> dict:
    """Tensor-parallel training and serving of h2o-danube-1.8b on the card
    (module docstring): four train ranks against the distributed phase's
    stacked run in ``ref_dir`` (then exact memory against a stacked exact
    run) and two serving ranks against the one-process units; this
    process runs the stacked exact run and the one-process units
    meanwhile; the planted faults must fail."""
    import numpy as np
    import torch
    from repro_torch import tree as TR
    from repro_torch.distributed import comm
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    respawns = comm.RESPAWNS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    torch.cuda.empty_cache()
    n_train = TP["mesh"][0] * TP["mesh"][1]
    n_serve = TP_SERVE["mesh"][0] * TP_SERVE["mesh"][1]
    ctxs = []
    for fn, n, args in ((_tp_train_rank, n_train, (tmp, ref_dir, str(dev))),
                        (_tp_serve_rank, n_serve, (tmp, str(dev)))):
        store = os.path.join(tmp, fn.__name__)
        os.makedirs(store)
        ctxs.append(comm.spawn(fn, n, *args, backend="gloo",
                               store_dir=store, join=False))
    try:
        # the stacked exact run the ranks' exact steps are held against
        KU.reset_launches()
        x_state, x_losses, x_norms, _, x_mem = dist_run(
            dist_trainer(dev, None, memory_mode="exact", T=TP["exact_T"]),
            TP["exact_steps"])
        stacked_exact = dict(ops.LAUNCHES)
        clip = DIST["grad_clip"] * DIST["agents"] ** 0.5
        check(all(v > clip for v in x_norms),
              f"exact: the clip does not bind at every step: {x_norms}")
        check(bool(np.isfinite(x_losses).all()),
              f"stacked exact losses not finite: {x_losses}")
        flat = TR.leaves(x_state.params)
        for a in range(DIST["agents"]):
            torch.save({"losses": x_losses, "acc_norms": x_mem,
                        "params": [t[a].cpu() for t in flat]},
                       os.path.join(tmp, f"ref_exact{a}.pt"))
        del x_state, flat
        torch.cuda.empty_cache()
        open(os.path.join(tmp, "ref_exact_ready"), "w").close()
        ref = {dt: tp_serve_run(dev, dt) for dt in ("float32", "bfloat16")}
        torch.cuda.empty_cache()

        def before(arch):
            # the two largest families' one-process states (qwen3-moe,
            # then recurrentgemma) beside their ranks', not beside the
            # train ranks' as well
            if arch == MOE_ARCH:
                while not ctxs[0].join():
                    pass

        t_fam = time.perf_counter()
        fam_ref = tp_families_reference(dev, tmp, before)
        fam_ref_s = time.perf_counter() - t_fam
        for ctx in ctxs:
            while not ctx.join():
                pass
    finally:
        for ctx in ctxs:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
    gemm = row_parallel_gemm(dev)
    fams = tp_families_check(tmp, n_serve, fam_ref)
    fam_s = []
    for r in range(n_serve):
        with open(os.path.join(tmp, f"families_s{r}.json")) as f:
            fam_s.append(json.load(f))
    emit("tensor_parallel.families", nvidia_smi=nvidia_smi(),
         mesh=TP_SERVE["mesh"], settings=TP_FAM,
         depth={a: v["n_layers"] for a, v in TP_FAMILIES.items()},
         acc_dtype={a: v["acc_dtype"] for a, v in TP_FAMILIES.items()},
         reduced=TP_FAM_REDUCED, grad_clip=DIST["grad_clip"],
         tol={"loss": DIST_LOSS_TOL, "clip_norm": TP_NORM_TOL,
              "param_bf16_ulps_of_leaf_rms": DIST_ULPS,
              "serve_f32": TP_SERVE_TOL, "peak_bytes": LLM_PEAK_LIMIT,
              "one_process_spread_factor": TP_SPREAD_FACTOR},
         ranks_seconds=fam_s, one_process_seconds=fam_ref_s,
         **fams["families"])
    ranks = []
    for r in range(n_train):
        with open(os.path.join(tmp, f"train{r}.json")) as f:
            ranks.append(json.load(f))
    emit("tensor_parallel.ranks", ranks=[
        {k: v for k, v in r.items() if k not in ("groups",)}
        for r in ranks])
    for r in ranks:
        tag = f"tensor_parallel rank {r['rank']} {r['coords']}"
        check(r["held"], f"{tag}: against the stacked run: loss "
                         f"{r['max_abs_loss_diff']}, state norms "
                         f"{r['max_abs_state_norm_diff']}, clip norm "
                         f"{r['max_abs_clip_norm_diff']}")
        check(r["param_max_ulps"] <= DIST_ULPS,
              f"{tag}: parameters {r['param_max_ulps']} bf16 ulps from the "
              f"stacked run's")
        check(r["replicated_bit_equal"],
              f"{tag}: replicated leaves differ across model ranks")
        check(r["state_bytes"] <= TP_STATE_SHARE * r["one_agent_state_bytes"],
              f"{tag}: state {r['state_bytes']} bytes against one agent's "
              f"{r['one_agent_state_bytes']}")
        check(r["launches"] == {"frodo_exact_update": 0,
                                "frodo_expsum_update": r["n_leaves"]
                                * TP["steps"]},
              f"{tag}: launches {r['launches']}")
        x = r["exact"]
        check(x["held"], f"{tag} exact: against the stacked exact run: loss "
                         f"{x['max_abs_loss_diff']}, history norms "
                         f"{x['max_abs_state_norm_diff']}, clip norm "
                         f"{x['max_abs_clip_norm_diff']}")
        check(x["param_max_ulps"] <= DIST_ULPS,
              f"{tag} exact: parameters {x['param_max_ulps']} bf16 ulps "
              f"from the stacked exact run's")
        check(x["replicated_bit_equal"],
              f"{tag} exact: replicated leaves differ across model ranks")
        check(x["launches"] == {"frodo_exact_update": r["n_leaves"]
                                * TP["exact_steps"],
                                "frodo_expsum_update": 0},
              f"{tag} exact: launches {x['launches']}")
    for name in ranks[0]["planted"]:
        check(not all(r["planted"][name]["passes_the_check"] for r in ranks),
              f"planted {name} passed the check on every rank")
    serve = torch.load(os.path.join(tmp, "serve.pt"))
    f32, b16 = serve["float32"], serve["bfloat16"]
    ok_p, err_p = close_np(f32["prefill"], ref["float32"]["prefill"],
                           TP_SERVE_TOL)
    ok_l, err_l = close_np(f32["logits"], ref["float32"]["logits"],
                           TP_SERVE_TOL)
    check(ok_p and ok_l, f"tensor_parallel serving f32: prefill {err_p}, "
                         f"decode {err_l} against the one-process units")
    check(torch.equal(f32["tokens"], ref["float32"]["tokens"]),
          "tensor_parallel serving f32: tokens differ")
    lim = DVF_TOL[LLM_ARCH]["bfloat16"]
    err_bp = float((b16["prefill"] - ref["bfloat16"]["prefill"]).abs().max())
    err_bl = float((b16["logits"] - ref["bfloat16"]["logits"]).abs().max())
    check(err_bp <= lim and err_bl <= lim,
          f"tensor_parallel serving bf16: prefill {err_bp}, decode {err_bl} "
          f"(limit {lim})")
    k = TP_SERVE["planted_steps"]
    ok_x, err_x = close_np(serve["planted"]["logits"],
                           ref["float32"]["logits"][:k], TP_SERVE_TOL)
    check(not ok_x, "planted combine_without_max_rescale passed the check")
    steps = TP["steps"]
    per_rank = []
    for r in ranks:
        by_group = {g: {"all_reduce_ms_per_step":
                        c.get("all_reduce", {}).get("ms", 0.0) / steps,
                        "all_reduce_bytes_per_step":
                        c.get("all_reduce", {}).get("bytes", 0) / steps,
                        "all_reduce_calls_per_step":
                        c.get("all_reduce", {}).get("calls", 0) / steps}
                    for g, c in r["groups"].items()}
        per_rank.append({
            "rank": r["rank"], "coords": r["coords"],
            "median_ms_per_step": r["median_ms_per_step"],
            "ms_per_step": r["ms_per_step"], "by_group": by_group,
            "peak_bytes": r["peak_bytes"],
            "state_bytes": r["state_bytes"],
            "state_share_of_one_agent": r["state_bytes"]
            / r["one_agent_state_bytes"],
            "expsum_launches": r["launches"]["frodo_expsum_update"],
            "max_abs_loss_diff": r["max_abs_loss_diff"],
            "max_abs_state_norm_diff": r["max_abs_state_norm_diff"],
            "max_abs_clip_norm_diff": r["max_abs_clip_norm_diff"],
            "param_max_ulps": r["param_max_ulps"],
            "param_share_differing": r["param_share_differing"],
            "param_elements_over_ulps_of_own_magnitude":
                r["param_elements_over_ulps_of_own_magnitude"],
            "planted": r["planted"], "exact": r["exact"],
            "start_s": r["start_s"], "seconds": r["seconds"]})
    emit("tensor_parallel", nvidia_smi=nvidia_smi(), arch=LLM_ARCH,
         respawns=comm.RESPAWNS - respawns,
         train={"mesh": TP["mesh"], "n_layers": DIST["n_layers"],
                "seq": DIST["seq"], "agents": DIST["agents"],
                "batch_per_agent": DIST["batch_per_agent"], "K": DIST["K"],
                "acc_dtype": "float32", "grad_clip": DIST["grad_clip"],
                "steps": steps, "reduced": TP_REDUCED,
                "stacked_reference": "the distributed phase's",
                "exact": {"T": TP["exact_T"], "steps": TP["exact_steps"],
                          "stacked_losses": x_losses,
                          "stacked_grad_norm": x_norms},
                "per_rank": per_rank},
         serve={"mesh": TP_SERVE["mesh"], "n_layers": TP_SERVE["n_layers"],
                "batch": TP_SERVE["batch"], "prefill": TP_SERVE["prefill"],
                "steps": TP_SERVE["steps"], "max_len": TP_SERVE["max_len"],
                "reduced": TP_SERVE_REDUCED,
                "f32": {"prefill_max_abs_err": err_p,
                        "decode_max_abs_err": err_l, "tokens_equal": True,
                        "prefill_ms": f32["prefill_ms"],
                        "one_process_prefill_ms":
                            ref["float32"]["prefill_ms"],
                        "median_decode_ms": statistics.median(
                            f32["decode_ms"][1:]),
                        "one_process_median_decode_ms": statistics.median(
                            ref["float32"]["decode_ms"][1:]),
                        "decode_all_reduce_per_step":
                            f32["decode_all_reduce_per_step"]},
                "bf16": {"prefill_max_abs_err": err_bp,
                         "decode_max_abs_err": err_bl, "limit": lim,
                         "median_decode_ms": statistics.median(
                             b16["decode_ms"][1:]),
                         "one_process_median_decode_ms": statistics.median(
                             ref["bfloat16"]["decode_ms"][1:])},
                "planted_combine_without_max_rescale": {
                    "passes_the_check": ok_x, "max_abs_err": err_x},
                "peak_bytes_rank0": serve["peak_bytes"]},
         row_parallel_gemm=gemm,
         tol={"loss": DIST_LOSS_TOL, "param_bf16_ulps": DIST_ULPS,
              "state_norms": DIST_STATE_TOL, "clip_norm": TP_NORM_TOL,
              "state_share": TP_STATE_SHARE, "serve_f32": TP_SERVE_TOL,
              "serve_bf16_max_abs": lim},
         seconds=time.perf_counter() - t_phase)
    total = {k: sum(r["launches"][k] for r in ranks)
             for k in ranks[0]["launches"]}
    total_x = {k: sum(r["exact"]["launches"][k] for r in ranks)
               for k in ranks[0]["exact"]["launches"]}
    return {"launches": {"tensor_parallel_4ranks": total,
                         "tensor_parallel_stacked_exact": stacked_exact,
                         "tensor_parallel_exact_4ranks": total_x,
                         **fams["launches"]},
            "per_rank_expsum": [r["launches"]["frodo_expsum_update"]
                                for r in ranks],
            "per_rank_exact": [r["exact"]["launches"]["frodo_exact_update"]
                               for r in ranks]}



# ------------------------------------------------------------------ fsdp
#: the fsdp and batch rules over "data" beside the "model" axis: four gloo
#: ranks share the card at (data 2, model 2) under ``build_rules`` of an
#: fsdp config on one pod (one agent, no agent axis): the agent's two
#: rows one a data rank, each layer's fsdp leaves split over "data" and
#: gathered at use (their gradients reduce-scattered back), the leaves
#: the data axis replicates summed over it.  Every check is against the
#: one-process step of the same batch, which this process runs before the
#: ranks start (never beside them: memory).
FSDP_ARCH = "qwen3-32b"
FSDP = dict(mesh=(2, 2), n_layers=2, seq=2048, batch=2, K=4,
            acc_dtype="bfloat16", steps=2, planted_steps=1)
#: qwen3-moe-30b-a3b at 1 layer: 1 exp-sum step of 2 microbatches over 4
#: rows (one a data rank in each microbatch; microbatch m is rows [2m, 2m
#: + 2) of the agent's, as the JAX step groups them), the label positions
#: ``masked`` of each row masked and the experts' capacity factor cut to
#: ``capacity_factor`` (half the assignments drop: which drop, and each
#: microbatch's count of labels, depend on its rows, so microbatches cut
#: from each rank's own rows give another loss), then 2 exact steps of one
#: microbatch (the second reads the first's history); the microbatch
#: grouping is planted in one microbatched step
FSDP_MOE = dict(n_layers=1, steps=1, microbatches=2,
                masked=(0, 512, 1024, 1536), capacity_factor=0.5,
                exact_steps=2, exact_T=8)
#: the train runs, in order (the smaller model first: a fresh rank's first
#: step also pays the card's and gloo's first-use costs): (arch, depth,
#: exact memory, steps, microbatches); a run of M microbatches takes
#: M x FSDP["batch"] rows
FSDP_RUNS = {"moe": (MOE_ARCH, FSDP_MOE["n_layers"], False,
                     FSDP_MOE["steps"], FSDP_MOE["microbatches"]),
             "moe_exact": (MOE_ARCH, FSDP_MOE["n_layers"], True,
                           FSDP_MOE["exact_steps"], 1),
             "dense": (FSDP_ARCH, FSDP["n_layers"], False, FSDP["steps"],
                       1)}
#: serving under ``serve_rules(..., weights_fsdp=True)`` in f32: a prefill
#: of 2 x 256 tokens (one row a data rank), then greedy decode steps
#: (``decode_step``'s logits, the tokens their ``vocab_argmax``, as
#: ``make_serve_step`` takes them) from an empty cache of 256 slots (128 a
#: model rank)
FSDP_SERVE = dict(n_layers=2, prefill=(2, 256), decode_steps=2,
                  max_len=256)
FSDP_REDUCED = {
    "n_layers": "qwen3-32b 64 -> 2 (train and serving), qwen3-moe-30b-a3b "
                "48 -> 1 (its llm_train cell)",
    "K": "8 -> 4 with bf16 accumulators",
    "seq": "train_4k's 4096 -> 2048",
    "global_batch": "256 -> 2 (one agent: one row a data rank); qwen3-moe's "
                    "exp-sum run 4 (one row a data rank a microbatch)",
    "microbatches": "8 -> 2 (qwen3-moe's exp-sum run), 8 -> 1 (the others)",
    "steps": "qwen3-32b 3 -> 2, qwen3-moe's exp-sum run 2 -> 1 of 2 "
             "microbatches (1.54 times a one-microbatch step's bytes "
             "through gloo: its gathers and reduce-scatters twice), "
             "serving's decode 16 -> 2 (the script's time: a qwen3-32b "
             "step moves ~6.5 GB a rank through gloo, 10.6-18.5 s, and an "
             "f32 decode step gathers 975 MB, 3.3-4.8 s)",
    "capacity_factor": "qwen3-moe's microbatched run 1.25 -> 0.5 (half the "
                       "assignments drop, so which drop depends on the "
                       "microbatch's rows)",
    "labels": "qwen3-moe's microbatched run: the first 0, 512, 1,024 and "
              "1,536 positions of its 4 rows masked (unequal label counts "
              "a microbatch); the others unmasked",
    "mesh": "(data 2, model 2): four ranks share one H100 over gloo; the "
            "production mesh is 16 x 16"}
#: each rank's state (its parameter and memory shards) against the agent's
#: whole state: the layers' leaves 1/4, the vocab-split embedding and head
#: 1/2, the norms whole
FSDP_STATE_SHARE = 0.45
#: the four ranks' peaks, summed
FSDP_PEAK_SUM = 72e9
#: the MoE aux loss of layer 0's forward on the ranks' rows against the
#: one-process forward's: f32 sums in another order.  The load balance is
#: a product of two means over the agent's rows; each rank's own means
#: (the planted fault) move it by far more
FSDP_AUX_TOL = dict(rtol=1e-5, atol=0.0)
FSDP_PLANTED = ("replicated_counted_on_every_data_rank",
                "batch_sum_skipped", "load_balance_over_local_means",
                "microbatch_from_local_rows")
#: the train run whose first step a planted fault is read from (FSDP_RUNS'
#: key), not run: the clip norm that the replicated leaves counted on both
#: data ranks give over qwen3-32b's gradient; the clip norm and the
#: replicas of qwen3-moe's exact gradient before its sum over the data
#: axes (what the step would clip and apply with the sum skipped)
FSDP_READ_FROM = {"replicated_counted_on_every_data_rank": "dense",
                  "batch_sum_skipped": "moe_exact"}
#: the planted faults that run a step of their own, each as a step of a
#: train run (FSDP_RUNS' key): the microbatch grouping, of the
#: microbatched run
FSDP_PLANTED_IN = {"microbatch_from_local_rows": "moe"}


def _fsdp_cfg(arch, n_layers, dtype=None):
    from repro_torch.configs import registry as REG

    cfg = REG.get_config(arch).replace(n_layers=n_layers)
    return cfg if dtype is None else cfg.replace(param_dtype=dtype,
                                                 compute_dtype=dtype)


def _fsdp_tc(exact=False, microbatches=1):
    from repro_torch.training import train_step as TS

    if exact:
        return TS.TrainConfig(memory_mode="exact", T=FSDP_MOE["exact_T"],
                              use_kernel=True, grad_clip=DIST["grad_clip"],
                              microbatches=microbatches)
    return TS.TrainConfig(memory_mode="expsum", K=FSDP["K"],
                          acc_dtype=FSDP["acc_dtype"], use_kernel=True,
                          grad_clip=DIST["grad_clip"],
                          microbatches=microbatches)


def _fsdp_counted(specs, mesh) -> list:
    """The spy's flags, from the spec tree alone: a leaf counts on the
    ranks whose coordinate is 0 on every axis that does not split it."""
    from repro_torch import tree as TR
    from repro_torch.distributed import sharding as SH

    coords = SH.mesh_coords(mesh)
    return [all(c == 0 for a, c in coords.items()
                if a not in {x for p in spec for x in SH.axes_of(p)})
            for spec in TR.leaves(specs)]


def _checksums(leaves) -> "torch.Tensor":
    """Per leaf, a position-weighted sum of its bits (int64, in chunks)."""
    import torch

    out = []
    for t in leaves:
        bits = t.detach().contiguous().view(
            {2: torch.int16, 4: torch.int32}[t.element_size()]).reshape(-1)
        s = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), 1 << 24):
            c = bits[i:i + (1 << 24)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=t.device) % 8191 + 1
            s = s + (c * w).sum()
        out.append(s)
    return torch.stack(out)


def _replicas_equal(leaves, specs, mesh) -> bool:
    """Every leaf bit-equal (by checksum) on the ranks whose coordinates
    agree on the axes that split it (gathered outside ``comm``'s counts:
    it may run inside a step)."""
    import torch
    from repro_torch.distributed import sharding as SH

    mine = _checksums(leaves).cpu()
    sums = [torch.empty_like(mine)
            for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(sums, mine)
    sums = torch.stack(sums)                                  # (world, n)
    ranks = mesh.mesh
    coords = [dict(zip(mesh.mesh_dim_names,
                       (ranks == r).nonzero()[0].tolist()))
              for r in range(sums.shape[0])]
    for j, spec in enumerate(specs):
        used = {a for p in spec for a in SH.axes_of(p)}
        for r, c in enumerate(coords):
            twin = [q for q, e in enumerate(coords)
                    if all(e[a] == c[a] for a in used)][0]
            if not torch.equal(sums[r, j], sums[twin, j]):
                return False
    return True


def _drawn_and_cut(draw, specs, mesh, dev):
    """This rank's shards of ``draw()``'s whole tree, the whole tree freed
    and the allocator's cache released before the next allocation (four
    ranks' whole draws and states share the card)."""
    import torch
    from repro_torch import convert as CV

    local = CV.shard_tree(draw(), specs, mesh, dev)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return local


def fsdp_train(dev, arch, n_layers, tc, steps, mesh=None,
               timed=False, bad_counted=None, skip_sum=False) -> dict:
    """``steps`` train steps of ``arch`` at ``n_layers`` from the seed-0
    draw, one agent of ``tc.microbatches`` x FSDP["batch"] rows (with more
    than one microbatch, FSDP_MOE["masked"] label positions masked by row
    and a MoE's capacity factor FSDP_MOE's): in one process (``mesh``
    None) or on this rank's shards and rows under ``build_rules``.
    Losses, the clip norm the step used beside the spec tree's norm of its
    gradient, ms per step, launches, the collectives by group, peak
    memory, the state's bytes and its parameters (whole in one process,
    this rank's shards on a mesh, with whether every replica is
    bit-equal).  With
    ``bad_counted`` (a ``model_counted`` in place), the clip norm the
    first step would take with those flags, beside the spec tree's; with
    ``skip_sum``, the first step's gradient before its sum over the data
    axes (as the step would clip and apply it with the sum skipped): its
    clip norm beside the spec tree's norm of the summed one, and whether
    its replicas are bit-equal."""
    import torch
    from repro_torch import convert as CV
    from repro_torch import tree as TR
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TM
    from repro_torch.training import train_step as TS

    cfg = _fsdp_cfg(arch, n_layers)
    M = tc.microbatches
    if M > 1 and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=FSDP_MOE["capacity_factor"]))
    data = iter(TokenPipeline(vocab=cfg.vocab, seq_len=FSDP["seq"],
                              batch_per_agent=FSDP["batch"] * M, n_agents=1,
                              seed=0))
    batches = [next(data) for _ in range(steps)]
    if M > 1:
        for b in batches:
            b["labels"] = b["labels"].copy()        # a view of the tokens
            for row, n in enumerate(FSDP_MOE["masked"]):
                b["labels"][:, row, :n] = -1
    rules = specs = None
    on_card = dev.type == "cuda"

    def draw():
        return TM.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, (1,), dev)

    if mesh is not None:
        rules = TS.build_rules(cfg, False)
        specs = TS.param_specs(TM.init_params(
            torch.Generator(), cfg, (1,), "meta"), rules, mesh)
        state = TS.train_state_from_params(
            _drawn_and_cut(draw, specs, mesh, dev), tc)
        if on_card:
            torch.cuda.empty_cache()     # the accumulators' f32 zeros
        bspecs = TS.batch_specs(batches[0], rules, mesh)
        batches = [CV.shard_tree(b, bspecs, mesh, dev) for b in batches]
        counted = _fsdp_counted(specs, mesh)
    else:
        state = TS.train_state_from_params(draw(), tc)
    clips = []
    real_clip = TS.clip_by_global_norm

    bad = []

    def spy(tree, max_norm, norm=None):
        sq = sum(torch.sum(torch.square(g.float()))
                 for g, c in zip(TR.leaves(tree), counted) if c)
        torch.distributed.all_reduce(sq)         # not the step's: uncounted
        clips.append((float(norm), float(torch.sqrt(sq))))
        if bad_counted is not None and not bad:
            wrong = sum(torch.sum(torch.square(g.float())) for g, c in zip(
                TR.leaves(tree), bad_counted(cfg, 1, rules, mesh)) if c)
            torch.distributed.all_reduce(wrong)
            bad.append((float(torch.sqrt(wrong)), clips[-1][1]))
        return real_clip(tree, max_norm, norm)

    skipped = []
    real_sum = TS._sum_over_rows

    def sum_spy(grads, summed, rows):
        if not skipped:
            sq = sum(torch.sum(torch.square(g.float()))
                     for g, c in zip(grads, counted) if c)
            torch.distributed.all_reduce(sq)     # not the step's: uncounted
            skipped.append(float(torch.sqrt(sq)))
            skipped.append(_replicas_equal(grads, TR.leaves(specs), mesh))
        return real_sum(grads, summed, rows)

    if mesh is not None:
        TS.clip_by_global_norm = spy
        if skip_sum:
            TS._sum_over_rows = sum_spy
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)
    KU.reset_launches()
    comm.reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms, ms = [], [], []
    try:
        with SH.use_rules(rules, mesh), (
                comm.timed() if timed else contextlib.nullcontext()):
            step = TS.make_train_step(cfg, tc, 1)
            for b in batches:
                sync()
                t0 = time.perf_counter()
                state, met = step(state, b)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
    finally:
        TS.clip_by_global_norm = real_clip
        TS._sum_over_rows = real_sum
    mem = TR.leaves(memory_of(state))
    p_leaves = TR.leaves(state.params)
    if mesh is None:
        rms = [float(torch.sqrt(torch.mean(torch.square(t.float()))))
               for t in p_leaves]
    out = {"losses": losses, "grad_norms": gnorms, "clips": clips,
           "bad_clip": bad, "skipped_sum": skipped, "ms_per_step": ms,
           "launches": dict(ops.LAUNCHES),
           "groups": {g: {op: dict(c) for op, c in o.items()}
                      for g, o in comm.GROUP_COUNTS.items()},
           "staged": {op: c["staged"] for op, c in comm.COUNTS.items()},
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card
           else 0,
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in p_leaves + mem),
           "n_leaves": len(p_leaves), "names": leaf_names(state.params),
           "params": p_leaves}
    if mesh is None:
        out["rms"] = rms
    else:
        sp = TR.leaves(specs)
        out["replicated_bit_equal"] = _replicas_equal(
            p_leaves + mem, sp + [SH.P(None, *s) for s in sp], mesh)
        out["specs"] = sp
    return out


def fsdp_moe_forward(dev, mesh=None) -> dict:
    """Layer 0's ``moe_mlp`` of qwen3-moe-30b-a3b (the seed-0 draw) on
    the agent's FSDP["batch"] x FSDP["seq"] rows of seeded activations, in
    one process or on this rank's row under ``build_rules`` (its fsdp
    leaves gathered by ``layer_gather``): (the output of those rows, the
    aux loss)."""
    import torch
    from repro_torch import tree as TR
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TM
    from repro_torch.training import train_step as TS

    cfg = _fsdp_cfg(MOE_ARCH, FSDP_MOE["n_layers"])

    def draw():
        return TM.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, (), dev)

    x = torch.randn((FSDP["batch"], FSDP["seq"], cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(L.dtype_of(cfg.param_dtype))
    rules = None
    if mesh is not None:
        rules = TS.build_rules(cfg, False)
        specs = TS.param_specs(TM.init_params(torch.Generator(), cfg, (),
                                              "meta"), rules, mesh, False)
        full = _drawn_and_cut(draw, specs, mesh, dev)
        x = x[SH.mesh_coords(mesh)["data"]][None]
    else:
        full = draw()
    layer = TR.tree_map(lambda t: t[0], full["blocks"])
    with torch.no_grad(), SH.use_rules(rules, mesh):
        gather = TM.layer_gather(cfg, "blocks")
        if gather is not None:
            layer = gather(layer)
        out, aux = MOE.moe_mlp(layer["moe"], x, cfg)
    return {"out": out.float().cpu(), "aux": float(aux)}


def fsdp_serve(dev, mesh=None) -> dict:
    """qwen3-32b's serving units of FSDP_SERVE in f32 from the seed-0 draw,
    in one process or on this rank's shards and row under
    ``serve_rules(..., weights_fsdp=True)``: the prefill's last logits,
    then greedy decode's logits and tokens, gathered whole; ms."""
    import numpy as np
    import torch
    from repro_torch import convert as CV
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TM
    from repro_torch.serving import engine as E
    from repro_torch.training import train_step as TS

    cfg = _fsdp_cfg(FSDP_ARCH, FSDP_SERVE["n_layers"], "float32")

    def draw():
        return TM.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, (), dev)

    B, S = FSDP_SERVE["prefill"]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)), device=dev)}
    V = cfg.vocab
    rules = None
    if mesh is not None:
        rules = TS.serve_rules(cfg, False, B, mesh, weights_fsdp=True)
        specs = TS.param_specs(TM.init_params(torch.Generator(), cfg, (),
                                              "meta"), rules, mesh, False)
        params = _drawn_and_cut(draw, specs, mesh, dev)
        batch = CV.shard_tree(batch, TS.batch_specs_serve(batch, rules,
                                                          mesh), mesh, dev)
    else:
        params = draw()

    def whole(t, spec, shape):
        return t if mesh is None else SH.gather(t.contiguous(), spec, mesh,
                                                shape)

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = {}
    with torch.no_grad(), SH.use_rules(rules, mesh):
        sync()
        t0 = time.perf_counter()
        lg = E.make_prefill(cfg)(params, batch)
        sync()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill"] = whole(lg, SH.P("data", "model"), (B, V)).float(
        ).cpu()
        cache = D.init_cache(cfg, B, FSDP_SERVE["max_len"], device=dev)
        if mesh is not None:
            cache = CV.shard_tree(cache, TS.cache_specs(cache, rules, mesh),
                                  mesh, dev)
        tok, logits, toks, ms = batch["tokens"][:, :1], [], [], []
        calls = {op: 0 for op in comm.OPS}            # the decode steps'
        for t in range(FSDP_SERVE["decode_steps"]):
            sync()
            before = {k: comm.COUNTS[k]["calls"] for k in calls}
            t0 = time.perf_counter()
            lg, cache = D.decode_step(params, cache, tok, t, cfg)
            tok = L.vocab_argmax(lg[:, -1], cfg.vocab)[:, None]
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            for k in calls:
                calls[k] += comm.COUNTS[k]["calls"] - before[k]
            logits.append(whole(lg[:, -1], SH.P("data", "model"),
                                (B, V)).float().cpu())
            toks.append(whole(tok[:, 0], SH.P("data"), (B,)).cpu())
    out["logits"], out["tokens"] = torch.stack(logits), torch.stack(toks)
    out["decode_ms"] = ms
    out["decode_calls_per_step"] = {k: v / len(ms) for k, v in calls.items()
                                    if v}
    return out


def _fsdp_vs(mine: dict, ref: dict, mesh) -> dict:
    """A train run on this rank against the one-process run: losses, the
    clip norm against the spec tree's, replicas bit-equal (``held``,
    parameters aside), and each local shard against the same slice of the
    one-process parameters in bf16 ulps of the larger of the element and
    its leaf's RMS (``param_ulps``, which ``fsdp_phase`` holds)."""
    import torch
    from repro_torch.distributed import sharding as SH

    sizes, coords = SH.mesh_axis_sizes(mesh), SH.mesh_coords(mesh)
    ulps, share = {}, 0.0
    for name, got, spec, want, rms in zip(mine["names"], mine["params"],
                                          mine["specs"], ref["params"],
                                          ref["rms"]):
        w = want[SH.local_slice(want.shape, spec, sizes, coords)].to(
            got.device).float()
        d = (got.float() - w).abs()
        ulps[name] = float((d / (torch.clamp(w.abs(), min=rms)
                                 * 2.0 ** -7)).max())
        share = max(share, float((d > 0).float().mean()))
    ok_l, err_l = close_np(mine["losses"], ref["losses"], DIST_LOSS_TOL)
    ok_c, err_c = close_np([c[0] for c in mine["clips"]],
                           [c[1] for c in mine["clips"]], TP_NORM_TOL)
    return {"held": ok_l and ok_c and mine["replicated_bit_equal"],
            "losses": mine["losses"], "ref_losses": ref["losses"],
            "max_abs_loss_diff": err_l, "clip_norms": mine["clips"],
            "max_abs_clip_norm_diff": err_c, "param_ulps": ulps,
            "param_share_differing": share,
            "replicated_bit_equal": mine["replicated_bit_equal"],
            "launches": mine["launches"], "n_leaves": mine["n_leaves"],
            "ms_per_step": mine["ms_per_step"],
            "ref_ms_per_step": ref["ms_per_step"],
            "groups": mine["groups"], "staged": mine["staged"],
            "peak_bytes": mine["peak_bytes"],
            "ref_peak_bytes": ref["peak_bytes"],
            "state_bytes": mine["state_bytes"],
            "state_share": mine["state_bytes"] / ref["state_bytes"]}


def _planted_fsdp(name):
    """(module, attribute, faulty replacement) of a planted fault."""
    from repro_torch import tree as TR
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TM
    from repro_torch.training import train_step as TS

    if name == "replicated_counted_on_every_data_rank":
        import torch

        def counted(cfg, n_agents, rules, mesh):
            # the model axis alone: a leaf on model rank 0 counts on both
            # data ranks
            shapes = TM.init_params(torch.Generator(), cfg, (n_agents,),
                                    "meta")
            specs = TS.param_specs(shapes, rules, mesh)
            m = SH.mesh_coords(mesh)["model"]
            return [m == 0 or any("model" in SH.axes_of(p) for p in s)
                    for s in TR.leaves(specs)]
        return TS, "model_counted", counted
    if name == "microbatch_from_local_rows":
        # each microbatch a slice of this rank's own rows
        return TS, "microbatch_rows", lambda batch, M, rows: {
            k: v.reshape((v.shape[0], M, v.shape[1] // M) + v.shape[2:])
            for k, v in batch.items()}
    return MOE, "_over_batch", lambda t: (t, 1)


def _fsdp_by_group(groups: dict, steps: int) -> dict:
    """Calls and MB a step of each collective, by group label."""
    return {g: {op: {"calls": c["calls"] / steps,
                     "MB": c["bytes"] / steps / 1e6,
                     "ms": c["ms"] / steps}
                for op, c in o.items()}
            for g, o in groups.items()}


def _fsdp_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One of the four ranks of the fsdp phase: the train runs of
    FSDP_RUNS (qwen3-32b's timed), the planted faults of FSDP_READ_FROM
    read from their first steps, the others run (one on a qwen3-moe train
    step, one on its layer 0's forward), that forward, the serving units;
    each against the one-process runs in ``tmp``; results to
    ``tmp/fsdp<r>.json``."""
    import torch
    from repro_torch.device import set_full_precision
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as ML

    # four ranks' states and their transient f32 copies share the card:
    # segments that grow keep the allocator's cache from fragmenting
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    set_full_precision()
    t_start = time.perf_counter()
    mesh = ML.make_host_mesh(FSDP["mesh"][1])
    while not os.path.exists(os.path.join(tmp, "fsdp_ref.ready")):
        time.sleep(0.2)
    ref = torch.load(os.path.join(tmp, "fsdp_ref.pt"), mmap=True)
    coords = SH.mesh_coords(mesh)
    res = {"rank": rank, "coords": coords}
    torch.distributed.barrier()
    res["planted"] = {}
    counting, skipping = FSDP_PLANTED[:2]
    for key, (arch, n, exact, steps, mb) in FSDP_RUNS.items():
        run = fsdp_train(dev, arch, n, _fsdp_tc(exact, mb), steps, mesh,
                         timed=key == "dense", bad_counted=_planted_fsdp(
                             counting)[2] if key == FSDP_READ_FROM[
                                 counting] else None,
                         skip_sum=key == FSDP_READ_FROM[skipping])
        res[key] = _fsdp_vs(run, ref[key], mesh)
        if run["bad_clip"]:
            ok, err = close_np(*map(list, zip(*run["bad_clip"])),
                               TP_NORM_TOL)
            res["planted"][counting] = {
                "passes_the_check": ok, "max_abs_clip_norm_diff": err,
                "clip_norms": run["bad_clip"]}
        if run["skipped_sum"]:
            norm, equal = run["skipped_sum"]
            ok, err = close_np([norm], [run["clips"][0][1]], TP_NORM_TOL)
            res["planted"][skipping] = {
                "passes_the_check": ok and equal,
                "max_abs_clip_norm_diff": err,
                "replicated_bit_equal": equal}
        del run
    for name in FSDP_PLANTED:
        if name in FSDP_READ_FROM:
            continue
        mod, attr, bad = _planted_fsdp(name)
        real = getattr(mod, attr)
        setattr(mod, attr, bad)
        try:
            if name == "load_balance_over_local_means":
                aux = fsdp_moe_forward(dev, mesh)["aux"]
                ok, err = close_np([aux], [ref["moe_aux"]["aux"]],
                                   FSDP_AUX_TOL)
                res["planted"][name] = {"passes_the_check": ok,
                                        "max_abs_aux_diff": err}
                continue
            key = FSDP_PLANTED_IN[name]
            arch, n, exact, _, mb = FSDP_RUNS[key]
            run = fsdp_train(dev, arch, n, _fsdp_tc(exact, mb),
                             FSDP["planted_steps"], mesh)
        finally:
            setattr(mod, attr, real)
        k = FSDP["planted_steps"]
        ok_l, err_l = close_np(run["losses"], ref[key]["losses"][:k],
                               DIST_LOSS_TOL)
        ok_c, err_c = close_np([c[0] for c in run["clips"]],
                               [c[1] for c in run["clips"]], TP_NORM_TOL)
        res["planted"][name] = {
            "passes_the_check": ok_l and ok_c and run[
                "replicated_bit_equal"],
            "max_abs_loss_diff": err_l, "max_abs_clip_norm_diff": err_c,
            "replicated_bit_equal": run["replicated_bit_equal"]}
        del run
    fwd = fsdp_moe_forward(dev, mesh)
    want = ref["moe_aux"]
    d_rank = coords["data"]
    ok_a, err_a = close_np([fwd["aux"]], [want["aux"]], FSDP_AUX_TOL)
    res["moe_forward"] = {
        "held": ok_a, "aux": fwd["aux"], "ref_aux": want["aux"],
        "max_abs_aux_diff": err_a,
        "out_max_abs_err": float((fwd["out"][0] - want["out"][d_rank])
                                 .abs().max()),
        "ref_out_max_abs": float(want["out"].abs().max())}
    serve = fsdp_serve(dev, mesh)
    want = ref["serve"]
    ok_p, err_p = close_np(serve["prefill"], want["prefill"], TP_SERVE_TOL)
    ok_d, err_d = close_np(serve["logits"], want["logits"], TP_SERVE_TOL)
    same = torch.equal(serve["tokens"], want["tokens"])
    res["serve"] = {"held": ok_p and ok_d and same,
                    "prefill_max_abs_err": err_p,
                    "decode_max_abs_err": err_d, "tokens_equal": same,
                    "prefill_ms": serve["prefill_ms"],
                    "ref_prefill_ms": want["prefill_ms"],
                    "median_decode_ms": statistics.median(
                        serve["decode_ms"][1:]),
                    "ref_median_decode_ms": statistics.median(
                        want["decode_ms"][1:]),
                    "decode_calls_per_step": serve["decode_calls_per_step"]}
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(tmp, f"fsdp{rank}.json"), "w") as f:
        json.dump(res, f)


def fsdp_phase(dev) -> dict:
    """The fsdp and batch rules on the card (FSDP): the one-process runs
    first, then four gloo ranks, each held against them (a leaf's
    parameters past DIST_ULPS against TP_SPREAD_FACTOR times the
    one-process run's own spread through cuBLASLt, run after the ranks
    where one is); the planted faults must fail.  Its temporary files
    (the one-process runs' whole parameters) are removed at its end."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        return _fsdp_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fsdp_phase(dev, tmp: str) -> dict:
    import torch
    from repro_torch.distributed import comm

    t_phase = time.perf_counter()
    respawns = comm.RESPAWNS
    torch.cuda.empty_cache()
    # the ranks start (and join their group) while this process makes the
    # one-process runs; they wait for fsdp_ref.ready
    n = FSDP["mesh"][0] * FSDP["mesh"][1]
    ctx = comm.spawn(_fsdp_rank, n, tmp, str(dev), backend="gloo",
                     store_dir=tmp, join=False)
    try:
        ref, summary = {}, {}
        for key, (arch, n_layers, exact, steps, mb) in FSDP_RUNS.items():
            run = fsdp_train(dev, arch, n_layers, _fsdp_tc(exact, mb), steps)
            run["params"] = [t.cpu() for t in run["params"]]
            torch.cuda.empty_cache()
            check(all(v > DIST["grad_clip"] for v in run["grad_norms"]),
                  f"fsdp one-process {key}: the clip does not bind: "
                  f"{run['grad_norms']}")
            ref[key] = run
            summary[key] = {k: run[k] for k in ("losses", "grad_norms",
                                                "ms_per_step", "launches",
                                                "peak_bytes", "state_bytes")}
        ref["moe_aux"] = fsdp_moe_forward(dev)
        ref["serve"] = fsdp_serve(dev)
        summary["serve"] = {"prefill_ms": ref["serve"]["prefill_ms"],
                            "median_decode_ms": statistics.median(
                                ref["serve"]["decode_ms"][1:])}
        path = os.path.join(tmp, "fsdp_ref.pt")
        torch.save(ref, path)
        del ref
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t_phase
        t_ranks = time.perf_counter()
        open(os.path.join(tmp, "fsdp_ref.ready"), "w").close()
        try:
            while not ctx.join():
                pass
            respawn = None
        except Exception:
            # a rank that lost a connection in gloo's rendezvous: the world
            # runs again (comm.spawn's rule: twice at most, never once a
            # rank has started); anything else is raised
            respawn = comm.rendezvous_failed(tmp)
            if respawn is None:
                raise
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    if respawn is not None:
        comm.respawned(_fsdp_rank.__name__, n, "gloo", respawn, 1,
                       comm.INIT_RETRIES)
        comm.spawn(_fsdp_rank, n, tmp, str(dev), backend="gloo",
                   store_dir=tmp, retries=comm.INIT_RETRIES - 1)
    ranks_s = time.perf_counter() - t_ranks
    ranks = []
    for r in range(n):
        with open(os.path.join(tmp, f"fsdp{r}.json")) as f:
            ranks.append(json.load(f))
    spread = {}
    for key, (arch, n_layers, exact, steps, mb) in FSDP_RUNS.items():
        if any(u > DIST_ULPS for r in ranks
               for u in r[key]["param_ulps"].values()):
            # the one-process run's own spread, where a rank is past the
            # limit
            with cublaslt():
                alt = fsdp_train(dev, arch, n_layers, _fsdp_tc(exact, mb),
                                 steps)
            spread[key] = param_ulps(alt["names"], alt["params"], torch.load(
                path, mmap=True)[key]["params"])[0]
            del alt
            torch.cuda.empty_cache()
    for r in ranks:
        tag = f"fsdp rank {r['rank']} {r['coords']}"
        for key, (_, _, exact, steps, _) in FSDP_RUNS.items():
            x = r[key]
            limit = {k: max(DIST_ULPS, TP_SPREAD_FACTOR
                            * spread.get(key, {}).get(k, 0.0))
                     for k in x["param_ulps"]}
            worst = sorted(x["param_ulps"].items(), key=lambda kv: kv[1],
                           reverse=True)[:3]
            x["param_worst_leaves"] = worst
            x["param_ulps_limits_over_2"] = {k: v for k, v in limit.items()
                                             if v > DIST_ULPS}
            check(x["held"] and all(u <= limit[k] for k, u in
                                    x["param_ulps"].items()),
                  f"{tag} {key}: loss {x['max_abs_loss_diff']}, clip norm "
                  f"{x['max_abs_clip_norm_diff']}, parameters {worst} bf16 "
                  f"ulps, replicas equal {x['replicated_bit_equal']}")
            kernel = "frodo_exact_update" if exact else "frodo_expsum_update"
            want = {"frodo_exact_update": 0, "frodo_expsum_update": 0,
                    kernel: x["n_leaves"] * steps}
            check(x["launches"] == want,
                  f"{tag} {key}: launches {x['launches']}, want {want}")
            check(x["state_share"] <= FSDP_STATE_SHARE,
                  f"{tag} {key}: state share {x['state_share']}")
        check(r["moe_forward"]["held"],
              f"{tag}: MoE aux {r['moe_forward']['aux']} against "
              f"{r['moe_forward']['ref_aux']}")
        s = r["serve"]
        check(s["held"], f"{tag} serving: prefill {s['prefill_max_abs_err']}"
              f", decode {s['decode_max_abs_err']}, tokens equal "
              f"{s['tokens_equal']}")
    for name in FSDP_PLANTED:
        check(not all(r["planted"][name]["passes_the_check"] for r in ranks),
              f"planted {name} passed the check on every rank")
    peaks = {k: sum(r[k]["peak_bytes"] for r in ranks) for k in FSDP_RUNS}
    check(all(v <= FSDP_PEAK_SUM for v in peaks.values()),
          f"fsdp: the ranks' peaks summed {peaks}")
    for k in FSDP_RUNS:
        check(summary[k]["peak_bytes"] <= LLM_PEAK_LIMIT,
              f"fsdp one-process {k}: peak {summary[k]['peak_bytes']}")
    per_rank = []
    for r in ranks:
        row = {"rank": r["rank"], "coords": r["coords"],
               "seconds": r["seconds"], "planted": r["planted"],
               "moe_forward": r["moe_forward"], "serve": r["serve"]}
        for k, (_, _, _, steps, _) in FSDP_RUNS.items():
            x = dict(r[k])
            x.pop("param_ulps")
            x["by_group_per_step"] = _fsdp_by_group(x.pop("groups"), steps)
            x["median_ms_per_step"] = statistics.median(
                x["ms_per_step"][1:] or x["ms_per_step"])
            row[k] = x
        per_rank.append(row)
    emit("fsdp", nvidia_smi=nvidia_smi(), arch=FSDP_ARCH, moe_arch=MOE_ARCH,
         respawns=comm.RESPAWNS - respawns,
         mesh=FSDP["mesh"], settings=FSDP, moe=FSDP_MOE, serve=FSDP_SERVE,
         reduced=FSDP_REDUCED, grad_clip=DIST["grad_clip"],
         tol={"loss": DIST_LOSS_TOL, "clip_norm": TP_NORM_TOL,
              "param_bf16_ulps_of_leaf_rms": DIST_ULPS,
              "one_process_spread_factor": TP_SPREAD_FACTOR,
              "serve_f32": TP_SERVE_TOL, "moe_aux": FSDP_AUX_TOL,
              "state_share": FSDP_STATE_SHARE, "peak_sum": FSDP_PEAK_SUM},
         one_process=summary, one_process_seconds=one_s,
         ranks_seconds=ranks_s, peak_bytes_summed=peaks,
         one_process_spread_worst_leaves={
             k: sorted(v.items(), key=lambda kv: kv[1], reverse=True)[:3]
             for k, v in spread.items()}, per_rank=per_rank,
         seconds=time.perf_counter() - t_phase)
    launches = {}
    for k in FSDP_RUNS:
        tot = {"frodo_exact_update": 0, "frodo_expsum_update": 0}
        for ln in [r[k]["launches"] for r in ranks]:
            for name in tot:
                tot[name] += ln[name]
        launches[f"fsdp_{k}_4ranks"] = tot
        launches[f"fsdp_{k}_one_process"] = summary[k]["launches"]
    return {"launches": launches,
            "per_rank": {k: [r[k]["launches"] for r in ranks]
                         for k in FSDP_RUNS}}

EXPSUM_KS = (1, 4, 8, 16)      # the template's ends and the paths' K


def expsum_kernel_cases(dev) -> dict:
    """The exp-sum kernel against its plain version for every (g, acc)
    dtype pair, K in ``EXPSUM_KS``, at Exp 2's leaves and the tail shapes,
    each also one element into its buffers (pointers not 16-byte aligned: the
    scalar path): the new accumulators bit-equal, the delta within
    ``TOL``.  Emits ``kernels.expsum``; returns the largest delta error at
    Exp 2's leaves by dtype pair."""
    import numpy as np
    import torch
    from repro_torch.core import memory as fmem
    from repro_torch.kernels import frodo_update as KU
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    shapes = list(EXP2_LEAVES.values()) + TAIL_SHAPES
    worst = {}
    for K_ in EXPSUM_KS:
        rates_np, coeffs_np = fmem.fit_expsum(T, 0.15, K_)
        rates = torch.tensor(rates_np, dtype=torch.float32)
        coeffs = torch.tensor(coeffs_np, dtype=torch.float32)
        for gname, gdt in dtypes.items():
            for aname, adt in dtypes.items():
                key = f"g={gname},acc={aname}"
                for shape in shapes:
                    n = int(np.prod(shape))
                    for off in (0, 1):
                        gb = torch.randn(n + off, generator=gen,
                                         device=dev).to(gdt)
                        ab = torch.randn(K_ * n + off, generator=gen,
                                         device=dev).to(adt)
                        ab_p = ab.clone()
                        g = gb[off:].view(shape)
                        a_k = ab[off:].view((K_,) + shape)
                        a_p = ab_p[off:].view((K_,) + shape)
                        d_k = KU.expsum_update(g, a_k, rates, coeffs, ALPHA,
                                               BETA)
                        d_p, _ = ref.frodo_expsum_update_ref(
                            g, a_p, rates, coeffs, ALPHA, BETA)
                        torch.cuda.synchronize()
                        a, b = d_k.float(), d_p.float()
                        err = (a - b).abs()
                        tol = TOL[gname]
                        check(bool((err <= tol["atol"]
                                    + tol["rtol"] * b.abs()).all()),
                              f"expsum delta {key} K={K_} {shape} "
                              f"offset={off}: max abs err "
                              f"{float(err.max())}")
                        check(torch.equal(ab.view(bits[adt]),
                                          ab_p.view(bits[adt])),
                              f"expsum new acc {key} K={K_} {shape} "
                              f"offset={off} not bit-equal")
                        if shape in EXP2_LEAVES.values():
                            worst[key] = max(worst.get(key, 0.0),
                                             float(err.max()))
    emit("kernels.expsum", K=list(EXPSUM_KS),
         shapes=[list(s) for s in shapes], offsets=[0, 1],
         max_abs_err_delta=worst, tol={"delta": TOL, "new_acc": "bit-equal"},
         note="offset 1: each buffer one element in, so the pointers are "
              "not 16-byte aligned and the scalar path runs")
    return worst


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
    regs, spills = KU.ptxas_registers(info["log"])
    emit("build", seconds=round(info["seconds"], 3), cached=info["cached"],
         library=os.path.relpath(info["path"], ROOT), flags=KU.NVCC_FLAGS,
         units=KU.UNITS,
         registers=regs, spill_bytes=spills)
    start_cpu_references()

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

    expsum_err = expsum_kernel_cases(dev)

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
    llm = llm_train_phase(dev)
    llm["launches"]["llm_train_mamba2"] = llm_train_mamba2(dev)
    new = llm_train_moe_mla(dev)
    llm["launches"].update(new["launches"])
    vla = llm_train_vlm_audio(dev)
    llm["launches"].update(vla["launches"])
    hyb = llm_train_at_leaf(dev, LLM_HYBRID, "llm_train.kernels_k4")
    llm["launches"].update(hyb["launches"])
    nem = llm_train_at_leaf(dev, LLM_NEMOTRON, "llm_train.kernels_nemotron")
    llm["launches"].update(nem["launches"])
    # Exp 3, then the regress CLI and the ablations, in two processes of
    # their own beside the serving phase
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    e3 = start_phase(exp3_phase, EXP3_MODES[:-1])
    side = start_phase(host_phases, tmp)
    serve = serve_phase(dev)
    launches_exp3 = finish_phase(e3)
    launches_abl = finish_phase(side)
    dryrun_dir = os.path.join(tmp, "dryrun_torch")
    dry = dryrun_phase(dev, dryrun_dir, llm["main"])
    roofline_phase(dryrun_dir, smi)
    harness_phase(dev, dryrun_dir, tmp)
    dist = distributed_phase(dev)
    dist_launches = dist["launches"]
    tp = tensor_parallel_phase(dev, dist["ref_dir"])
    dist_launches.update(tp["launches"])
    serve["launches"].update(serve_late_phase(dev)["launches"])
    fsdp = fsdp_phase(dev)
    dist_launches.update(fsdp["launches"])
    per_path = {name: {"exp2": launches_exp2[name],
                       "exp1_point": launches_exp1[name],
                       "exp3": launches_exp3[name],
                       **{p: c[name] for p, c in llm["launches"].items()},
                       **{p: c[name] for p, c in serve["launches"].items()},
                       "dryrun_probe": dry["launches"][name],
                       "ablations": launches_abl[name],
                       **{p: c[name] for p, c in dist_launches.items()}}
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

    from repro_torch.experiments import kernel_bench
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
        row["copy_ceiling_ms"] = kernel_bench.copy_ceiling_us(
            expsum_bytes(n0), dev, 20) / 1e3
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
              "around one wrapper call (host launch path included); "
              "copy_ceiling_ms: one Tensor.copy_ reading and writing the "
              "exp-sum kernel's bytes, half each way; step_* "
              "over the six Exp 2 leaves; exp2_ms_per_step: host clock over "
              "40 steps ending in a device sync, median of 3 runs")

    # --------------------------------------------- profile (device time)
    def per_launch_us(fn, reps=20):
        return kernel_bench.device_us(fn, reps)

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
         note="per launch: CUDA events around 20 launches queued behind "
              "a spin kernel (kernel_bench.device_us); the Exp 2 step: "
              "torch.profiler (CUPTI) device time; busy share = device "
              "ms/step over the unprofiled host-clock ms/step of the timing "
              "phase")

    # ------------------------------------------------------- kernel bench
    bench = kernel_bench.rows(dev)       # raises if a kernel disagrees
    check(all(r["vs_plain"]["state"] == "bit-equal" for r in bench),
          "kernel_bench: a row without its check against the plain version")
    emit("kernel_bench", nvidia_smi=smi, rows=bench)

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
         **{k: ex[k] for k in keys}, "llm_bf16_at_embed": llm["exact"],
         "tensor_parallel_launches_per_rank": tp["per_rank_exact"],
         "fsdp_launches_per_rank": {
             k: [r["frodo_exact_update"] for r in v]
             for k, v in fsdp["per_rank"].items()},
         "bench": bench_rows(bench, "exact")},
        {"name": "frodo_expsum_update", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/frodo_update.py:93",
         "launches": sum(per_path["frodo_expsum_update"].values()),
         "launches_per_path": per_path["frodo_expsum_update"],
         "max_abs_err": expsum_err["g=float32,acc=float32"],
         "shape": [K] + list(EXP2_LEAVES["w0"]), "dtype": "float32",
         **{k: es["float32"][k] for k in keys},
         "copy_ceiling_ms": es["float32"]["copy_ceiling_ms"],
         "llm_bf16g_f32acc_at_mlp_up": llm["expsum"],
         "llm_moe_mla_largest_leaves": new["kernels"],
         "llm_vlm_audio_largest_leaves": vla["kernels"],
         "llm_hybrid_largest_leaf": hyb["kernels"],
         "llm_bf16g_k4_bf16acc_at_embed": hyb["expsum_at_leaf"],
         "llm_nemotron_largest_leaf": nem["kernels"],
         "llm_nemotron_bf16g_k1_bf16acc_at_embed": nem["expsum_at_leaf"],
         "tensor_parallel_launches_per_rank": tp["per_rank_expsum"],
         "fsdp_launches_per_rank": {
             k: [r["frodo_expsum_update"] for r in v]
             for k, v in fsdp["per_rank"].items()},
         "bench": bench_rows(bench, "expsum")},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
